"""Weight quantization for serving and the KV pool's storage dtype (port
of ``deepspeed_tpu/inference/quantize.py``).

Two modes beyond "none" (``inference.quantize``):

- ``bf16``: every float leaf stochastically rounded to bf16
  (``ops/stochastic_rounding.stochastic_round_bf16``: the fp32 bits plus
  16 bits of noise, truncated; inf and nan kept). Unbiased, half the
  bytes of fp32.
- ``int8``: per-output-channel symmetric int8 for every float leaf with
  ``ndim >= 2``: ``scale = max(amax / 127, 1e-12)`` over every axis but
  the last, ``q = clip(floor(w / scale + u), -127, 127)`` with
  ``u ~ U[0, 1)``, so ``E[q * scale] == w`` inside the clip.

As in the JAX package, the ``ndim >= 2`` rule also takes the stacked
per-layer vectors (``blocks/ln1_scale`` and the biases are ``[L, H]``):
each gets one scale per column shared by all L layers, and only
``ln_f_scale`` / ``ln_f_bias`` stay fp32.

Quantized leaves are ``{"q": int8, "scale": fp32}`` dicts in the param
tree, the JAX layout, so a tree quantized by either package feeds the
other (``models/convert.from_jax_params`` carries them across).
``quantize_params`` passes such leaves through unchanged. The noise
comes from a ``torch.Generator`` (the JAX package draws threefry bits
per leaf, which a torch generator cannot reproduce); ``dequantize`` is
deterministic and gives the JAX function's bits.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from ..ops.stochastic_rounding import stochastic_round_bf16

QUANT_KEY = "q"
SCALE_KEY = "scale"

Seed = Union[None, int, torch.Generator]


def is_quantized_leaf(x: Any) -> bool:
    return isinstance(x, dict) and QUANT_KEY in x and SCALE_KEY in x


def _map_leaves(fn, tree: Any) -> Any:
    """``fn`` over the tree's leaves in the JAX order (dict keys sorted),
    a ``{"q", "scale"}`` dict counting as one leaf; the result keeps the
    tree's own key order."""
    if isinstance(tree, dict) and not is_quantized_leaf(tree):
        done = {k: _map_leaves(fn, tree[k]) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    return fn(tree)


def _generators(seed: Seed):
    """``device -> generator``: the given generator, or one per device
    seeded with ``seed`` (0 for None) on first use."""
    if isinstance(seed, torch.Generator):
        return lambda device: seed
    gens: Dict[torch.device, torch.Generator] = {}

    def get(device):
        if device not in gens:
            gens[device] = torch.Generator(device=device).manual_seed(
                int(seed or 0))
        return gens[device]
    return get


def quantize_leaf_int8(w: torch.Tensor,
                       generator: Optional[torch.Generator] = None
                       ) -> Dict[str, torch.Tensor]:
    """Per-output-channel (last axis) symmetric int8 with unbiased
    stochastic rounding onto the integer grid."""
    w32 = w.float()
    amax = w32.abs().amax(dim=tuple(range(w32.dim() - 1)), keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    u = torch.rand(w32.shape, generator=generator, dtype=torch.float32,
                   device=w32.device)
    q = torch.clamp(torch.floor(w32 / scale + u), -127, 127)
    return {QUANT_KEY: q.to(torch.int8), SCALE_KEY: scale}


def quantize_params(params: Any, mode: str, seed: Seed = None,
                    device: Optional[torch.device] = None) -> Any:
    """Quantize a param tree per the ``inference.quantize`` mode: none,
    bf16 (every float leaf) or int8 (every float leaf with ndim >= 2).
    Each leaf's noise is the next draws of the generator of its device
    (``seed``: a generator, or an int that seeds one per device);
    ``{"q", "scale"}`` leaves pass through. With ``device``, each leaf
    moves there just before it is quantized, so a host tree never sits
    on the device whole."""
    if mode == "none":
        return params
    if mode not in ("bf16", "int8"):
        raise ValueError(f"unknown quantize mode {mode!r}")
    gen = _generators(seed)

    def leaf(t):
        if is_quantized_leaf(t):
            return t
        if device is not None:
            t = torch.as_tensor(t).to(device)
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            return t
        if mode == "bf16":
            return stochastic_round_bf16(t, gen(t.device))
        return quantize_leaf_int8(t, gen(t.device)) if t.dim() >= 2 else t
    return _map_leaves(leaf, params)


def dequantize(params: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Collapse ``{"q", "scale"}`` leaves to ``dtype`` tensors; plain
    leaves pass through. ``q * scale`` promotes q to fp32 exactly (int8
    values are fp32 values), so each leaf is the JAX
    ``(q.astype(f32) * scale).astype(dtype)``, bit for bit, in one
    product and one cast."""
    def deq(x):
        if is_quantized_leaf(x):
            return (x[QUANT_KEY] * x[SCALE_KEY]).to(dtype)
        return x
    return _map_leaves(deq, params)


def quantized_bytes(params: Any) -> int:
    """At-rest bytes of a (possibly quantized) param tree."""
    total = 0

    def add(t):
        nonlocal total
        if is_quantized_leaf(t):
            add(t[QUANT_KEY])
            add(t[SCALE_KEY])
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        return t
    _map_leaves(add, params)
    return total


def resolve_kv_dtype(mode: str, model_dtype: Any) -> torch.dtype:
    """The ``inference.kv_cache_dtype`` knob: ``"model"`` keeps blocks at
    the compute dtype, ``"bf16"`` stores them in bfloat16 (scores are
    fp32 either way)."""
    if mode == "model":
        return model_dtype
    if mode == "bf16":
        return torch.bfloat16
    raise ValueError(f"unknown kv_cache_dtype mode {mode!r}")


__all__ = ["quantize_params", "quantize_leaf_int8", "dequantize",
           "quantized_bytes", "is_quantized_leaf", "resolve_kv_dtype",
           "QUANT_KEY", "SCALE_KEY"]
