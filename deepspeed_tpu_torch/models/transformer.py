"""Transformer building blocks (port of
``deepspeed_tpu/models/transformer.py``: the serving ops and the
training block, whose attention defaults to ``auto_attention`` — the
flash kernels on a CUDA device, ``dense_attention`` on the CPU — and
whose FFN is dense, or with ``TransformerConfig.moe`` the MoE FFN of
``moe/layer.py`` on every ``moe_layer_freq``-th block).

Params are plain dicts of tensors; per-layer tensors are STACKED on a
leading layer axis ``[L, ...]`` and matmul kernels are stored ``[in,
out]`` and applied as ``x @ W`` — the JAX layout, so the converter maps
trees one to one. Softmax and LayerNorm statistics run in fp32; matmuls
run in the compute dtype with ``torch.matmul``.

The elementwise ops of a block come in two sets (``ElementwiseOps``):
``KERNEL_OPS``, the differentiable kernel-backed ops (their plain
versions run for CPU tensors), which the model runs; and ``PLAIN_OPS``,
plain PyTorch differentiated by autograd — the reference that
``gpt2_apply`` and the card's yardstick step use. Each set carries the
grouped expert FFN of the MoE blocks too (``grouped_ffn`` and
``grouped_ffn_plain``). ``elementwise_ops``
resolves ``TransformerConfig.fused_kernels``: on a CUDA device the port
has only the kernels, so ``False`` raises there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ..ops.flash_attention import auto_attention
from ..ops.fused_elementwise import (bias_gelu_plain, fused_bias_gelu,
                                     fused_layer_norm,
                                     fused_residual_layer_norm, gelu_tanh,
                                     layer_norm_plain)
from ..ops.grouped_gemm import grouped_ffn, grouped_ffn_plain
from ..moe.layer import (EP_UNPORTED, MOE_PARAM_KEYS, aggregate_moe_stats,
                         moe_ffn, moe_layer_indices)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Shared transformer hyperparameters (the JAX config's subset; the
    scan and segment-embedding knobs are not ported: the layers run as
    the JAX ``scan_layers=False`` program)."""
    hidden_size: int = 768
    num_heads: int = 12
    num_layers: int = 12
    intermediate_size: int = 0          # 0 → 4*hidden
    max_seq_length: int = 1024
    vocab_size: int = 50257
    pre_layer_norm: bool = True
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    # "none" only: activation recomputation is not ported yet.
    remat_policy: str = "none"
    causal: bool = False
    dtype: Any = torch.bfloat16
    # The erf form of GELU (True) or the tanh form (False), in the dense
    # FFN's bias+GELU kernels and the MoE experts' grouped GEMM alike.
    gelu_exact: bool = False
    # The fused kernels knob: "auto"/True run the kernels; False has no
    # CUDA path in the port (the engines raise). On the CPU the kernels'
    # plain versions run whatever it says.
    fused_kernels: Any = "auto"
    # Mixture-of-Experts: a ``moe.MoEConfig`` swaps the dense FFN for the
    # MoE FFN on every ``moe_layer_freq``-th block (freq 1 = every block).
    moe: Any = None
    moe_layer_freq: int = 1

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads


def check_trainable(cfg: TransformerConfig) -> None:
    """Raise for the model knobs the port's training path does not run."""
    if cfg.remat_policy != "none":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r}: activation recomputation "
            "is not ported yet (ROADMAP slice 6: remat and progressive "
            "layer drop)")
    if not (cfg.pre_layer_norm and cfg.causal):
        raise NotImplementedError("the port implements the GPT-2 block "
                                  "(pre-LN, causal)")
    if cfg.moe is not None and cfg.moe.expert_parallel_size > 1:
        raise NotImplementedError(EP_UNPORTED)


# --------------------------------------------------------------------- #
# Plain reference ops
# --------------------------------------------------------------------- #
def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics, output in x's dtype."""
    return layer_norm_plain(x, None, scale, bias, eps)[1]


def dense(x: torch.Tensor, kernel: torch.Tensor,
          bias: Optional[torch.Tensor]) -> torch.Tensor:
    y = torch.matmul(x, kernel.to(x.dtype))
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


# tanh-approximation GELU in x's dtype (``jax.nn.gelu(approximate=True)``).
gelu = gelu_tanh


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout with a keep mask drawn from ``generator`` (which
    must live on x's device); the identity when deterministic, at rate 0
    or without a generator, as in the JAX package."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    causal: bool = False, attn_dropout: float = 0.0,
                    rng: Optional[torch.Generator] = None,
                    deterministic: bool = True) -> torch.Tensor:
    """Reference attention: QK^T → scale → mask → fp32 softmax →
    dropout → AV. q, k, v: [B, S, nH, D]; ``mask`` additive, broadcast
    to [B, 1, S, S]. The two products are plain ``torch.einsum``s in the
    compute dtype (the JAX package leaves them to XLA)."""
    dh = q.shape[-1]
    s = torch.einsum("bsnd,btnd->bnst", q, k).float() / math.sqrt(dh)
    if causal:
        S, T = s.shape[-2], s.shape[-1]
        cmask = torch.ones(S, T, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~cmask, -1e9)
    if mask is not None:
        s = s + mask.float()
    w = torch.softmax(s, dim=-1)
    w = dropout(w, attn_dropout, rng, deterministic)
    return torch.einsum("bnst,btnd->bsnd", w.to(v.dtype), v)


# --------------------------------------------------------------------- #
# The block's elementwise ops
# --------------------------------------------------------------------- #
class ElementwiseOps(NamedTuple):
    """``ln(x, scale, bias) -> y``; ``res_ln(x, delta, scale, bias, eps)
    -> (s, y)`` with ``s = x + delta``; ``gelu_up(h, kernel, bias, exact)
    -> gelu(h @ kernel + bias)`` (the erf form where ``exact``, else the
    tanh form). Each takes ``eps`` where it normalizes.
    ``expert_ffn(x, w1, b1, w2, b2, exact)``: the MoE blocks' grouped
    expert FFN where ``MoEConfig.grouped_gemm`` selects it."""
    ln: Callable
    res_ln: Callable
    gelu_up: Callable
    expert_ffn: Callable


KERNEL_OPS = ElementwiseOps(
    ln=fused_layer_norm, res_ln=fused_residual_layer_norm,
    gelu_up=lambda h, kernel, bias, exact=False: fused_bias_gelu(
        torch.matmul(h, kernel.to(h.dtype)), bias, exact),
    expert_ffn=grouped_ffn)

PLAIN_OPS = ElementwiseOps(
    ln=lambda x, scale, bias, eps: layer_norm_plain(x, None, scale, bias,
                                                    eps)[1],
    res_ln=layer_norm_plain,
    gelu_up=lambda h, kernel, bias, exact=False: bias_gelu_plain(
        torch.matmul(h, kernel.to(h.dtype)), bias, exact),
    expert_ffn=grouped_ffn_plain)


def elementwise_ops(cfg: TransformerConfig,
                    device: torch.device) -> ElementwiseOps:
    """The ops ``cfg.fused_kernels`` selects on ``device``."""
    if cfg.fused_kernels is False:
        if device.type == "cuda":
            raise NotImplementedError(
                "fused_kernels=False has no CUDA path in the port — the "
                "LayerNorm and GELU run as its kernels there (ROADMAP: not "
                "planned)")
        return PLAIN_OPS
    return KERNEL_OPS


def layer_norm_fn(cfg: TransformerConfig) -> Callable:
    """``(x, scale, bias) -> y`` through the LayerNorm kernel (its plain
    version for CPU tensors)."""
    return lambda x, scale, bias: fused_layer_norm(
        x, scale, bias, cfg.layer_norm_eps)


def gelu_dense_fn(cfg: TransformerConfig) -> Callable:
    """``(h, kernel, bias) -> gelu(h @ kernel + bias)``: the matmul stays
    with ``torch.matmul``, the bias+GELU epilogue is one kernel pass in
    the form ``cfg.gelu_exact`` selects."""
    return lambda h, kernel, bias: KERNEL_OPS.gelu_up(h, kernel, bias,
                                                      cfg.gelu_exact)


# --------------------------------------------------------------------- #
# Params and the block
# --------------------------------------------------------------------- #
def init_block_params(cfg: TransformerConfig, generator: torch.Generator,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """STACKED block params, fp32, the tree of the JAX
    ``init_block_params``: [L, ...] for the attention and LayerNorm
    tensors; with ``cfg.moe`` the FFN tensors split into a dense stack
    ([n_dense, ...]) and an expert stack ([n_moe, E, ...]), each
    covering only its own layers."""
    L, H, F = cfg.num_layers, cfg.hidden_size, cfg.ffn_size
    std = cfg.initializer_range
    proj_std = std / math.sqrt(2.0 * L)

    def norm(shape, s):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * s

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=torch.float32)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=torch.float32)

    n_moe = 0 if cfg.moe is None else \
        len(moe_layer_indices(L, cfg.moe_layer_freq))
    if cfg.moe is not None and n_moe == 0:
        raise ValueError(
            f"cfg.moe is set but moe_layer_freq={cfg.moe_layer_freq} "
            f"selects no MoE layer out of {L} — use freq <= num_layers "
            "or drop cfg.moe")
    n_dense = L - n_moe
    params = {
        "ln1_scale": ones((L, H)), "ln1_bias": zeros((L, H)),
        "qkv_kernel": norm((L, H, 3 * H), std),
        "qkv_bias": zeros((L, 3 * H)),
        "proj_kernel": norm((L, H, H), proj_std),
        "proj_bias": zeros((L, H)),
        "ln2_scale": ones((L, H)), "ln2_bias": zeros((L, H)),
    }
    if n_dense > 0:
        params.update({
            "fc_kernel": norm((n_dense, H, F), std),
            "fc_bias": zeros((n_dense, F)),
            "fc_out_kernel": norm((n_dense, F, H), proj_std),
            "fc_out_bias": zeros((n_dense, H)),
        })
    if n_moe > 0:
        E = cfg.moe.num_experts
        params.update({
            "router_kernel": norm((n_moe, H, E), std),
            "moe_fc_kernel": norm((n_moe, E, H, F), std),
            "moe_fc_bias": zeros((n_moe, E, F)),
            "moe_out_kernel": norm((n_moe, E, F, H), proj_std),
            "moe_out_bias": zeros((n_moe, E, H)),
        })
    return params


def layer_slice(stacked: Dict[str, torch.Tensor], i: int
                ) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s params (views of the stacked tensors)."""
    return {name: t[i] for name, t in stacked.items()}


def transformer_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
                      cfg: TransformerConfig,
                      rng: Optional[torch.Generator] = None,
                      deterministic: bool = True,
                      attention_fn: Optional[Callable] = None,
                      ops: Optional[ElementwiseOps] = None):
    """One pre-LN block (params WITHOUT the layer axis): x [B, S, H] →
    [B, S, H]. The attention residual is fused into ln2 (``res_ln``), as
    in the JAX block. ``rng`` drives the attention and hidden dropout
    (ignored when deterministic); ``attention_fn`` defaults to
    ``auto_attention``; ``ops`` defaults to the ones ``cfg.fused_kernels``
    selects. With ``cfg.moe`` the FFN is the MoE FFN wherever ``p``
    carries the expert tensors, and the block returns ``(x,
    moe_stats_or_None)``."""
    if not (cfg.pre_layer_norm and cfg.causal):
        raise NotImplementedError("the port implements the GPT-2 block "
                                  "(pre-LN, causal)")
    ops = ops or elementwise_ops(cfg, x.device)
    attention_fn = attention_fn or auto_attention
    eps = cfg.layer_norm_eps
    B, S, H = x.shape
    nH, dH = cfg.num_heads, cfg.head_dim

    h = ops.ln(x, p["ln1_scale"], p["ln1_bias"], eps)
    q, k, v = dense(h, p["qkv_kernel"], p["qkv_bias"]).split(H, dim=-1)
    attn = attention_fn(q.reshape(B, S, nH, dH), k.reshape(B, S, nH, dH),
                        v.reshape(B, S, nH, dH), mask=None,
                        causal=cfg.causal, attn_dropout=cfg.attn_dropout,
                        rng=rng, deterministic=deterministic)
    attn = dense(attn.reshape(B, S, H), p["proj_kernel"], p["proj_bias"])
    attn = dropout(attn, cfg.hidden_dropout, rng, deterministic)
    # Fused residual-add + the FFN's LN: x continues the residual stream
    # from s, h feeds the FFN.
    x, h = ops.res_ln(x, attn, p["ln2_scale"], p["ln2_bias"], eps)
    moe_stats = None
    if "moe_fc_kernel" in p:
        h, moe_stats = moe_ffn(p, h, cfg, expert_ffn=ops.expert_ffn)
    else:
        h = ops.gelu_up(h, p["fc_kernel"], p["fc_bias"], cfg.gelu_exact)
        h = dense(h, p["fc_out_kernel"], p["fc_out_bias"])
    h = dropout(h, cfg.hidden_dropout, rng, deterministic)
    if cfg.moe is not None:
        return x + h, moe_stats
    return x + h


def apply_blocks(stacked: Dict[str, torch.Tensor], x: torch.Tensor,
                 cfg: TransformerConfig,
                 rng: Optional[torch.Generator] = None,
                 deterministic: bool = True,
                 attention_fn: Optional[Callable] = None,
                 ops: Optional[ElementwiseOps] = None):
    """All L layers as a Python loop over the stacked leading axis (the
    JAX ``scan_layers=False`` program). Each stacked tensor is unbound
    once, so its gradient comes back as one stack, not as L scatters.
    With ``cfg.moe`` the dense and expert FFN stacks cover different
    layers, each indexed at its own position, and the return value is
    ``(x, moe_stats)``: the MoE layers' stats averaged over them."""
    L = stacked["ln1_scale"].shape[0]
    per_layer = {name: t.unbind(0) for name, t in stacked.items()}
    moe_layers = [] if cfg.moe is None else \
        moe_layer_indices(L, cfg.moe_layer_freq)
    if cfg.moe is not None and not moe_layers:
        raise ValueError(
            f"cfg.moe is set but moe_layer_freq={cfg.moe_layer_freq} "
            f"selects no MoE layer out of {L}")
    moe_pos = {li: j for j, li in enumerate(moe_layers)}
    dense_pos = {li: j for j, li in enumerate(
        i for i in range(L) if i not in moe_pos)}
    ffn_keys = MOE_PARAM_KEYS | {"fc_kernel", "fc_bias", "fc_out_kernel",
                                 "fc_out_bias"}
    stats = []
    for i in range(L):
        p_i = {}
        for name, t in per_layer.items():
            if name not in ffn_keys:
                p_i[name] = t[i]
            elif name in MOE_PARAM_KEYS:
                if i in moe_pos:
                    p_i[name] = t[moe_pos[i]]
            elif i in dense_pos:
                p_i[name] = t[dense_pos[i]]
        out = transformer_block(p_i, x, cfg, rng=rng,
                                deterministic=deterministic,
                                attention_fn=attention_fn, ops=ops)
        if cfg.moe is None:
            x = out
            continue
        x, st = out
        if st is not None:
            stats.append(st)
    return x if cfg.moe is None else (x, aggregate_moe_stats(stats))


__all__ = ["TransformerConfig", "check_trainable", "layer_norm", "dense",
           "gelu", "dropout", "dense_attention", "ElementwiseOps",
           "KERNEL_OPS", "PLAIN_OPS", "elementwise_ops", "layer_norm_fn",
           "gelu_dense_fn", "init_block_params", "layer_slice",
           "transformer_block", "apply_blocks"]
