"""Carry GPT-2 training state between the JAX package and the port.

Parameters. The JAX tree (``deepspeed_tpu.models.gpt2.gpt2_init``) and
the port's tree have the same keys and layouts (``wte``, ``wpe``,
stacked ``blocks.*`` with ``[in, out]`` kernels, ``ln_f_*``), so
conversion is a leaf-by-leaf copy.

Fused Adam state. The JAX ``FusedAdamState`` keeps one flat fp32 moment
buffer per dtype group in its V-interleaved layout
(``deepspeed_tpu/ops/fused_update.py``: each leaf padded to a multiple
of V and reshaped ``[V, r]``, the leaves concatenated along axis 1, the
row length padded to a multiple of 8 * 1024). The port keeps each group
as the plain concatenation of its flattened leaves. Both packages order
the leaves the same way (dict keys sorted) and group them by dtype
name, so the conversion moves each leaf's slice of the buffer. Across dp
ranks at ZeRO stage >= 1 the port itself holds the V-layout, a rank its
rows (``jax_local_rows``): a JAX shard file's moment buffers are those
rows as they are.

Tensor parallelism. JAX splits the fused QKV projection's last axis
(``qkv_kernel [L, H, 3H]``, ``qkv_bias [L, 3H]``, q|k|v) into mp
contiguous ranges; the port's rank holds its heads of each third side
by side. ``qkv_to_mp_order`` carries the last axis into the mp-major
order ``[q_0 k_0 v_0 | q_1 k_1 v_1 | ...]`` (rank r's part is then its
r-th contiguous range) and ``qkv_from_mp_order`` back; at mp 1 both are
the identity.

The JAX side is given and returned as numpy arrays (``jax.device_get``
of the tree), which keeps this module free of JAX. Round trips are
exact: values, dtypes and shapes, the JAX buffers' zero padding
included.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.fused_update import FusedAdamState, dtype_name, tree_flatten

# The JAX layout's constants (deepspeed_tpu/ops/fused_update.py: _V and
# _ROW_QUANTUM = 8 * _W) for a one-device engine.
JAX_VIRTUAL_SHARDS = 8
_JAX_ROW_QUANTUM = 8 * 1024


def from_jax_params(np_tree: Dict[str, Any],
                    device: Optional[Union[str, torch.device]] = "cpu"
                    ) -> Dict[str, Any]:
    """Nested dict of numpy arrays → the same tree of torch tensors, each
    leaf's dtype kept: a quantized tree's ``{"q": int8, "scale": fp32}``
    leaves (``inference/quantize.py``) come across unchanged."""
    if isinstance(np_tree, dict):
        return {k: from_jax_params(v, device) for k, v in np_tree.items()}
    return torch.from_numpy(np.array(np_tree, copy=True)).to(device)


def to_jax_params(state: Dict[str, Any]) -> Dict[str, Any]:
    """Tree of torch tensors → the same tree of numpy arrays (host)."""
    if isinstance(state, dict):
        return {k: to_jax_params(v) for k, v in state.items()}
    return state.detach().cpu().numpy().copy()


def qkv_to_mp_order(x: torch.Tensor, mp: int) -> torch.Tensor:
    """A q|k|v last axis in the mp-major order (module docstring)."""
    *lead, three_h = x.shape
    h = three_h // 3
    return x.reshape(*lead, 3, mp, h // mp).transpose(-3, -2) \
        .reshape(*lead, three_h)


def qkv_from_mp_order(x: torch.Tensor, mp: int) -> torch.Tensor:
    """The inverse of ``qkv_to_mp_order``."""
    *lead, three_h = x.shape
    h = three_h // 3
    return x.reshape(*lead, mp, 3, h // mp).transpose(-3, -2) \
        .reshape(*lead, three_h)


def _group_sizes(params: Any) -> List[List[int]]:
    """The sizes of the params' float leaves grouped by dtype, groups
    sorted by dtype name, leaves in tree order — both packages' group
    order. Leaves are numpy arrays or torch tensors; a torch leaf never
    goes through numpy, which has no bfloat16 of its own."""
    leaves, _ = tree_flatten(params)
    groups: Dict[str, List[int]] = {}
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            name, n = dtype_name(leaf.dtype), leaf.numel()
        else:
            a = np.asarray(leaf)
            if not (np.issubdtype(a.dtype, np.floating) or
                    a.dtype.name == "bfloat16"):
                continue
            name, n = a.dtype.name, int(a.size)
        groups.setdefault(name, []).append(n)
    return [groups[k] for k in sorted(groups)]


def _jax_row_layout(sizes: Sequence[int], shards: int
                    ) -> Tuple[List[int], List[int], int]:
    rows = [-(-n // shards) for n in sizes]
    offs = [sum(rows[:i]) for i in range(len(rows))]
    L = sum(rows)
    Lpad = max(_JAX_ROW_QUANTUM, -(-L // _JAX_ROW_QUANTUM) * _JAX_ROW_QUANTUM)
    return rows, offs, Lpad


def _from_jax_buffer(buf: np.ndarray, sizes: Sequence[int],
                     shards: int) -> np.ndarray:
    rows, offs, Lpad = _jax_row_layout(sizes, shards)
    b2 = np.asarray(buf).reshape(shards, Lpad)
    return np.concatenate([b2[:, o:o + r].reshape(-1)[:n]
                           for n, r, o in zip(sizes, rows, offs)])


def _to_jax_buffer(flat: np.ndarray, sizes: Sequence[int],
                   shards: int) -> np.ndarray:
    rows, offs, Lpad = _jax_row_layout(sizes, shards)
    b2 = np.zeros((shards, Lpad), np.float32)
    at = 0
    for n, r, o in zip(sizes, rows, offs):
        leaf = np.zeros(shards * r, np.float32)
        leaf[:n] = flat[at:at + n]
        b2[:, o:o + r] = leaf.reshape(shards, r)
        at += n
    return b2.reshape(-1)


def jax_local_rows(buf: np.ndarray, sizes: Sequence[int], shards: int,
                   dp: int, rank: int) -> np.ndarray:
    """Rank ``rank``'s rows ``[rank*V/dp, (rank+1)*V/dp)`` of a JAX
    V-layout group buffer (``shards`` = V virtual shards): its ZeRO
    shard, a contiguous 1/dp of the flat buffer."""
    _, _, Lpad = _jax_row_layout(sizes, shards)
    b = np.asarray(buf).reshape(-1)
    if b.size != shards * Lpad or shards % dp:
        raise ValueError(f"a buffer of {b.size} elements is not the "
                         f"[{shards}, {Lpad}] V-layout of leaves {list(sizes)}"
                         f" split over dp {dp}")
    per = shards // dp
    return b[rank * per * Lpad:(rank + 1) * per * Lpad]


def relayout_jax_buffer(buf: np.ndarray, sizes: Sequence[int],
                        from_shards: int, to_shards: int) -> np.ndarray:
    """A JAX V-layout buffer of ``from_shards`` virtual shards in the
    layout of ``to_shards`` (a save of more than 8 dp ranks, where V
    widened to dp, loaded at V = 8)."""
    if from_shards == to_shards:
        return np.asarray(buf)
    return _to_jax_buffer(_from_jax_buffer(buf, sizes, from_shards),
                          sizes, to_shards)


def from_jax_fused_adam_state(count: Any, m: Sequence[np.ndarray],
                              v: Sequence[np.ndarray], np_params: Any,
                              shards: int = JAX_VIRTUAL_SHARDS
                              ) -> FusedAdamState:
    """A JAX ``FusedAdamState`` (``count``, ``m``/``v`` group buffers as
    numpy, of an engine with ``shards`` virtual shards: 8, or dp above
    8) → the port's ``FusedAdamState`` with numpy buffers in the port's
    layout, for ``np_params``'s tree (numpy arrays or torch tensors)."""
    sizes = _group_sizes(np_params)
    return FusedAdamState(
        count=np.int32(np.asarray(count)),
        m=tuple(_from_jax_buffer(b, s, shards) for b, s in zip(m, sizes)),
        v=tuple(_from_jax_buffer(b, s, shards) for b, s in zip(v, sizes)))


def to_jax_fused_adam_state(state: FusedAdamState, np_params: Any,
                            shards: int = JAX_VIRTUAL_SHARDS
                            ) -> Tuple[np.int32, Tuple[np.ndarray, ...],
                                       Tuple[np.ndarray, ...]]:
    """The port's ``FusedAdamState`` (tensors or numpy) → ``(count, m,
    v)`` numpy buffers in the JAX V-interleaved layout."""
    sizes = _group_sizes(np_params)

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    return (np.int32(host(state.count)),
            tuple(_to_jax_buffer(host(b), s, shards)
                  for b, s in zip(state.m, sizes)),
            tuple(_to_jax_buffer(host(b), s, shards)
                  for b, s in zip(state.v, sizes)))


__all__ = ["qkv_to_mp_order", "qkv_from_mp_order", "from_jax_params",
           "to_jax_params", "from_jax_fused_adam_state",
           "to_jax_fused_adam_state", "jax_local_rows",
           "relayout_jax_buffer"]
