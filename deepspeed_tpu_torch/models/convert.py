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
name, so the conversion moves each leaf's slice of the buffer.

The JAX side is given and returned as numpy arrays (``jax.device_get``
of the tree), which keeps this module free of JAX. Round trips are
exact: values, dtypes and shapes, the JAX buffers' zero padding
included.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.fused_update import FusedAdamState, tree_flatten

# The JAX layout's constants (deepspeed_tpu/ops/fused_update.py: _V and
# _ROW_QUANTUM = 8 * _W) for a one-device engine.
JAX_VIRTUAL_SHARDS = 8
_JAX_ROW_QUANTUM = 8 * 1024


def from_jax_params(np_tree: Dict[str, Any],
                    device: Optional[Union[str, torch.device]] = "cpu"
                    ) -> Dict[str, Any]:
    """Nested dict of numpy arrays → the same tree of torch tensors."""
    if isinstance(np_tree, dict):
        return {k: from_jax_params(v, device) for k, v in np_tree.items()}
    return torch.from_numpy(np.array(np_tree, copy=True)).to(device)


def to_jax_params(state: Dict[str, Any]) -> Dict[str, Any]:
    """Tree of torch tensors → the same tree of numpy arrays (host)."""
    if isinstance(state, dict):
        return {k: to_jax_params(v) for k, v in state.items()}
    return state.detach().cpu().numpy().copy()


def _groups(np_params: Any) -> List[List[np.ndarray]]:
    """The params' float leaves grouped by dtype, groups sorted by dtype
    name, leaves in tree order — both packages' group order."""
    leaves, _ = tree_flatten(np_params)
    groups: Dict[str, List[np.ndarray]] = {}
    for leaf in leaves:
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.floating) or a.dtype.name == "bfloat16":
            groups.setdefault(a.dtype.name, []).append(a)
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


def from_jax_fused_adam_state(count: Any, m: Sequence[np.ndarray],
                              v: Sequence[np.ndarray], np_params: Any,
                              shards: int = JAX_VIRTUAL_SHARDS
                              ) -> FusedAdamState:
    """A JAX ``FusedAdamState`` (``count``, ``m``/``v`` group buffers as
    numpy, of a one-device engine) → the port's ``FusedAdamState`` with
    numpy buffers in the port's layout, for ``np_params``'s tree."""
    sizes = [[a.size for a in grp] for grp in _groups(np_params)]
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
    sizes = [[a.size for a in grp] for grp in _groups(np_params)]

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    return (np.int32(host(state.count)),
            tuple(_to_jax_buffer(host(b), s, shards)
                  for b, s in zip(state.m, sizes)),
            tuple(_to_jax_buffer(host(b), s, shards)
                  for b, s in zip(state.v, sizes)))


__all__ = ["from_jax_params", "to_jax_params", "from_jax_fused_adam_state",
           "to_jax_fused_adam_state"]
