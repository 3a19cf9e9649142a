"""ZeRO stage 3: parameters partitioned over dp, gathered just in time
(port of ``deepspeed_tpu/runtime/zero/stage3.py``, its explicit gather).

Each rank holds only its rows of the fp32 masters (bf16 master-free) in
the fused optimizer's V-interleaved layout; a leaf's part is one range
of its padded flattened values (``ShardGroup.local_views``). For every
micro-step the engine rebuilds the parameter tree with ``gather_cast``:

- forward: cast the rank's part to the compute dtype, then
  ``all_gather`` (the wire moves compute-dtype bytes) and cut the
  padded leaf back to its shape;
- backward: widen the cotangent to fp32 BEFORE the ``reduce_scatter``
  (sum), so the owner receives its part of the fp32-reduced gradient —
  the same widen-then-scatter the stage-2 path runs on its packed
  buffer, which is what makes one stage-3 step bit-identical to the
  stage-2 step from the same state.

``regather_saved`` is the port's counterpart of the JAX engine's
``jax.checkpoint(gather_params)``: under it, autograd saves a gathered
weight (or any view of it) as its leaf id and its view geometry, and
unpacks it by a fresh gather in the backward pass, so stage 3 never
holds the gathered tree from forward to backward. Per step each
parameter crosses the wire three times: forward gather, backward
re-gather, gradient reduce-scatter.

The per-layer prefetched scan (``Zero3Scan``) is not ported yet.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ...parallel import comm

__all__ = ["gather_cast", "gather_tree", "regather_saved", "active_regather",
           "Zero3Scan"]


def _gather(x: torch.Tensor, shape: Tuple[int, ...],
            dtype: torch.dtype) -> torch.Tensor:
    """All-gather a rank's part ``x`` (``[V/dp, r]``) of a padded leaf
    in ``dtype``; the leaf-shaped result views the gathered buffer."""
    part = x.to(dtype).contiguous()
    full = comm.all_gather(part.view(-1))
    return full[:math.prod(shape)].view(shape)


class _GatherCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape, dtype):
        ctx.part_shape = tuple(x.shape)
        return _gather(x, shape, dtype)

    @staticmethod
    def backward(ctx, g):
        R, r = ctx.part_shape
        full = torch.zeros(comm.get_world_size() * R * r,
                           dtype=torch.float32, device=g.device)
        full[:g.numel()].copy_(g.reshape(-1))     # widen, then scatter
        return comm.reduce_scatter(full).view(R, r), None, None


def gather_cast(x: torch.Tensor, shape: Tuple[int, ...],
                dtype: torch.dtype) -> torch.Tensor:
    """The leaf of ``shape`` in ``dtype`` from every rank's
    ``[V/dp, r]`` part ``x``; its gradient with respect to ``x`` is the
    fp32 reduce-scatter of the leaf's gradient."""
    return _GatherCast.apply(x, tuple(shape), dtype)


def gather_tree(parts: List[torch.Tensor], shapes: List[Tuple[int, ...]],
                dtype: torch.dtype) -> List[torch.Tensor]:
    """``gather_cast`` of each part (the leaves of a group in order)."""
    return [gather_cast(x, shape, dtype) for x, shape in zip(parts, shapes)]


@contextlib.contextmanager
def regather_saved(gathered: Dict[int, Tuple[Callable[[], torch.Tensor],
                                             torch.Tensor]]):
    """Save gathered weights as a re-gather, not as tensors.

    ``gathered`` maps a leaf id to ``(regather, leaf)``: ``leaf`` the
    tensor ``gather_cast`` returned, ``regather()`` a fresh gather of
    the same values (no autograd). A tensor autograd saves that shares
    a gathered leaf's storage is packed as ``(leaf id, size, stride,
    offset)`` and unpacked as the same view of ``regather()``; other
    tensors are saved as they are."""
    by_storage = {leaf.untyped_storage().data_ptr(): (lid, fn, leaf)
                  for lid, (fn, leaf) in gathered.items()}

    def pack(t: torch.Tensor):
        try:
            key = t.untyped_storage().data_ptr()
        except RuntimeError:
            return t
        hit = by_storage.get(key)
        if hit is None or t.dtype != hit[2].dtype:
            return t
        lid, fn, _ = hit
        return ("zero3", lid, fn, tuple(t.size()), tuple(t.stride()),
                t.storage_offset())

    def unpack(p):
        if not (isinstance(p, tuple) and p and p[0] == "zero3"):
            return p
        _, _, fn, size, stride, offset = p
        leaf = fn()
        base = leaf.view(-1)
        # The leaf views its gathered buffer at storage offset 0.
        return base.as_strided(size, stride, offset)

    _ACTIVE.hooks.append((pack, unpack))
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
    finally:
        _ACTIVE.hooks.pop()
        # Autograd keeps a saved tensor's pack hook with it until the
        # backward pass: the closure must not hold the gathered leaves.
        by_storage.clear()


class _Active(threading.local):
    def __init__(self):
        self.hooks: List[Tuple[Callable, Callable]] = []


_ACTIVE = _Active()


def active_regather() -> Optional[Tuple[Callable, Callable]]:
    """The ``(pack, unpack)`` of the innermost ``regather_saved`` open on
    this thread, or None. Saved-tensor hooks do not chain (the innermost
    pack wins), so a recompute region opened inside one
    (``models/remat.py``) hands its weights to these: a gathered weight
    is saved as a re-gather there too."""
    return _ACTIVE.hooks[-1] if _ACTIVE.hooks else None


class Zero3Scan:
    """The per-layer prefetched stage-3 scan of the JAX package. Not
    ported yet: the port gathers every leaf per micro-step."""

    def __init__(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(
            "Zero3Scan (the per-layer prefetched stage-3 scan) is not "
            "ported yet (ROADMAP queue 1: the per-layer Zero3Scan with "
            "prefetch)")
