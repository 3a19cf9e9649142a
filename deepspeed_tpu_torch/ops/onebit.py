"""1-bit Adam: error-feedback sign-compressed momentum exchange (port of
``deepspeed_tpu/ops/onebit.py``).

Full-precision Adam for ``freeze_step`` steps, then the compression
stage: the variance is frozen, each rank updates the momentum from its
LOCAL gradients, adds its worker error, sends ``scale * sign(...)`` with
one L1 scale per chunk (``chunks`` = dp), the ranks average what they
sent, and a second compression with a server-side error buffer gives the
momentum every rank applies. The update skips bias correction in the
compression stage (``m / (sqrt(v) + eps)``); the warmup is bias-corrected
Adam on the dp-mean gradients. Both phases decay decoupled
(``p - lr * (u + wd * p)`` in fp32) and clip by a global norm: the true
norm of the dp-mean gradients in warmup, the RMS of the ranks' local
norms after it. A non-finite norm skips the step: params, moments, both
error buffers and the step count are all kept.

The JAX package emulates the compressed wire with an fp32 ``psum``, and
so does the port (``comm.all_reduce``): ``comm_bytes`` is the accounting
of the packed wire (a sign bit an element and an fp32 scale a chunk).

Two forms of the same step:

- ``onebit_adam_update`` — the JAX function, leaf by leaf, on trees of
  tensors (``onebit_reference_step`` runs it with an ``OnebitAdam``'s
  hyperparameters: the plain reference the flat step is held against);
- ``OnebitAdam`` — the engine's optimizer over the flat stage-0 groups
  (``FlatGroup``): the per-(leaf, chunk) L1 sums as differences of one
  fp64 prefix sum at the segments' ends, the scales broadcast back by a
  segment-id vector built once, so a step is a bounded number of
  launches whatever the number of leaves, and its sums do not depend on
  how a device schedules its adds. Its phase
  is a host bool (``compressed``), which the engine knows without
  reading the step count off the card every step.

JAX has no Pallas kernel for any of this (plain jnp): the port's step is
plain PyTorch.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .fused_update import FlatGroup, tree_flatten, tree_unflatten
from .optimizers import (FlatOptimizer, ScheduleOrFloat, _commit,
                         bias_corrections)

AllReduce = Optional[Callable[[torch.Tensor], Any]]

# The state's buffers in the JAX optimizer file's leaf order (after the
# step count): tree_leaves of OnebitState.
STATE_BUFFERS = ("m", "v", "worker_error", "server_error")


class OnebitState(NamedTuple):
    """The carried state: ``step`` (int32, the optimizer steps taken)
    and the momentum, the variance (frozen after warmup) and the worker
    and server error buffers, each a tree of fp32 leaves (the flat
    optimizer: a tuple with one buffer per group; ``worker_error`` is this
    rank's, the JAX engine's leaf carries all ranks' on a leading [dp]
    axis)."""
    step: torch.Tensor
    m: Any
    v: Any
    worker_error: Any
    server_error: Any

    @property
    def count(self) -> torch.Tensor:
        """The step count under the name the other optimizers' states
        give it."""
        return self.step


def init_state(params: Any) -> OnebitState:
    """Zeros like ``params`` (fp32) in every buffer, step 0."""
    leaves, spec = tree_flatten(params)
    dev = leaves[0].device

    def zeros():
        return tree_unflatten(spec, [torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device)
                                     for p in leaves])
    return OnebitState(step=torch.zeros((), dtype=torch.int32, device=dev),
                       m=zeros(), v=zeros(), worker_error=zeros(),
                       server_error=zeros())


def chunk_counts(n: int, chunks: int) -> Tuple[int, int, np.ndarray]:
    """``(chunks, width, counts)`` of ``_compress`` over ``n`` elements:
    one chunk when ``chunks`` <= 1 or ``n`` < ``chunks``; else ``chunks``
    chunks of ``ceil(n / chunks)`` elements, each with its real count
    clipped to ``[1, width]``, computed in fp32 as the JAX function does
    (the last chunks may be padding only)."""
    if chunks <= 1 or n < chunks:
        return 1, n, np.asarray([n], np.float32)
    width = -(-n // chunks)
    counts = np.clip(np.float32(n) - np.arange(chunks, dtype=np.float32) *
                     np.float32(width), np.float32(1.0), np.float32(width))
    return chunks, width, counts.astype(np.float32)


def _compress(x: torch.Tensor, error: torch.Tensor, chunks: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback 1-bit compression of one tensor: ``compensated =
    x + error``, ``transmitted = scale * sign(compensated)`` with one L1
    scale (mean |compensated| over the real elements) per chunk, and
    the new error ``compensated - transmitted``. Returns
    ``(transmitted, new_error)``."""
    compensated = x + error
    n = compensated.numel()
    k, width, counts = chunk_counts(n, chunks)
    if k == 1:
        scale = torch.mean(torch.abs(compensated))
        transmitted = scale * torch.sign(compensated)
        return transmitted, compensated - transmitted
    flat = compensated.reshape(-1)
    rows = torch.nn.functional.pad(flat, (0, k * width - n)).view(k, width)
    scale = torch.sum(torch.abs(rows), dim=1) / torch.from_numpy(
        counts).to(rows.device)
    transmitted = (scale[:, None] * torch.sign(rows)).reshape(-1)[:n]
    transmitted = transmitted.reshape(x.shape)
    return transmitted, compensated - transmitted


def _psum_mean(t: torch.Tensor, all_reduce: AllReduce, dp: int
               ) -> torch.Tensor:
    if all_reduce is None or dp <= 1:
        return t
    return all_reduce(t.clone()) / dp


def onebit_adam_update(grads_local: Any, state: OnebitState, params: Any, *,
                       lr, b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8, weight_decay: float = 0.0,
                       freeze_step: int = 100000, dp: int = 1,
                       all_reduce: AllReduce = None, clip: float = 0.0,
                       loss_scale=None):
    """One 1-bit Adam step, leaf by leaf (the JAX ``onebit_adam_update``;
    ``all_reduce``, an in-place sum over the ranks, takes the place of
    ``lax.psum`` over the dp axis). ``grads_local`` are the rank's own
    gradients, of ``loss * loss_scale`` when ``loss_scale`` is given
    (unscaled here in fp32). The phase comes from the step count (read
    on the host). Returns ``(new_params, new_state, aux)``, ``aux =
    {"grad_norm", "overflow"}``; the inputs are not modified."""
    g_leaves, spec = tree_flatten(grads_local)
    p_leaves = tree_flatten(params)[0]
    m0, v0, w0, s0 = (tree_flatten(t)[0] for t in
                      (state.m, state.v, state.worker_error,
                       state.server_error))
    f32 = torch.float32
    if loss_scale is not None:
        inv = 1.0 / torch.as_tensor(loss_scale, dtype=f32,
                                    device=g_leaves[0].device)
        g_leaves = [g.to(f32) * inv for g in g_leaves]
    else:
        g_leaves = [g.to(f32) for g in g_leaves]
    step = state.step + 1
    in_warmup = int(step) <= freeze_step

    def clipped(g, norm):
        if not (clip and clip > 0):
            return g
        coeff = torch.clamp(clip / (norm + 1e-6), max=1.0)
        return [t * coeff for t in g]

    if in_warmup:
        g = [_psum_mean(t, all_reduce, dp) for t in g_leaves]
        norm = torch.sqrt(sum(torch.sum(torch.square(t)) for t in g))
        g = clipped(g, norm)
        m = [b1 * mm + (1 - b1) * gg for mm, gg in zip(m0, g)]
        v = [b2 * vv + (1 - b2) * gg * gg for vv, gg in zip(v0, g)]
        bc1, bc2 = bias_corrections(state.step, b1, b2)
        upd = [(mm / bc1) / (torch.sqrt(vv / bc2) + eps)
               for mm, vv in zip(m, v)]
        werr, serr = w0, s0
    else:
        norm = torch.sqrt(_psum_mean(
            sum(torch.sum(torch.square(t)) for t in g_leaves),
            all_reduce, dp))
        g = clipped(g_leaves, norm)
        m_local = [b1 * mm + (1 - b1) * gg for mm, gg in zip(m0, g)]
        m, werr, serr = [], [], []
        for mm, we, se in zip(m_local, w0, s0):
            sent, new_we = _compress(mm, we, chunks=dp)
            gathered = _psum_mean(sent, all_reduce, dp)
            final, new_se = _compress(gathered, se, chunks=dp)
            m.append(final)
            werr.append(new_we)
            serr.append(new_se)
        v = v0
        upd = [mm / (torch.sqrt(vv) + eps) for mm, vv in zip(m, v)]
    overflow = torch.logical_not(torch.isfinite(norm))

    def commit(old, new):
        return [torch.where(overflow, o, n) for o, n in zip(old, new)]

    new_p = []
    for p, u in zip(p_leaves, upd):
        p32 = p.to(f32)
        d = u + weight_decay * p32 if weight_decay else u
        new_p.append((p32 - lr * d).to(p.dtype))
    un = lambda leaves: tree_unflatten(spec, leaves)  # noqa: E731
    new_state = OnebitState(
        step=torch.where(overflow, state.step, step).to(torch.int32),
        m=un(commit(m0, m)), v=un(commit(v0, v)),
        worker_error=un(commit(w0, werr)), server_error=un(commit(s0, serr)))
    return un(commit(p_leaves, new_p)), new_state, \
        {"grad_norm": norm, "overflow": overflow}


def comm_bytes(n_elements: int, *, compressed: bool, chunks: int = 1) -> int:
    """A rank's payload for one all-reduce of ``n_elements``: 4 bytes an
    element in full precision; a sign bit an element and an fp32 scale a
    chunk compressed (the reference's packed wire)."""
    if not compressed:
        return 4 * n_elements
    return (n_elements + 7) // 8 + 4 * chunks


def compression_ratio(n_elements: int, chunks: int = 1) -> float:
    return comm_bytes(n_elements, compressed=False) / \
        comm_bytes(n_elements, compressed=True, chunks=chunks)


def step_comm_bytes(sizes: List[int], dp: int, compressed: bool) -> int:
    """A step's ``comm_bytes`` summed over the leaves (``sizes``): each
    leaf is one exchange, compressed with ``chunk_counts``' chunks."""
    return sum(comm_bytes(n, compressed=compressed,
                          chunks=chunk_counts(n, dp)[0]) for n in sizes)


# --------------------------------------------------------------------- #
# The flat optimizer
# --------------------------------------------------------------------- #
class _Segments:
    """One group's (leaf, chunk) segments, prepared once: the non-empty
    segments tile the flat buffer in order; ``last`` holds each one's
    last element, ``counts`` its fp32 count and ``ids`` the segment of
    every element (int32)."""

    def __init__(self, grp: FlatGroup, dp: int):
        dev = grp.param.device
        counts, lengths = [], []
        for n in grp.sizes:
            k, width, cnt = chunk_counts(n, dp)
            for c in range(k):
                lo, hi = c * width, min(n, (c + 1) * width)
                if hi <= lo:          # a chunk of padding only
                    continue
                counts.append(cnt[c])
                lengths.append(hi - lo)
        lengths_t = torch.tensor(lengths, dtype=torch.int64)
        self.last = (torch.cumsum(lengths_t, 0) - 1).to(dev)
        self.counts = torch.tensor(np.asarray(counts, np.float32),
                                   device=dev)
        self.ids = torch.repeat_interleave(
            torch.arange(len(lengths), dtype=torch.int32), lengths_t).to(dev)

    def compress(self, x: torch.Tensor, error: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``_compress`` of every leaf of the group at once: returns
        ``(transmitted, new_error)`` (flat). Each segment's L1 sum is
        the difference of two fp64 prefix sums, rounded to fp32 (an
        fp32 running sum would drift by n * 2^-24 over a large leaf)."""
        comp = x + error
        ends = torch.cumsum(torch.abs(comp), 0, dtype=torch.float64
                            ).index_select(0, self.last)
        sums = torch.diff(ends, prepend=ends.new_zeros(1)).to(torch.float32)
        scale = (sums / self.counts).index_select(0, self.ids)
        transmitted = scale * torch.sign(comp)
        return transmitted, comp - transmitted


class OnebitAdam(FlatOptimizer):
    """1-bit Adam over the engine's flat stage-0 groups (module
    docstring). ``init(groups, dp)`` prepares the groups' segments;
    ``step`` runs one phase, chosen by the caller."""

    def __init__(self, learning_rate: ScheduleOrFloat, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, freeze_step: int = 100000):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.freeze_step = int(freeze_step)
        self.dp = 1
        self._segments: List[_Segments] = []

    def init(self, groups: List[FlatGroup], dp: int = 1) -> OnebitState:
        for grp in groups:
            if not isinstance(grp, FlatGroup) or grp.dtype != torch.float32:
                raise ValueError(
                    "OnebitAdam updates whole fp32 master groups (ZeRO stage "
                    "0 with fp32 masters)")
        self.dp = int(dp)
        self._segments = [_Segments(grp, self.dp) for grp in groups]
        dev = groups[0].param.device

        def zeros():
            return tuple(torch.zeros(grp.numel, dtype=torch.float32,
                                     device=dev) for grp in groups)
        return OnebitState(step=torch.zeros((), dtype=torch.int32,
                                            device=dev),
                           m=zeros(), v=zeros(), worker_error=zeros(),
                           server_error=zeros())

    def jax_layout(self) -> List[str]:
        return ["step", *STATE_BUFFERS]

    def step(self, groups: List[FlatGroup], state: OnebitState, *,
             lr: torch.Tensor, compressed: bool, clip: float = 0.0,
             inv_scale: Optional[torch.Tensor] = None,
             all_reduce: AllReduce = None
             ) -> Tuple[OnebitState, torch.Tensor, torch.Tensor]:
        """One step of every group, in place on the groups' params (and
        cast copies) and the state's buffers. ``grp.grad`` holds the
        rank's gradients (times the fp16 loss scale, which ``inv_scale``
        undoes; the warmup all-reduces them in place). ``compressed``
        says which phase the step count is in (the engine's host
        knowledge of it). Returns ``(state, grad_norm, overflow)``."""
        f32 = torch.float32
        dp = self.dp if all_reduce is not None else 1
        dev = state.step.device
        b1, b2, eps = self.b1, self.b2, self.eps
        if compressed:
            mult = inv_scale
        else:
            for grp in groups:
                if dp > 1:
                    all_reduce(grp.grad)
            mult = None if dp <= 1 else torch.full((), 1.0 / dp, dtype=f32,
                                                   device=dev)
            if inv_scale is not None:
                mult = inv_scale.to(f32) if mult is None else \
                    mult * inv_scale.to(f32)
        gs = [grp.grad if mult is None else grp.grad * mult
              for grp in groups]
        sumsq = sum(torch.sum(torch.square(g)) for g in gs)
        if compressed:
            sumsq = _psum_mean(sumsq, all_reduce, dp)
        norm = torch.sqrt(sumsq)
        if clip and clip > 0:
            coeff = torch.clamp(clip / (norm + 1e-6), max=1.0)
            gs = [g * coeff for g in gs]
        overflow = torch.logical_not(torch.isfinite(norm))
        new_step = state.step + 1
        if not compressed:
            bc1, bc2 = bias_corrections(state.step, b1, b2)
        for gi, (grp, g) in enumerate(zip(groups, gs)):
            m, v = state.m[gi], state.v[gi]
            m_new = b1 * m + (1 - b1) * g
            if compressed:
                seg = self._segments[gi]
                sent, werr = seg.compress(m_new, state.worker_error[gi])
                gathered = _psum_mean(sent, all_reduce, dp)
                m_new, serr = seg.compress(gathered, state.server_error[gi])
                upd = m_new / (torch.sqrt(v) + eps)
                _commit(state.worker_error[gi], werr, overflow)
                _commit(state.server_error[gi], serr, overflow)
            else:
                v_new = b2 * v + (1 - b2) * g * g
                upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
                _commit(v, v_new, overflow)
            _commit(m, m_new, overflow)
            p = grp.param
            d = upd + self.weight_decay * p if self.weight_decay else upd
            _commit(p, p - lr * d, overflow)
            if grp.cast is not None:
                grp.cast.copy_(grp.param)
        step = torch.where(overflow, state.step, new_step).to(torch.int32)
        return state._replace(step=step), norm, overflow


def onebit_reference_step(opt: OnebitAdam, params: List[torch.Tensor],
                          grads: List[torch.Tensor], state: OnebitState,
                          lr, *, dp: int = 1, all_reduce: AllReduce = None,
                          clip: float = 0.0, loss_scale=None
                          ) -> Tuple[List[torch.Tensor], OnebitState,
                                     Dict[str, torch.Tensor]]:
    """The plain reference of ``OnebitAdam``'s step: the JAX function
    leaf by leaf (``onebit_adam_update``) with ``opt``'s hyperparameters,
    on leaf lists (``state``'s buffers lists of leaves). The inputs are
    not modified. The flat step is held against it (on the CPU here and
    in the tests, on the card by ``chip_smoke.py``)."""
    return onebit_adam_update(
        grads, state, params, lr=lr, b1=opt.b1, b2=opt.b2, eps=opt.eps,
        weight_decay=opt.weight_decay, freeze_step=opt.freeze_step, dp=dp,
        all_reduce=all_reduce, clip=clip, loss_scale=loss_scale)


__all__ = ["OnebitState", "OnebitAdam", "init_state", "chunk_counts",
           "_compress", "onebit_adam_update", "onebit_reference_step",
           "comm_bytes", "compression_ratio", "step_comm_bytes",
           "STATE_BUFFERS"]
