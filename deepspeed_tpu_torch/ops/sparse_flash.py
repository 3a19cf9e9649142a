"""LUT-driven block-sparse flash attention: only the live blocks of a
layout are touched.

Port of ``deepspeed_tpu/ops/sparse_flash.py``. The layout ``[nH, nQ,
nK]`` flattens into lists of live (q-block, k-block) pairs per head
(``build_flat_luts``), optionally coarsened into ``qwiden x widen``
super-tiles whose ``kmask`` bits say which sub-blocks live. The kernels
are CUDA C++ in ``csrc/sparse_flash.cu``, replacing the Pallas
``_sfwd_kernel`` (K7), ``_sdq_kernel`` (K8b), ``_sdkv_kernel`` (K8c) and
``_sfused_bwd_kernel`` (K8a, with its scatter-add of the dq partials by
q row); the note at the top of that file gives their bound and design.
They read the LUTs in row-offset (CSR) form and walk the live blocks at
their own tile (64 rows, 32 in fp32), so every legal (qwiden, widen)
computes the same function; the super-tile pick (``pick_tile``, a cost
model fitted to the TPU) is kept for the API and the JAX package's
``DS_SPARSE_WIDEN`` / ``DS_SPARSE_QWIDEN`` overrides.

Layouts as in ``ops/flash_attention.py``: q, k, v ``[B, S, nH, D]``
(read through strides), o and the gradients contiguous, lse and delta
fp32 ``[B*nH, S]``. Each kernel wrapper (``sparse_flash_fwd``,
``sparse_flash_bwd_dq``, ``sparse_flash_bwd_dkv``,
``sparse_flash_bwd_fused``) launches its kernel for CUDA tensors,
raising on what it does not take, and runs the plain version
(``sparse_fwd_plain`` / ``sparse_bwd_plain``: the flash plain versions
over the layout's element mask) for CPU tensors; ``.launches`` counts
its kernel launches. The backward is the dq + dk/dv pair, or the fused
kernel when ``DS_SPARSE_FUSED_BWD=1``, as in the JAX package. A row that
keeps no key gives zeros (the JAX kernels leave it undefined).
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import op_builder
from . import costs
from .flash_attention import (_TILE, _check, _common, flash_bwd_plain,
                              flash_delta, flash_fwd_plain)


def build_flat_luts(layout: np.ndarray, widen: int = 1, qwiden: int = 1):
    """layout [H, nQ, nK] -> (qid, kid, nnz, kmask, qidT, kidT, nnzT,
    kmaskT) int32 arrays ([H, NNZ] / [H]), row-major for fwd/dq and
    column-major for dk/dv; padded tails repeat the last pair with kmask
    0. None if any row or column is empty, or the tiling does not fit.
    ``widen``/``qwiden`` coarsen K/Q: one entry covers a ``qwiden x
    widen`` super-tile (qid/kid index wide blocks) and ``kmask`` has bit
    ``sq * widen + sk`` set where sub-block (sq, sk) is live."""
    lay = np.asarray(layout) != 0
    H, nQ, nK = lay.shape
    if (lay.sum(-1) == 0).any() or (lay.sum(-2) == 0).any():
        return None
    w, qw = int(widen), int(qwiden)
    if nK % w != 0 or nQ % qw != 0 or qw * w > 31:
        return None
    nK2, nQ2 = nK // w, nQ // qw
    sub = lay.reshape(H, nQ2, qw, nK2, w).transpose(0, 1, 3, 2, 4)
    flat = sub.reshape(H, nQ2, nK2, qw * w)
    bits = (flat.astype(np.int64) <<
            np.arange(qw * w, dtype=np.int64)).sum(-1).astype(np.int32)

    def flatten(mask, bit_lookup):   # row-major active pairs per head
        pairs = [np.argwhere(mask[h]) for h in range(H)]
        nnz = np.asarray([len(p) for p in pairs], np.int32)
        NNZ = int(nnz.max())
        rid = np.zeros((H, NNZ), np.int32)
        cid = np.zeros((H, NNZ), np.int32)
        bm = np.zeros((H, NNZ), np.int32)
        for h, p in enumerate(pairs):
            rid[h, :len(p)] = p[:, 0]
            cid[h, :len(p)] = p[:, 1]
            bm[h, :len(p)] = bit_lookup(h, p[:, 0], p[:, 1])
            rid[h, len(p):] = p[-1, 0]
            cid[h, len(p):] = p[-1, 1]
        return rid, cid, nnz, bm

    lay2 = bits != 0
    qid, kid, nnz, kmask = flatten(lay2, lambda h, q, k2: bits[h, q, k2])
    kidT, qidT, nnzT, kmaskT = flatten(
        lay2.transpose(0, 2, 1), lambda h, k2, q: bits[h, q, k2])
    return qid, kid, nnz, kmask, qidT, kidT, nnzT, kmaskT


# The JAX package's super-tile cost model (fitted to the TPU: per-grid-step
# fixed cost in 128x128-block units, and a q-widening penalty).
_WIDEN_ALPHA_128 = 7.7
_QW_PENALTY = 1.0


def supertile_nnz(layout: np.ndarray, qw: int, kw: int) -> int:
    """Occupied qw x kw super-tiles of a [H, nQ, nK] layout."""
    lay = np.asarray(layout) != 0
    H, nQ, nK = lay.shape
    return int(lay.reshape(H, nQ // qw, qw, nK // kw, kw)
               .any(axis=(2, 4)).sum())


def pick_tile(layout: np.ndarray, block: int = 128,
              k_choices=(1, 2, 4, 8), q_choices=(1, 2)):
    """(qwiden, kwiden) minimizing the JAX package's step-cost model;
    among near-ties (within 8%) the largest super-tile."""
    lay = np.asarray(layout) != 0
    H, nQ, nK = lay.shape
    alpha = _WIDEN_ALPHA_128 * (128.0 / max(block, 1)) ** 2
    cands = {}
    for qw in q_choices:
        if nQ % qw != 0:
            continue
        for kw in k_choices:
            if nK % kw != 0 or qw * kw > 31:
                continue
            cands[(qw, kw)] = supertile_nnz(lay, qw, kw) * \
                (alpha + qw * kw + _QW_PENALTY * (qw - 1))
    if not cands:
        return (1, 1)
    lo = min(cands.values())
    near = [t for t, c in cands.items() if c <= 1.08 * lo]
    return max(near, key=lambda t: (t[0] * t[1], t[1]))


def pick_widen(layout: np.ndarray, block: int = 128,
               choices=(1, 2, 4, 8)) -> int:
    """K-only tiling pick: ``pick_tile`` with q_choices=(1,)."""
    return pick_tile(layout, block=block, k_choices=tuple(choices),
                     q_choices=(1,))[1]


# --------------------------------------------------------------------- #
# Host tables for the kernels
# --------------------------------------------------------------------- #
class SparsePlan(NamedTuple):
    """One layout's tables for the kernels on one device, for one tile
    size and causal flag. LUTs in CSR form: the row-major entries of
    super-row q2 of head h are ``row_ptr[h, q2] .. row_ptr[h, q2 + 1]``
    of ``kid``/``kmask``, the column-major entries of super-column k2
    ``col_ptr[h, k2] .. col_ptr[h, k2 + 1]`` of ``qidT``/``kmaskT``. The
    fused backward's dq partials: one fp32 ``[tile, D]`` slot per
    visited (q-tile, k-tile) pair, numbered k-tile by k-tile
    (``slot_base[h, kt]`` is the column's first); ``rslots[h,
    rslot_ptr[h, qt] .. rslot_ptr[h, qt + 1]]`` are q-tile qt's slots in
    k order."""
    layout: np.ndarray          # bool [nH, nb, nb]
    block: int
    widen: int
    qwiden: int
    tile: int
    row_ptr: torch.Tensor
    kid: torch.Tensor
    kmask: torch.Tensor
    col_ptr: torch.Tensor
    qidT: torch.Tensor
    kmaskT: torch.Tensor
    slot_base: torch.Tensor
    rslot_ptr: torch.Tensor
    rslots: torch.Tensor
    slots_per_head: int


def tile_pairs(layout: np.ndarray, block: int, tile: int,
               causal: bool) -> np.ndarray:
    """Bool ``[nH, S/tile, S/tile]``: the (q-tile, k-tile) pairs the
    kernels visit — a live layout block's tiles, less those wholly above
    the causal diagonal."""
    per = block // tile
    t = (np.asarray(layout) != 0).repeat(per, 1).repeat(per, 2)
    if causal:
        t = t & np.tril(np.ones(t.shape[1:], bool))
    return t


def _csr(ids: np.ndarray, nnz: np.ndarray, n: int) -> np.ndarray:
    """Row offsets [H, n + 1] of the sorted id lists ``ids[h, :nnz[h]]``."""
    return np.stack([np.searchsorted(ids[h, :nnz[h]], np.arange(n + 1))
                     for h in range(ids.shape[0])]).astype(np.int32)


def sparse_plan(layout, S: int, dtype: torch.dtype, causal: bool,
                device, widen: int = 1, qwiden: int = 1) -> SparsePlan:
    """The tables of ``layout`` for the kernels, built once per layout,
    tiling, tile, causal flag and device. Raises ValueError where
    ``build_flat_luts`` gives none (an empty row or column)."""
    lay = np.asarray(layout) != 0
    return _plan(lay.tobytes(), lay.shape, S, _TILE[dtype], bool(causal),
                 torch.device(device), int(widen), int(qwiden))


@functools.lru_cache(maxsize=64)
def _plan(lay_bytes: bytes, shape: tuple, S: int, tile: int, causal: bool,
          device: torch.device, widen: int, qwiden: int) -> SparsePlan:
    lay = np.frombuffer(lay_bytes, bool).reshape(shape)
    H, nQ, nK = shape
    if nQ != nK or S % nQ:
        raise ValueError(f"layout {shape} does not tile sequence {S} in "
                         "square blocks")
    block = S // nQ
    if block % tile:
        raise ValueError(f"layout block {block} is not a multiple of the "
                         f"kernel tile ({tile})")
    luts = build_flat_luts(lay, widen=widen, qwiden=qwiden)
    if luts is None:
        raise ValueError("layout has an empty q-block row or k-block "
                         "column; caller should use the gated kernel")
    qid, kid, nnz, kmask, qidT, kidT, nnzT, kmaskT = luts
    pairs = tile_pairs(lay, block, tile, causal)            # [h, qt, kt]
    col_major = pairs.transpose(0, 2, 1).reshape(H, -1)
    slot = (np.cumsum(col_major, -1) - 1).reshape(pairs.shape) \
        .transpose(0, 2, 1)                                 # [h, qt, kt]
    slot_base = np.cumsum(pairs.sum(1), -1) - pairs.sum(1)  # [h, kt]
    rslot_ptr = np.zeros((H, pairs.shape[1] + 1), np.int64)
    rslot_ptr[:, 1:] = np.cumsum(pairs.sum(-1), -1)
    width = max(1, int(col_major.sum(-1).max()))
    rslots = np.zeros((H, width), np.int64)
    for h in range(H):              # row-major: q-tile by q-tile, k order
        rslots[h, :pairs[h].sum()] = slot[h][pairs[h]]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return SparsePlan(
        layout=lay, block=block, widen=widen, qwiden=qwiden, tile=tile,
        row_ptr=dev(_csr(qid, nnz, nQ // qwiden)), kid=dev(kid),
        kmask=dev(kmask), col_ptr=dev(_csr(kidT, nnzT, nK // widen)),
        qidT=dev(qidT), kmaskT=dev(kmaskT), slot_base=dev(slot_base),
        rslot_ptr=dev(rslot_ptr), rslots=dev(rslots), slots_per_head=width)


# --------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------- #
def sparse_fwd_plain(q, k, v, layout, causal: bool, scale: float,
                     dropout: float = 0.0, seed=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward over the pairs the layout (and the causal rule) keep,
    in plain PyTorch: ``(o [B, S, nH, D], lse [B*nH, S] fp32)``."""
    return flash_fwd_plain(q, k, v, causal, scale, dropout, seed, layout)


def sparse_bwd_plain(q, k, v, do, lse, delta, layout, causal: bool,
                     scale: float, dropout: float = 0.0, seed=None):
    """``(dq, dk, dv)`` over the kept pairs, in plain PyTorch; the split
    pair and the fused kernel compute this same function."""
    return flash_bwd_plain(q, k, v, do, lse, delta, causal, scale, dropout,
                           seed, layout)


# --------------------------------------------------------------------- #
# Kernel launches
# --------------------------------------------------------------------- #
_FWD, _DQ, _DKV, _FUSED = 0, 1, 2, 3


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name: str, kind: int, q, k, v, layout, causal: bool,
            scale: float, dropout: float, seed, widen: int, qwiden: int,
            do=None, lse=None, delta=None, o=None, dq=None, dk=None,
            dv=None, fused: bool = False) -> None:
    plan = sparse_plan(layout, q.shape[1], q.dtype, causal, q.device, widen,
                       qwiden)
    if plan.layout.shape[0] != q.shape[2]:
        raise ValueError(f"{name}: layout has {plan.layout.shape[0]} heads, "
                         f"q has {q.shape[2]}")
    ws = None
    if fused:
        B, S, nH, D = q.shape
        ws = torch.empty((B * nH * plan.slots_per_head * plan.tile * D,),
                         dtype=torch.float32, device=q.device)
    strides, seed_p, tail = _common(q, seed, dropout, causal, scale)
    rc = op_builder.load().dstt_sparse_flash(
        kind, q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, _ptr(do),
        _ptr(lse), _ptr(delta), _ptr(o), _ptr(dq), _ptr(dk), _ptr(dv),
        _ptr(ws), seed_p, plan.row_ptr.data_ptr(), plan.kid.data_ptr(),
        plan.kmask.data_ptr(), plan.kid.shape[1], plan.col_ptr.data_ptr(),
        plan.qidT.data_ptr(), plan.kmaskT.data_ptr(), plan.qidT.shape[1],
        plan.slot_base.data_ptr(), plan.rslot_ptr.data_ptr(),
        plan.rslots.data_ptr(), plan.rslots.shape[1], plan.slots_per_head,
        plan.block, plan.widen, plan.qwiden, *tail)
    op_builder.check(rc, name)


@costs.declares("K7", costs.sparse_fwd_decl)
def sparse_flash_fwd(q, k, v, layout, causal: bool, scale: float,
                     dropout: float = 0.0, seed=None, widen: int = 1,
                     qwiden: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: ``(o [B, S, nH, D] contiguous, lse [B*nH, S] fp32)`` over the
    live blocks of ``layout`` (numpy ``[nH, nb, nb]``)."""
    if q.device.type == "cpu":
        return sparse_fwd_plain(q, k, v, layout, causal, scale, dropout, seed)
    _check("sparse_flash_fwd", q, k, v, seed, dropout)
    B, S, nH, D = q.shape
    o = torch.empty((B, S, nH, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * nH, S), dtype=torch.float32, device=q.device)
    _launch("sparse_flash_fwd", _FWD, q, k, v, layout, causal, scale,
            dropout, seed, widen, qwiden, lse=lse, o=o)
    sparse_flash_fwd.launches += 1
    return o, lse


@costs.declares("K8b", costs.sparse_bwd_dq_decl)
def sparse_flash_bwd_dq(q, k, v, do, lse, delta, layout, causal: bool,
                        scale: float, dropout: float = 0.0, seed=None,
                        widen: int = 1, qwiden: int = 1) -> torch.Tensor:
    """K8b: dq ``[B, S, nH, D]`` over the row-major LUT."""
    if q.device.type == "cpu":
        return sparse_bwd_plain(q, k, v, do, lse, delta, layout, causal,
                                scale, dropout, seed)[0]
    _check("sparse_flash_bwd_dq", q, k, v, seed, dropout, do, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("sparse_flash_bwd_dq", _DQ, q, k, v, layout, causal, scale,
            dropout, seed, widen, qwiden, do=do, lse=lse, delta=delta, dq=dq)
    sparse_flash_bwd_dq.launches += 1
    return dq


@costs.declares("K8c", costs.sparse_bwd_dkv_decl)
def sparse_flash_bwd_dkv(q, k, v, do, lse, delta, layout, causal: bool,
                         scale: float, dropout: float = 0.0, seed=None,
                         widen: int = 1, qwiden: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8c: (dk, dv) ``[B, S, nH, D]`` over the column-major LUT."""
    if q.device.type == "cpu":
        return sparse_bwd_plain(q, k, v, do, lse, delta, layout, causal,
                                scale, dropout, seed)[1:]
    _check("sparse_flash_bwd_dkv", q, k, v, seed, dropout, do, lse, delta)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("sparse_flash_bwd_dkv", _DKV, q, k, v, layout, causal, scale,
            dropout, seed, widen, qwiden, do=do, lse=lse, delta=delta, dk=dk,
            dv=dv)
    sparse_flash_bwd_dkv.launches += 1
    return dk, dv


@costs.declares("K8a", costs.sparse_bwd_fused_decl)
def sparse_flash_bwd_fused(q, k, v, do, lse, delta, layout, causal: bool,
                           scale: float, dropout: float = 0.0, seed=None,
                           widen: int = 1, qwiden: int = 1
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """K8a: (dq, dk, dv) from one column-major pass that also writes
    each visited pair's fp32 dq partial, then a fixed-order sum of a
    q-tile's partials (no atomics). Uses an fp32 workspace of
    ``B*nH * slots_per_head * tile * D`` elements."""
    if q.device.type == "cpu":
        return sparse_bwd_plain(q, k, v, do, lse, delta, layout, causal,
                                scale, dropout, seed)
    _check("sparse_flash_bwd_fused", q, k, v, seed, dropout, do, lse, delta)
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    _launch("sparse_flash_bwd_fused", _FUSED, q, k, v, layout, causal, scale,
            dropout, seed, widen, qwiden, do=do, lse=lse, delta=delta, dq=dq,
            dk=dk, dv=dv, fused=True)
    sparse_flash_bwd_fused.launches += 1
    return dq, dk, dv


for _fn in (sparse_flash_fwd, sparse_flash_bwd_dq, sparse_flash_bwd_dkv,
            sparse_flash_bwd_fused):
    _fn.launches = 0


def use_fused_bwd() -> bool:
    """``DS_SPARSE_FUSED_BWD=1`` opts into the fused backward (K8a), as
    in the JAX package; the split pair (K8b + K8c) is the default."""
    return os.environ.get("DS_SPARSE_FUSED_BWD", "0") == "1"


# --------------------------------------------------------------------- #
# Autograd and the attention function
# --------------------------------------------------------------------- #
class _SparseFlash(torch.autograd.Function):
    """The JAX ``_sparse_flash`` custom VJP: the forward saves ``(q, k,
    v, seed, o, lse)``; the backward computes delta and runs the split
    pair or, with ``DS_SPARSE_FUSED_BWD=1``, the fused kernel."""

    @staticmethod
    def forward(ctx, q, k, v, seed, layout, scale, causal, dropout, widen,
                qwiden):
        o, lse = sparse_flash_fwd(q, k, v, layout, causal, scale, dropout,
                                  seed, widen, qwiden)
        ctx.save_for_backward(q, k, v, seed, o, lse)
        ctx.cfg = (layout, scale, causal, dropout, widen, qwiden)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seed, o, lse = ctx.saved_tensors
        layout, scale, causal, dropout, widen, qwiden = ctx.cfg
        do = do.contiguous()
        delta = flash_delta(do, o)
        args = (q, k, v, do, lse, delta, layout, causal, scale, dropout,
                seed, widen, qwiden)
        if use_fused_bwd():
            dq, dk, dv = sparse_flash_bwd_fused(*args)
        else:
            dq = sparse_flash_bwd_dq(*args)
            dk, dv = sparse_flash_bwd_dkv(*args)
        return (dq, dk, dv) + (None,) * 7


def resolve_tile(layout: np.ndarray, block: int, widen: int = 0,
                 qwiden: int = 0) -> Tuple[int, int]:
    """(qwiden, widen) as the JAX ``sparse_flash_attention`` resolves
    them: 0 = auto (``DS_SPARSE_WIDEN`` / ``DS_SPARSE_QWIDEN``, else
    ``pick_tile`` at the layout's block; the JAX package's on-chip
    autotune is not ported); pinning one factor leaves the other at 1; a
    factor that does not divide the layout or passes the 31-bit mask
    falls back to 1 with a warning."""
    lay = np.asarray(layout)
    if widen == 0:
        widen = int(os.environ.get("DS_SPARSE_WIDEN", "0"))
    if qwiden == 0:
        qwiden = int(os.environ.get("DS_SPARSE_QWIDEN", "0"))
    if widen == 0 and qwiden == 0:
        qwiden, widen = pick_tile(lay, block=block)
    widen = widen or 1
    qwiden = qwiden or 1
    req = (qwiden, widen)
    if lay.shape[2] % widen != 0 or widen > 31:
        widen = 1
    if lay.shape[1] % qwiden != 0 or qwiden * widen > 31:
        qwiden = 1
    if (qwiden, widen) != req:
        from ..utils.logging import logger
        logger.warning(
            f"sparse_flash_attention: requested super-tile q{req[0]}xk"
            f"{req[1]} does not fit this layout (divisibility or the "
            f"31-bit mask cap); running q{qwiden}xk{widen}")
    return qwiden, widen


def sparse_flash_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, layout, *, causal: bool = False,
                           scale: float, seed: Optional[torch.Tensor] = None,
                           dropout: float = 0.0, widen: int = 0,
                           qwiden: int = 0) -> torch.Tensor:
    """Differentiable LUT block-sparse attention: q, k, v ``[B, S, nH,
    D]``; ``layout`` a host ``[nH, nQ, nK]`` array with no empty row or
    column (ValueError otherwise). ``widen``/``qwiden``: 0 = auto (see
    ``resolve_tile``), else explicit; every legal pair computes the same
    function."""
    lay = np.asarray(layout) != 0
    S = q.shape[1]
    if k.shape[1] != S or lay.shape[1] != lay.shape[2]:
        raise ValueError("sparse_flash_attention: self-attention with "
                         "square layout blocks only")
    qwiden, widen = resolve_tile(lay, S // lay.shape[2], widen, qwiden)
    if q.device.type == "cpu":
        if build_flat_luts(lay, widen, qwiden) is None:
            raise ValueError("layout has an empty q-block row or k-block "
                             "column; caller should use the gated kernel")
    else:
        sparse_plan(lay, S, q.dtype, causal, q.device, widen, qwiden)
    if seed is None:
        seed = torch.zeros((), dtype=torch.int32, device=q.device)
    return _SparseFlash.apply(q, k, v, seed, lay, scale, causal,
                              float(dropout), widen, qwiden)


__all__ = ["build_flat_luts", "supertile_nnz", "pick_tile", "pick_widen",
           "SparsePlan", "tile_pairs", "sparse_plan", "sparse_fwd_plain",
           "sparse_bwd_plain", "sparse_flash_fwd", "sparse_flash_bwd_dq",
           "sparse_flash_bwd_dkv", "sparse_flash_bwd_fused", "use_fused_bwd",
           "resolve_tile", "sparse_flash_attention"]
