"""Flash attention: dense or causal attention that never stores the
[S, S] scores, with in-kernel dropout regenerated in the backward.

Port of ``deepspeed_tpu/ops/flash_attention.py``. The kernels are CUDA
C++ in ``csrc/flash_attention.cu``, replacing the Pallas ``_fwd_kernel``
(K1), ``_bwd_dq_kernel`` (K2a), ``_bwd_dkv_kernel`` (K2b) and
``_bwd_fused_kernel`` (K2c); the note at the top of that file gives
their bound and design.

Block-sparse layouts (``flash_attention(layout=...)``, an int
``[nH, S//block, S//block]`` array) route as in the JAX package: a mask,
``S % 128`` or a block that is not a multiple of 128 runs dense
attention with the layout as a mask; a layout the host can read whose
lookup tables fit runs the LUT kernels of ``ops/sparse_flash.py``;
anything else (a layout held on the card, or one with an empty row or
column) runs the layout-gated mode of K1/K2a/K2b, which skips a tile
whose enclosing layout block is 0. The fused K2c takes no layout.

Layouts: the public functions take q, k, v as ``[B, S, nH, D]`` (the
JAX layout); the kernels read them through strides, so the split of
the fused QKV projection goes in without a transpose. lse and delta are
fp32 ``[B*nH, S]``, rows in the JAX ``_to_bh`` order ``bh = b*nH + n``,
which is also the dropout hash's head index. Under tensor parallelism a
rank holds heads ``h0 .. h0+nH-1`` of ``nH_all``: ``heads=(h0,
nH_all)`` makes the hash index ``b*nH_all + h0 + n``, so the rank draws
the masks those heads draw on one card.

Each kernel wrapper (``flash_attention_fwd``, ``flash_attention_bwd_dq``,
``flash_attention_bwd_dkv``, ``flash_attention_bwd_fused``) launches its
kernel for CUDA tensors, raising on a dtype, head dim or shape it does
not take, and runs its plain PyTorch version (``flash_fwd_plain`` /
``flash_bwd_plain``) for CPU tensors; ``.launches`` counts its kernel
launches. The backward takes the fused kernel exactly where the JAX
package does (``use_fused_bwd``) and the dq + dk/dv pair elsewhere.

Numerics contract (the TPU kernels'): fp32 scores ``(q·k) * scale``,
causal masking to -1e30, the softmax normalizer ``l`` summed over the
undropped ``p``, a kept element scaled by the fp32 constant
``1/(1-rate)``, ``p`` rounded to v's dtype before PV and ``ds`` /
``p_drop`` rounded to the input type before their products, fp32
accumulation throughout.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import op_builder
from . import costs

NEG_INF = -1e30
# The JAX package's default forward block target (DS_FLASH_BLOCK); it
# decides the fused-or-split backward rule. The kernels tile at _TILE.
BLOCK_TARGET = 1024
HEAD_DIM_MAX = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# Kernel tile edge (csrc/flash_attention.cu kTile): S must be a multiple.
_TILE = {torch.float32: 32, torch.bfloat16: 64, torch.float16: 64}
_M32 = 0xFFFFFFFF


def _pick_block(s: int) -> int:
    for b in (BLOCK_TARGET, 512, 256, 128):
        if b <= s and s % b == 0:
            return b
    return s


def use_fused_bwd(S: int, Sk: int) -> bool:
    """The JAX package's rule for the whole-S fused backward (K2c): one
    forward block covers the sequence."""
    return S == Sk and _pick_block(S) == S


# --------------------------------------------------------------------- #
# The dropout position hash
# --------------------------------------------------------------------- #
def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 x in [0, 2**32), without overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _u32(x):
    return x.long() & _M32 if isinstance(x, torch.Tensor) else int(x) & _M32


def _hash_keep(x, rate: float):
    """murmur3 finalizer, then keep iff the top 24 bits as a [0, 1)
    float are >= float32(rate)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return u >= float(np.float32(rate))


def dropout_keep(seed, bh, qi: int, kj: int, bq: int, bk: int, rate: float,
                 transposed: bool = False,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """The keep mask of one (q-block, k-block) tile, bit for bit the JAX
    ``_dropout_keep``: ``[bq, bk]`` (``[bk, bq]`` when transposed).
    ``seed`` and ``bh`` are ints or int tensors (``bh`` may carry leading
    dims that broadcast, e.g. ``[n, 1, 1]``)."""
    if device is None:
        device = next((t.device for t in (seed, bh)
                       if isinstance(t, torch.Tensor)), torch.device("cpu"))
    rows = torch.arange(bk if transposed else bq, device=device)[:, None]
    cols = torch.arange(bq if transposed else bk, device=device)[None, :]
    qpos, kpos = (cols + qi * bq, rows + kj * bk) if transposed else \
        (rows + qi * bq, cols + kj * bk)
    stream = _u32(seed) ^ _mul32(_u32(bh), 0x85EBCA6B)
    x = (_mul32(qpos, 0x9E3779B9) + kpos + stream) & _M32
    return _hash_keep(x, rate)


def _keep_grid(seed, BH: int, S: int, Sk: int, rate: float,
               device: torch.device, heads=None, nH: int = 1
               ) -> torch.Tensor:
    """Bool ``[BH, S, Sk]`` keep mask over the whole grid, computed a few
    heads at a time to bound the int64 temporaries; ``heads=(h0,
    nH_all)`` hashes the ``nH`` heads of each batch row at their index
    among all heads (module docstring)."""
    out = []
    for b0 in range(0, BH, 8):
        bh = torch.arange(b0, min(b0 + 8, BH), device=device)[:, None, None]
        if heads is not None:
            bh = (bh // nH) * heads[1] + heads[0] + bh % nH
        out.append(dropout_keep(seed, bh, 0, 0, S, Sk, rate, device=device))
    return torch.cat(out)


def _inv_keep(rate: float) -> float:
    """``1/(1-rate)`` as the fp32 constant the kernels multiply by."""
    return float(np.float32(1.0 / (1.0 - rate)))


# --------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------- #
def _to_bh(x: torch.Tensor) -> torch.Tensor:
    B, S, nH, D = x.shape
    return x.transpose(1, 2).reshape(B * nH, S, D)


def _from_bh(x: torch.Tensor, B: int, nH: int) -> torch.Tensor:
    BH, S, D = x.shape
    return x.reshape(B, nH, S, D).transpose(1, 2)


def _as_tensor(layout, device) -> torch.Tensor:
    """A layout (numpy array or tensor) as a tensor on ``device``."""
    if not isinstance(layout, torch.Tensor):
        layout = torch.as_tensor(np.asarray(layout))
    return layout.to(device)


def layout_element_mask(layout, S: int, causal: bool,
                        device: torch.device) -> torch.Tensor:
    """Bool ``[nH, S, S]``: the (q, k) pairs a block layout ``[nH, nb,
    nb]`` keeps, and the causal rule."""
    lay = _as_tensor(layout, device) != 0
    block = S // lay.shape[-1]
    keep = lay.repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        keep = keep & torch.ones(S, S, dtype=torch.bool, device=device).tril()
    return keep


def _scores(qt, kt, scale: float, causal: bool, keep=None) -> torch.Tensor:
    """fp32 scores ``[BH, S, Sk]``, masked to -1e30 by the causal rule or,
    with ``keep`` (``[nH, S, Sk]``, causal included), by the layout."""
    s = torch.matmul(qt, kt.transpose(1, 2)) * scale
    if keep is not None:
        nH = keep.shape[0]
        return torch.where(keep, s.view(-1, nH, *s.shape[1:]),
                           NEG_INF).view(s.shape)
    if causal:
        S, Sk = s.shape[-2:]
        rows = torch.arange(S, device=s.device)[:, None]
        cols = torch.arange(Sk, device=s.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    return s


def _zero_masked(p: torch.Tensor, keep) -> torch.Tensor:
    """Probabilities of the pairs a layout drops set to exactly 0, so a
    row that keeps no key gives zeros (as the kernels, which never visit
    its tiles)."""
    if keep is None:
        return p
    nH = keep.shape[0]
    return torch.where(keep, p.view(-1, nH, *p.shape[1:]), 0.0).view(
        p.shape)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float, dropout: float = 0.0,
                    seed=None, layout=None, heads=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward in plain PyTorch, as the TPU kernel's ``single_k``
    formula over whole rows: ``(o [B, S, nH, D], lse [B*nH, S] fp32)``.
    With a block ``layout`` it attends only to the pairs the layout keeps
    (a row that keeps none gives o = 0, lse = -1e30). Differentiable, so
    autograd through it is a plain reference step."""
    B, S, nH, D = q.shape
    qt, kt, vt = (_to_bh(t).float() for t in (q, k, v))
    keep = None if layout is None else \
        layout_element_mask(layout, S, causal, q.device)
    s = _scores(qt, kt, scale, causal, keep)
    m = s.amax(-1, keepdim=True)
    p = _zero_masked(torch.exp(s - m), keep)
    l = p.sum(-1, keepdim=True)
    if dropout > 0.0:
        keep = _keep_grid(seed, B * nH, S, k.shape[1], dropout, q.device,
                          heads, nH)
        p = torch.where(keep, p * _inv_keep(dropout), 0.0)
    pv = torch.matmul(p.to(v.dtype).float(), vt)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (pv / l_safe).to(q.dtype)
    return _from_bh(o, B, nH), (m + torch.log(l_safe))[..., 0]


def flash_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO · O)`` in fp32, ``[B*nH, S]`` (computed
    outside the kernels, as the JAX package computes it outside Pallas)."""
    B, S, nH, _ = o.shape
    d = (do.float() * o.float()).sum(-1)                   # [B, S, nH]
    return d.transpose(1, 2).reshape(B * nH, S).contiguous()


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    causal: bool, scale: float, dropout: float = 0.0,
                    seed=None, layout=None, heads=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward in plain PyTorch, as the TPU ``_bwd_fused_kernel``
    formula over the whole sequence: ``(dq, dk, dv)`` in ``[B, S, nH,
    D]``, over the pairs a block ``layout`` keeps where one is given.
    The split kernels compute the same function."""
    B, S, nH, D = q.shape
    qt, kt, vt, dot = (_to_bh(t).float() for t in (q, k, v, do))
    keep = None if layout is None else \
        layout_element_mask(layout, S, causal, q.device)
    p = _zero_masked(torch.exp(_scores(qt, kt, scale, causal, keep) -
                               lse[..., None]), keep)
    dp = torch.matmul(dot, vt.transpose(1, 2))
    p_drop = p
    if dropout > 0.0:
        keep = _keep_grid(seed, B * nH, S, k.shape[1], dropout, q.device,
                          heads, nH)
        inv = _inv_keep(dropout)
        p_drop = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = torch.matmul(p_drop.to(do.dtype).float().transpose(1, 2), dot)
    ds = p * (dp - delta[..., None]) * scale
    dsc = ds.to(q.dtype).float()
    dq = torch.matmul(dsc, kt)
    dk = torch.matmul(dsc.transpose(1, 2), qt)
    return (_from_bh(dq.to(q.dtype), B, nH), _from_bh(dk.to(k.dtype), B, nH),
            _from_bh(dv.to(v.dtype), B, nH))


# --------------------------------------------------------------------- #
# Kernel launches
# --------------------------------------------------------------------- #
def _check(name: str, q, k, v, seed, dropout: float, *rest) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one [B, S, nH, D] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype} not "
                        "supported (float32, bfloat16 or float16, all equal)")
    B, S, nH, D = q.shape
    if D % 16 or not 16 <= D <= HEAD_DIM_MAX:
        raise ValueError(f"{name}: head_dim {D} must be a multiple of 16 "
                         f"up to {HEAD_DIM_MAX}")
    if S % _TILE[q.dtype]:
        raise ValueError(f"{name}: sequence {S} is not a multiple of the "
                         f"kernel tile ({_TILE[q.dtype]})")
    align = 16 // q.element_size()
    if k.stride() != q.stride() or v.stride() != q.stride() or \
            q.stride(-1) != 1 or any(s % align for s in q.stride()[:3]) or \
            any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must share strides, with a "
                         "unit last stride and 16-byte aligned rows")
    for t in rest:
        if t.device != q.device or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError(f"{name}: every other operand must be a "
                             f"contiguous, 16-byte aligned tensor on "
                             f"{q.device}")
    if dropout > 0.0 and (seed is None or seed.device != q.device or
                          seed.dtype != torch.int32):
        raise ValueError(f"{name}: dropout needs an int32 seed tensor on "
                         f"{q.device}")


def _common(q, seed, dropout: float, causal: bool, scale: float):
    """(q/k/v strides, seed pointer, B, nH, S, D, scale, rate, 1/keep,
    causal) for the C entry points."""
    B, S, nH, D = q.shape
    sB, sS, sH, _ = q.stride()
    return ((sB, sS, sH), seed.data_ptr() if dropout > 0.0 else None,
            (B, nH, S, D, float(scale), float(dropout),
             _inv_keep(dropout) if dropout > 0.0 else 1.0, int(causal),
             _DTYPE_CODES[q.dtype], op_builder.stream_ptr(q.device)))


def _with_heads(tail: tuple, heads) -> tuple:
    """``_common``'s tail with the flash entry points' hash heads
    (``hash_nH``, ``hash_h0``) after ``causal``: (0, 0) for the launch's
    own heads."""
    hashed = (0, 0) if heads is None else (int(heads[1]), int(heads[0]))
    return tail[:8] + hashed + tail[8:]


def _gate(name: str, q, layout) -> tuple:
    """(layout pointer, blocks a side, block) of the gated mode's C entry
    points; (None, 0, 0) ungated. The layout is an int32 ``[nH, nb, nb]``
    tensor on q's device whose block is a multiple of the kernel tile."""
    if layout is None:
        return None, 0, 0
    B, S, nH, D = q.shape
    if not isinstance(layout, torch.Tensor) or layout.device != q.device \
            or layout.dtype != torch.int32 or not layout.is_contiguous():
        raise ValueError(f"{name}: the layout must be a contiguous int32 "
                         f"tensor on {q.device}")
    nb = layout.shape[-1]
    if layout.shape != (nH, nb, nb) or S % nb or (S // nb) % _TILE[q.dtype]:
        raise ValueError(f"{name}: layout {tuple(layout.shape)} does not "
                         f"tile {nH} heads x sequence {S} in blocks that "
                         f"are multiples of {_TILE[q.dtype]}")
    return layout.data_ptr(), nb, S // nb


@costs.declares("K1", costs.flash_fwd_decl)
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float, dropout: float = 0.0,
                        seed: Optional[torch.Tensor] = None,
                        layout: Optional[torch.Tensor] = None, heads=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: ``(o [B, S, nH, D] contiguous, lse [B*nH, S] fp32)``; with a
    ``layout``, the gated mode; ``heads``: the dropout hash's (first
    head, all heads) under tensor parallelism."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale, dropout, seed, layout,
                               heads)
    _check("flash_attention_fwd", q, k, v, seed, dropout)
    gate = _gate("flash_attention_fwd", q, layout)
    B, S, nH, D = q.shape
    o = torch.empty((B, S, nH, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * nH, S), dtype=torch.float32, device=q.device)
    strides, seed_p, tail = _common(q, seed, dropout, causal, scale)
    rc = op_builder.load().dstt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, o.data_ptr(),
        lse.data_ptr(), seed_p, *gate, *_with_heads(tail, heads))
    op_builder.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


@costs.declares("K2a", costs.flash_bwd_dq_decl)
def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool,
                           scale: float, dropout: float = 0.0, seed=None,
                           layout=None, heads=None) -> torch.Tensor:
    """K2a: dq ``[B, S, nH, D]`` over q rows; with a ``layout``, the
    gated mode."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, causal, scale,
                               dropout, seed, layout, heads)[0]
    _check("flash_attention_bwd_dq", q, k, v, seed, dropout, do, lse, delta)
    gate = _gate("flash_attention_bwd_dq", q, layout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides, seed_p, tail = _common(q, seed, dropout, causal, scale)
    rc = op_builder.load().dstt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), seed_p, *gate,
        *_with_heads(tail, heads))
    op_builder.check(rc, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


@costs.declares("K2b", costs.flash_bwd_dkv_decl)
def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool,
                            scale: float, dropout: float = 0.0, seed=None,
                            layout=None, heads=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b: (dk, dv) ``[B, S, nH, D]`` over k columns; with a ``layout``,
    the gated mode."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, causal, scale,
                               dropout, seed, layout, heads)[1:]
    _check("flash_attention_bwd_dkv", q, k, v, seed, dropout, do, lse, delta)
    gate = _gate("flash_attention_bwd_dkv", q, layout)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides, seed_p, tail = _common(q, seed, dropout, causal, scale)
    rc = op_builder.load().dstt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        seed_p, *gate, *_with_heads(tail, heads))
    op_builder.check(rc, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


@costs.declares("K2c", costs.flash_bwd_fused_decl)
def flash_attention_bwd_fused(q, k, v, do, lse, delta, causal: bool,
                              scale: float, dropout: float = 0.0, seed=None,
                              heads=None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """K2c: (dq, dk, dv) in one launch, with a block per k-tile for dk,
    dv and a block per q-tile for dq (no workspace)."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, causal, scale,
                               dropout, seed, None, heads)
    _check("flash_attention_bwd_fused", q, k, v, seed, dropout, do, lse,
           delta)
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    strides, seed_p, tail = _common(q, seed, dropout, causal, scale)
    rc = op_builder.load().dstt_flash_bwd_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), seed_p, *_with_heads(tail, heads))
    op_builder.check(rc, "flash_attention_bwd_fused")
    flash_attention_bwd_fused.launches += 1
    return dq, dk, dv


for _fn in (flash_attention_fwd, flash_attention_bwd_dq,
            flash_attention_bwd_dkv, flash_attention_bwd_fused):
    _fn.launches = 0


# --------------------------------------------------------------------- #
# Autograd and the attention functions
# --------------------------------------------------------------------- #
class _Flash(torch.autograd.Function):
    """The JAX ``_flash`` / ``_flash_sparse`` custom VJPs: the forward
    saves ``(q, k, v, seed, o, lse)``; the backward computes delta and
    runs the fused kernel or the dq + dk/dv pair (always the pair with a
    layout, as in the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, seed, scale, causal, dropout, layout,
                heads=None):
        o, lse = flash_attention_fwd(q, k, v, causal, scale, dropout, seed,
                                     layout, heads)
        ctx.save_for_backward(q, k, v, seed, o, lse)
        ctx.cfg = (scale, causal, dropout, layout, heads)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seed, o, lse = ctx.saved_tensors
        scale, causal, dropout, layout, heads = ctx.cfg
        do = do.contiguous()
        delta = flash_delta(do, o)
        args = (q, k, v, do, lse, delta, causal, scale, dropout, seed)
        if layout is None and use_fused_bwd(q.shape[1], k.shape[1]):
            dq, dk, dv = flash_attention_bwd_fused(*args, heads=heads)
        else:
            dq = flash_attention_bwd_dq(*args, layout, heads)
            dk, dv = flash_attention_bwd_dkv(*args, layout, heads)
        return dq, dk, dv, None, None, None, None, None, None


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          seed: torch.Tensor, scale: float, causal: bool,
          dropout: float = 0.0, heads=None) -> torch.Tensor:
    """Differentiable flash attention on ``[B, S, nH, D]`` with an int32
    dropout seed (the JAX ``_flash`` with the layout transposes folded
    in); ``heads``: the dropout hash's (first head, all heads)."""
    return _Flash.apply(q, k, v, seed, scale, causal, dropout, None, heads)


def flash_sparse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 layout: torch.Tensor, seed: torch.Tensor, scale: float,
                 causal: bool, dropout: float = 0.0) -> torch.Tensor:
    """The JAX ``_flash_sparse``: flash attention in the layout-gated
    mode, ``layout`` an int32 ``[nH, nb, nb]`` tensor on q's device (any
    int array for CPU tensors)."""
    return _Flash.apply(q, k, v, seed, scale, causal, dropout, layout)


def draw_seed(rng: torch.Generator, device: torch.device) -> torch.Tensor:
    """An int32 dropout seed drawn from ``rng`` on ``device``, with no
    host sync."""
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (), generator=rng,
                         device=device, dtype=torch.int32)


def _dropout_rate(attn_dropout, rng, deterministic) -> float:
    return float(attn_dropout) if (attn_dropout > 0.0 and not deterministic
                                   and rng is not None) else 0.0


def _lut_fits_smem(layout, budget_bytes: int = 384 * 1024) -> bool:
    """The JAX package's test for the LUT kernels: every row and column
    of the layout keeps a block, and the flattened lookup tables fit its
    budget."""
    lay = np.asarray(layout) != 0
    if (lay.sum(-1) == 0).any() or (lay.sum(-2) == 0).any():
        return False
    H = lay.shape[0]
    nnz = int(lay.reshape(H, -1).sum(-1).max())
    return 4 * H * (6 * nnz + 2) <= budget_bytes


def _layout_to_mask(layout, seq_len: int, mask, device=None):
    """A block layout expanded to an additive ``[1, nH, S, S]`` fp32
    element mask (0 kept, -1e30 dropped), added to ``mask`` if given —
    the dense route's form of the layout."""
    keep = layout_element_mask(layout, seq_len, False, device)
    add = torch.where(keep[None], 0.0, NEG_INF).to(torch.float32)
    return add if mask is None else add + mask


def _dense_fallback(q, k, v, mask, causal, attn_dropout, rng, deterministic,
                    layout):
    """The JAX routing rule: an additive mask, a sequence that is not a
    multiple of 128 or a layout block that is not runs dense attention
    (with the layout as a mask). Returns None when the kernels apply."""
    S, nH = q.shape[1], q.shape[2]
    layout_block = None
    if layout is not None:
        shape = tuple(layout.shape)
        if len(shape) != 3 or shape[0] != nH or shape[1] != shape[2] or \
                S % shape[-1] != 0:
            raise ValueError(
                f"layout shape {shape} incompatible with {nH} heads / seq "
                f"{S}: need (num_heads, S//block, S//block)")
        layout_block = S // shape[-1]
    if mask is not None or S % 128 != 0 or \
            (layout_block is not None and layout_block % 128 != 0):
        from ..models.transformer import dense_attention
        if layout is not None:
            mask = _layout_to_mask(layout, S, mask, q.device)
        return dense_attention(q, k, v, mask=mask, causal=causal,
                               attn_dropout=attn_dropout, rng=rng,
                               deterministic=deterministic)
    return None


def _on_host(layout) -> bool:
    """Whether the host can read the layout without waiting for the card
    (the torch counterpart of a concrete, untraced JAX layout)."""
    return not (isinstance(layout, torch.Tensor) and
                layout.device.type != "cpu")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, causal: bool = False,
                    attn_dropout: float = 0.0,
                    rng: Optional[torch.Generator] = None,
                    deterministic: bool = True,
                    layout=None, heads=None) -> torch.Tensor:
    """Drop-in for ``models.transformer.dense_attention``: q, k, v
    ``[B, S, nH, D]`` → ``[B, S, nH, D]``. Attention dropout runs in the
    kernels from an int32 seed drawn from ``rng`` on the device.
    ``layout`` (``[nH, S//block, S//block]``) selects block-sparse
    attention, routed as the module docstring says. ``heads=(h0,
    nH_all)``: q holds heads ``h0..`` of ``nH_all`` (tensor
    parallelism), which the dropout hash indexes."""
    dense = _dense_fallback(q, k, v, mask, causal, attn_dropout, rng,
                            deterministic, layout)
    if dense is not None:
        return dense
    dropout = _dropout_rate(attn_dropout, rng, deterministic)
    seed = draw_seed(rng, q.device) if dropout > 0.0 else \
        torch.zeros((), dtype=torch.int32, device=q.device)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if layout is None:
        return flash(q, k, v, seed, scale, causal, dropout, heads)
    if _on_host(layout) and _lut_fits_smem(np.asarray(layout)):
        from .sparse_flash import sparse_flash_attention
        return sparse_flash_attention(q, k, v, np.asarray(layout),
                                      causal=causal, scale=scale, seed=seed,
                                      dropout=dropout)
    lay = _as_tensor(layout, q.device).to(torch.int32).contiguous()
    return flash_sparse(q, k, v, lay, seed, scale, causal, dropout)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          causal: bool = False, attn_dropout: float = 0.0,
                          rng: Optional[torch.Generator] = None,
                          deterministic: bool = True,
                          layout=None, heads=None) -> torch.Tensor:
    """``flash_attention`` with the same routing and the same seed draws,
    computed by ``flash_fwd_plain`` and differentiated by autograd — the
    plain reference for a training step through the kernels."""
    dense = _dense_fallback(q, k, v, mask, causal, attn_dropout, rng,
                            deterministic, layout)
    if dense is not None:
        return dense
    dropout = _dropout_rate(attn_dropout, rng, deterministic)
    seed = draw_seed(rng, q.device) if dropout > 0.0 else None
    return flash_fwd_plain(q, k, v, causal, 1.0 / math.sqrt(q.shape[-1]),
                           dropout, seed, layout, heads)[0]


def auto_attention(q, k, v, mask=None, causal=False, attn_dropout=0.0,
                   rng=None, deterministic=True, heads=None):
    """The flash kernels for CUDA tensors, plain dense attention for CPU
    tensors (the JAX function's per-backend choice)."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, mask=mask, causal=causal,
                               attn_dropout=attn_dropout, rng=rng,
                               deterministic=deterministic, heads=heads)
    from ..models.transformer import dense_attention
    return dense_attention(q, k, v, mask=mask, causal=causal,
                           attn_dropout=attn_dropout, rng=rng,
                           deterministic=deterministic)


__all__ = ["NEG_INF", "use_fused_bwd", "dropout_keep", "layout_element_mask",
           "flash_fwd_plain", "flash_bwd_plain", "flash_delta",
           "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_bwd_fused", "flash",
           "flash_sparse", "draw_seed", "flash_attention",
           "flash_attention_plain", "auto_attention"]
