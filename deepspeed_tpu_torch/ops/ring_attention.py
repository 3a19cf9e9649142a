"""Ring attention: exact attention with the sequence split over the
``seq`` axis of the grid (port of ``deepspeed_tpu/ops/ring_attention.py``).

q, k and v are the whole ``[B, S, nH, dH]`` on each sequence rank, as
the JAX function's global arrays are. Rank r of sp takes its query chunk
``[r*S/sp, (r+1)*S/sp)`` and its own k/v chunk, and runs sp hops: at hop
i it holds the k/v chunk of rank ``r - i`` (each hop sends the chunk it
holds to the next rank and receives the previous rank's,
``comm.ring_exchange``). A chunk from an earlier position runs the flash
forward (K1) bidirectionally, the diagonal chunk runs K1 causal, and a
later chunk is skipped under causal attention; each chunk's ``(o, lse)``
merges into the running pair in fp32 by the online-softmax rule. (JAX
masks each element by its global position instead; a future chunk adds
exactly zero there, so both compute the same function.)

The backward is a second ring: each hop runs the fused flash backward
(K2c) on the local q, the visiting k/v chunk, the merged ``o`` and
``lse``, ``do`` and ``delta = rowsum(do·o)``; the chunk's dk/dv
accumulate in fp32 as they travel with it and come home after sp hops.
The output and the grads are all-gathered over the sequence group, so
the block outside attention stays replicated over sp, as JAX's is. On
the CPU each chunk runs the flash functions' plain versions.

JAX's refusals are kept: an additive mask, attention dropout in
training mode, and a sequence that sp does not divide. At sp 1 it is
``dense_attention``, as in JAX.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional

import torch

from ..parallel import comm
from ..parallel.topology import SP_AXIS
from .flash_attention import (flash_attention_bwd_fused, flash_attention_fwd,
                              flash_delta)


def _sp(mesh: Any, axis_name: str) -> int:
    return int(mesh.shape.get(axis_name, 1))


def _chunk(x: torch.Tensor, r: int, n: int) -> torch.Tensor:
    c = x.shape[1] // n
    return x[:, r * c:(r + 1) * c].contiguous()


def _runs(c: int, r: int, causal: bool) -> Optional[bool]:
    """Whether k/v chunk c runs against query chunk r: None (skipped,
    a later chunk under causal attention), else the kernel's causal
    flag (the diagonal chunk)."""
    if not causal:
        return False
    if c > r:
        return None
    return c == r


def _merge(o: Optional[torch.Tensor], lse: Optional[torch.Tensor],
           o2: torch.Tensor, lse2: torch.Tensor):
    """The online-softmax merge of two partial ``(o [B, Sq, nH, D] fp32,
    lse [B*nH, Sq] fp32)`` pairs."""
    if o is None:
        return o2.float(), lse2
    new = torch.logaddexp(lse, lse2)
    B, Sq, nH, _ = o.shape

    def w(x):           # [B*nH, Sq] -> [B, Sq, nH, 1]
        return torch.exp(x - new).view(B, nH, Sq).transpose(1, 2)[..., None]

    return o * w(lse) + o2.float() * w(lse2), new


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, group, n, r):
        scale = 1.0 / math.sqrt(q.shape[-1])
        ql = _chunk(q, r, n)
        kc, vc = _chunk(k, r, n), _chunk(v, r, n)
        own_k, own_v = kc, vc
        o = lse = None
        for i in range(n):
            c = (r - i) % n
            mode = _runs(c, r, causal)
            if mode is not None:
                oi, li = flash_attention_fwd(ql, kc, vc, mode, scale)
                o, lse = _merge(o, lse, oi, li)
            if i < n - 1:
                kc, vc = comm.ring_exchange([kc, vc], group)
        ol = o.to(q.dtype)
        ctx.save_for_backward(ql, own_k, own_v, ol, lse)
        ctx.cfg = (causal, group, n, r, scale)
        return comm.all_gather_dim(ol, 1, group)

    @staticmethod
    def backward(ctx, do):
        ql, kc, vc, ol, lse = ctx.saved_tensors
        causal, group, n, r, scale = ctx.cfg
        dol = _chunk(do, r, n)
        delta = flash_delta(dol, ol)
        dq = torch.zeros(ql.shape, dtype=torch.float32, device=ql.device)
        dk = torch.zeros(kc.shape, dtype=torch.float32, device=kc.device)
        dv = torch.zeros_like(dk)
        for i in range(n):
            c = (r - i) % n
            mode = _runs(c, r, causal)
            if mode is not None:
                gq, gk, gv = flash_attention_bwd_fused(
                    ql, kc, vc, dol, lse, delta, mode, scale)
                dq += gq.float()
                dk += gk.float()
                dv += gv.float()
            # (the last hop carries the grads home; the chunk stays)
            if i < n - 1:
                kc, vc, dk, dv = comm.ring_exchange([kc, vc, dk, dv], group)
            else:
                dk, dv = comm.ring_exchange([dk, dv], group)

        def whole(x):
            return comm.all_gather_dim(x.to(ql.dtype), 1, group)
        return whole(dq), whole(dk), whole(dv), None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Any, causal: bool = False,
                   axis_name: str = SP_AXIS) -> torch.Tensor:
    """Exact attention with the sequence split over the grid's sequence
    axis. q, k, v: the whole ``[B, S, nH, dH]`` on every sequence rank;
    returns the whole ``[B, S, nH, dH]`` (module docstring)."""
    sp = _sp(mesh, axis_name)
    S = q.shape[1]
    if sp <= 1:
        from ..models.transformer import dense_attention
        return dense_attention(q, k, v, mask=None, causal=causal)
    if S % sp != 0:
        raise ValueError(f"sequence {S} not divisible by seq axis {sp}")
    return _Ring.apply(q, k, v, bool(causal), mesh.sp_group, sp,
                       int(mesh.seq_parallel_id))


def ring_attention_fn(mesh: Any, axis_name: str = SP_AXIS):
    """The ``attention_fn`` of ``models/transformer.py`` over the ring."""
    def attn(q, k, v, mask=None, causal=False, attn_dropout=0.0, rng=None,
             deterministic=True):
        if mask is not None or (attn_dropout > 0.0 and not deterministic):
            raise NotImplementedError(
                "ring attention supports causal/bidirectional without "
                "additive masks or attention dropout (match the reference "
                "posture: dropout lives outside the sp path)")
        return ring_attention(q, k, v, mesh, causal=causal,
                              axis_name=axis_name)
    attn.mesh = mesh
    return attn


def ring_launches(sp: int, causal: bool) -> List[int]:
    """K1 launches (and K2c launches) of one ring attention call on each
    sequence rank: every chunk bidirectionally, or under causal
    attention the chunks at or before the rank's."""
    return [sp if not causal else r + 1 for r in range(sp)]


__all__ = ["ring_attention", "ring_attention_fn", "ring_launches"]
