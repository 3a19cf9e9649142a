"""Paged attention over the KV block pool: decode attend does O(context)
work, not O(pool).

Port of ``deepspeed_tpu/ops/paged_attention.py``. The kernel is CUDA C++
in ``csrc/paged_attention.cu`` (replacing the Pallas ``_pattn_kernel``);
the note at the top of that file gives its bound and design. One kernel
serves paged decode (K = 1 query row per stream), speculative verify
(K = k + 1) and chunked prefill (K = chunk width): all K rows of a stream
share its block table, and ``positions[g, q, k]`` is each row's
inclusive last attendable position.

``paged_attention`` launches the kernel for CUDA tensors and runs
``paged_attention_plain`` — the same function written with a gather
through the table and a masked fp32 softmax — for CPU tensors. Its
calls are counted in ``paged_attention.launches`` (one per layer and
step). The kernel splits each stream's live table entries over
``paged_splits`` blocks (flash-decoding); with more than one split, one
call launches two kernels — the attention, writing fp32 partials to a
workspace the wrapper allocates, and the merge of the splits in split
order.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import op_builder
from . import costs

# Masking constant of the TPU kernel (deepspeed_tpu ops/flash_attention.py).
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (q, pool) dtype pairs the kernel is built for: the model's dtype
# throughout, or fp32 queries over a bf16 pool (kv_cache_dtype: bf16).
_DTYPE_PAIRS = {(torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16)}
# Blocks the split aims for: two per SM of an H100 (132 SMs).
TARGET_BLOCKS = 2 * 132
# Query rows one kernel block takes (one m16 tensor-core tile).
ROWS_PER_BLOCK = 16


def paged_splits(streams: int, num_heads: int, table_width: int,
                 rows: int) -> int:
    """How many blocks share one (stream, head, 16-row group)'s live
    table entries, from static shapes only: enough for about
    ``TARGET_BLOCKS`` blocks in all, at most one per table entry."""
    groups = streams * num_heads * -(-rows // ROWS_PER_BLOCK)
    return max(1, min(table_width, -(-TARGET_BLOCKS // groups)))


def paged_split_range(nlive: int, nsplit: int, i: int):
    """Table entries ``[b0, b1)`` of split ``i`` (the kernel's rule): an
    even share of the stream's ``nlive`` live entries, non-empty for
    every split whenever ``nlive >= nsplit``."""
    return i * nlive // nsplit, (i + 1) * nlive // nsplit


# --------------------------------------------------------------------- #
# Analytic attend cost model
# --------------------------------------------------------------------- #
def _attend_keys(block_size: int, context: Optional[int] = None,
                 pool_blocks: Optional[int] = None) -> int:
    """Key rows one attend touches: ``pool_blocks * bs`` for a
    pool-capacity pricing, ``ceil(context/bs) * bs`` for the kernel's
    live-context term (the stream's own blocks, final one padded)."""
    if (context is None) == (pool_blocks is None):
        raise ValueError("pass exactly one of context= / pool_blocks=")
    if pool_blocks is not None:
        return int(pool_blocks) * int(block_size)
    ctx = max(1, int(context))
    return -(-ctx // int(block_size)) * int(block_size)


def attend_flops_per_token(num_heads: int, head_dim: int, block_size: int,
                           *, context: Optional[int] = None,
                           pool_blocks: Optional[int] = None,
                           num_layers: int = 1) -> int:
    """Attend FLOPs to decode ONE token: 2*nH*D per key row for the
    QK^T scores plus the same for the PV combine."""
    keys = _attend_keys(block_size, context, pool_blocks)
    return 4 * int(num_heads) * int(head_dim) * keys * int(num_layers)


def attend_hbm_bytes_per_token(num_heads: int, head_dim: int,
                               block_size: int, *,
                               context: Optional[int] = None,
                               pool_blocks: Optional[int] = None,
                               kv_itemsize: int = 4,
                               num_layers: int = 1) -> int:
    """K+V bytes one decode attend streams: 2 planes of
    ``keys * nH * D`` elements per layer."""
    keys = _attend_keys(block_size, context, pool_blocks)
    return (2 * keys * int(num_heads) * int(head_dim)
            * int(kv_itemsize) * int(num_layers))


# --------------------------------------------------------------------- #
# Plain version
# --------------------------------------------------------------------- #
def live_block_counts(block_tables: torch.Tensor, positions: torch.Tensor,
                      block_size: int) -> torch.Tensor:
    """[G, Q] live table entries per stream: ``max(pos)//bs + 1``
    (clipped to the table width), 0 when the first entry is dead."""
    J = block_tables.shape[-1]
    top = positions.long().amax(-1)
    nblk = torch.where(top < 0, 0,
                       torch.div(top, block_size, rounding_mode="floor") + 1)
    nblk = nblk.clamp(max=J)
    return torch.where(block_tables[..., 0] < 0, 0, nblk)


def paged_attention_plain(q: torch.Tensor, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, block_tables: torch.Tensor,
                          positions: torch.Tensor, scale: float
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather each stream's J
    table blocks, mask keys past each row's position and keys of dead or
    non-live entries, softmax in fp32 with masked keys at exactly 0 and
    all-masked rows (dead streams) at exactly 0."""
    G, Q, K, nH, D = q.shape
    bs = pool_k.shape[3]
    J = block_tables.shape[-1]
    bt = block_tables.long()
    nlive = live_block_counts(bt, positions, bs)                 # [G, Q]
    jj = torch.arange(J, device=q.device)
    live = (bt >= 0) & (jj < nlive[..., None])                   # [G, Q, J]
    gi = torch.arange(G, device=q.device)[:, None, None]
    idx = bt.clamp(min=0)

    def gather(pool):                                            # [G,Q,nH,J*bs,D]
        t = pool[gi, idx].float()                                # [G,Q,J,nH,bs,D]
        # Blocks the kernel never reads (dead or past nlive) are zeroed,
        # so whatever they hold cannot reach the output.
        t = torch.where(live[..., None, None, None], t, 0.0)
        return t.permute(0, 1, 3, 2, 4, 5).reshape(G, Q, nH, J * bs, D)

    kk, vv = gather(pool_k), gather(pool_v)
    col = torch.arange(J * bs, device=q.device)
    allowed = (col <= positions.long()[..., None]) & \
        live.repeat_interleave(bs, dim=-1)[:, :, None, :]        # [G,Q,K,J*bs]
    allowed = allowed[:, :, :, None, :]                          # + heads
    s = torch.einsum("gqknd,gqntd->gqknt", q.float(), kk) * scale
    s = s.masked_fill(~allowed, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("gqknt,gqntd->gqknd", p, vv)
    return (o / torch.where(l == 0, 1.0, l)).to(q.dtype)


# --------------------------------------------------------------------- #
# Kernel launch
# --------------------------------------------------------------------- #
def _check_args(q, pool_k, pool_v, block_tables, positions) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    G, Q, K, nH, D = q.shape
    if pool_k.shape != pool_v.shape or pool_k.dim() != 5 or \
            pool_k.shape[0] != G or pool_k.shape[2] != nH or \
            pool_k.shape[4] != D:
        raise ValueError(f"paged_attention: pool {tuple(pool_k.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if block_tables.shape[:2] != (G, Q) or block_tables.dim() != 3 or \
            positions.shape != (G, Q, K):
        raise ValueError("paged_attention: block_tables must be [G, Q, J] "
                         "and positions [G, Q, K]")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {D} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("block_tables", block_tables),
                    ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
        if t.is_floating_point() and t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must be 16-byte "
                             "aligned")
    if (q.dtype, pool_k.dtype) not in _DTYPE_PAIRS or \
            pool_v.dtype != pool_k.dtype:
        raise TypeError(f"paged_attention: q {q.dtype}, pools "
                        f"{pool_k.dtype}/{pool_v.dtype} not supported")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and positions must "
                        "be int32")


@costs.declares("K10", costs.paged_attention_decl)
def paged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                    pool_v: torch.Tensor, block_tables: torch.Tensor,
                    positions: torch.Tensor, scale: float,
                    _splits: Optional[int] = None) -> torch.Tensor:
    """Table-driven paged attention over one layer's block pool.

    q:            [G, Q, K, nH, D] — Q streams per group, K query rows per
                  stream (1 decode / k+1 verify / chunk prefill).
    pool_k/v:     [G, B, nH, bs, D].
    block_tables: [G, Q, J] int32 group-local block ids (< 0 = dead).
    positions:    [G, Q, K] int32 inclusive last attendable position.

    ``_splits`` pins the split count (1 to the table width) in place of
    ``paged_splits``, for tests and probes. The split count is not a tile
    of the resolver (``ops/autotune.py``): the merge adds the splits'
    partials in another order at each count, so the bits depend on it.

    Returns [G, Q, K, nH, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, pool_k, pool_v, block_tables,
                                     positions, scale)
    _check_args(q, pool_k, pool_v, block_tables, positions)
    G, Q, K, nH, D = q.shape
    B, bs = pool_k.shape[1], pool_k.shape[3]
    J = block_tables.shape[-1]
    out = torch.empty_like(q)
    nsplit = paged_splits(G * Q, nH, J, K) if _splits is None else _splits
    if not 1 <= nsplit <= J:
        raise ValueError(f"paged_attention: _splits must be in [1, {J}], "
                         f"got {nsplit}")
    # Partials of the splits: m and l per (split, stream, head, row), then
    # the fp32 accumulator rows.
    ws = None if nsplit == 1 else torch.empty(
        nsplit * G * Q * nH * K * (D + 2), dtype=torch.float32,
        device=q.device)
    rc = op_builder.load().dstt_paged_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), G * Q, K, nH, D, G, B, bs, J,
        float(scale), _DTYPE_CODES[q.dtype], _DTYPE_CODES[pool_k.dtype],
        nsplit, op_builder.stream_ptr(q.device))
    op_builder.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


__all__ = ["paged_attention", "paged_attention_plain", "live_block_counts",
           "paged_splits", "paged_split_range",
           "attend_flops_per_token", "attend_hbm_bytes_per_token",
           "NEG_INF", "HEAD_DIMS"]
