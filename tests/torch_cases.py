"""Inputs and tolerances shared by the PyTorch port's tests. Imports no
JAX, so the card-only tests (test_torch_cuda.py) can use it on a machine
without JAX."""
import math

import numpy as np

DEAD_BLOCK = -1


def paged_case(seed, lengths, *, K=1, nH=4, D=32, B=12, bs=8, J=4,
               shared_prefix_blocks=0):
    """A paged-attention case as numpy arrays, from per-stream context
    lengths ``lengths[g][q]`` (<= 0 = dead stream): row k of a stream
    attends through position ctx-1+k. ``shared_prefix_blocks`` gives every
    live stream of a group the same first blocks (the CoW-shared prefix
    layout)."""
    rng = np.random.default_rng(seed)
    G, Q = len(lengths), len(lengths[0])
    pool_k = rng.standard_normal((G, B, nH, bs, D)).astype(np.float32)
    pool_v = rng.standard_normal((G, B, nH, bs, D)).astype(np.float32)
    q = rng.standard_normal((G, Q, K, nH, D)).astype(np.float32)
    bt = np.full((G, Q, J), DEAD_BLOCK, np.int32)
    pos = np.zeros((G, Q, K), np.int32)
    for g in range(G):
        free = list(range(B))
        shared = [free.pop() for _ in range(shared_prefix_blocks)]
        for s in range(Q):
            ctx = lengths[g][s]
            if ctx <= 0:
                continue
            nblk = (ctx - 1 + K - 1) // bs + 1
            assert nblk <= J
            ids = shared[:nblk] + [free.pop() for _ in
                                   range(max(0, nblk - len(shared)))]
            bt[g, s, :nblk] = ids[:nblk]
            pos[g, s] = ctx - 1 + np.arange(K)
    return dict(q=q, k=pool_k, v=pool_v, bt=bt, pos=pos,
                scale=1.0 / math.sqrt(D))


PAGED_CASES = {
    # decode: block-boundary straddles, a one-token context, a dead
    # stream, and in group 0 the first block shared by every live stream
    "decode_ragged_cow": dict(lengths=[[16, 17, 13, 1], [25, 0, 8, 5]],
                              shared_prefix_blocks=1),
    # spec_k=3 verify: per-row causal offsets; the last row can reach a
    # block the earlier rows must not see
    "verify_k4": dict(lengths=[[7, 15, 21], [3, 12, 0]], K=4),
    # chunked prefill, 32 rows per stream (first chunk and a later one)
    "prefill_k32": dict(lengths=[[1, 9, 0]], K=32, B=20, J=8),
}


# Paged-attention cases that split each stream's live table entries over
# many kernel blocks (ops/paged_attention.paged_splits): contexts that
# straddle split boundaries, table widths the split count does not
# divide, streams whose live entries leave all splits but a few empty,
# dead streams, and rows given their own positions (``rows``: stream
# index -> positions) — a row of position -1 attends nothing, and a row
# at position 2 beside rows hundreds of keys on gets nothing from every
# split but the first.
PAGED_SPLIT_CASES = {
    # 44 splits over 50 entries: one stream fills the table, one lives in
    # 5 entries, one is dead
    "decode_splits": dict(lengths=[[400, 37, 0]], K=1, nH=2, B=60, bs=8,
                          J=50),
    # 21 splits over 21 entries, two groups, a dead stream
    "verify_splits": dict(lengths=[[161, 9], [0, 100]], K=4, nH=2, B=40,
                          bs=8, J=21, rows={0: [2, 150, -1, 163],
                                            1: [2, 150, -1, 151]}),
    # a 32-row chunk in two row groups over 19 splits of 16-key blocks
    "prefill_splits": dict(lengths=[[250]], K=32, nH=3, B=24, bs=16, J=19),
    # one entry live of 37: every split but one empty
    "one_live_entry": dict(lengths=[[3, 0, 5, 2]], K=1, nH=2, B=12, bs=16,
                           J=37),
}


def paged_split_case(seed, lengths, rows=None, **kw):
    """``paged_case`` with the positions of some streams' rows replaced:
    ``rows[s]`` (flat stream index over groups) gives that stream's K
    positions."""
    c = paged_case(seed, lengths, **kw)
    G, Q = c["bt"].shape[:2]
    for s, p in (rows or {}).items():
        c["pos"][s // Q, s % Q] = p
    return c


FRACTION_BITS = {"bf16": 7, "fp16": 10, "fp32": 23}


def ulps(a, b, dtype_name):
    """|a - b| in ulp of the larger magnitude in ``dtype_name``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-38)))
                  - FRACTION_BITS[dtype_name])
    return np.abs(a - b) / ulp


def assert_close(a, b, dtype_name):
    """fp32: atol = rtol = 1e-5. bf16 / fp16: |a - b| <= 2 ulp of the
    larger magnitude, floored at the fp32 tolerance — GELU's 1 + tanh(u)
    cancels for large negative inputs, where the outputs are tiny and two
    fp32 tanh implementations (~1e-7 absolute apart) are many bf16 ulp
    apart."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if dtype_name == "fp32":
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
        return
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30)))
                  - FRACTION_BITS[dtype_name])
    bad = np.abs(a - b) > np.maximum(2 * ulp, 1e-5)
    assert not bad.any(), f"{bad.sum()} elements beyond 2 {dtype_name} ulp"


def assert_column_sums_close(a, b, magnitudes):
    """Column sums of fp32 terms taken in two orders (a kernel's per-warp
    and per-block partials against one reduction): within 1e-5 plus
    2**-20 of the column's sum of |term| (``magnitudes``), the error of
    fp32 sums that grows with the number of rows summed."""
    a, b, m = (np.asarray(t, np.float64) for t in (a, b, magnitudes))
    bad = np.abs(a - b) > 1e-5 + 2.0 ** -20 * m
    assert not bad.any(), f"{bad.sum()} column sums beyond tolerance"


def ln_sum_magnitudes(s, dy, eps=1e-5):
    """Per column, the sums of |dy * xhat| and |dy| over the rows (numpy
    arrays [rows, H]): the magnitudes behind dscale and dbias."""
    s, dy = np.asarray(s, np.float64), np.asarray(dy, np.float64)
    c = s - s.mean(-1, keepdims=True)
    xhat = c / np.sqrt((c * c).mean(-1, keepdims=True) + eps)
    return np.abs(dy * xhat).sum(0), np.abs(dy).sum(0)


# Flag sets of the fused Adam step (K6) that the engine uses:
# (name, param dtype, cast dtype, kwargs of fused_adam_plain, scalars).
# scalars = [neg_lr, bc1, bc2, coeff, inv, skip, 0, 0].
ADAM_CASES = {
    "fp32_adamw_clip": ("float32", None, dict(
        wd=0.01, coupled=False, use_inv=False, use_coeff=True,
        one_pass=True, sr=False), [-1e-3, 0.271, 0.00299, 0.37, 1.0, 0.0]),
    "fp32_adam_coupled_clip": ("float32", None, dict(
        wd=0.01, coupled=True, use_inv=False, use_coeff=True,
        one_pass=True, sr=False), [-1e-3, 0.271, 0.00299, 0.37, 1.0, 0.0]),
    "fp16_inv_scale_skip": ("float32", "float16", dict(
        wd=0.01, coupled=False, use_inv=True, use_coeff=True,
        one_pass=True, sr=False),
        [-1e-3, 0.1, 0.001, 0.5, 2.0 ** -12, 1.0]),
    "fp16_inv_scale_taken": ("float32", "float16", dict(
        wd=0.0, coupled=False, use_inv=True, use_coeff=False,
        one_pass=True, sr=False),
        [-1e-3, 0.1, 0.001, 1.0, 2.0 ** -12, 0.0]),
    "bf16_cast_cache": ("float32", "bfloat16", dict(
        wd=0.01, coupled=False, use_inv=False, use_coeff=True,
        one_pass=True, sr=False), [-3e-4, 0.19, 0.001999, 0.9, 1.0, 0.0]),
    "master_free_sr": ("bfloat16", None, dict(
        wd=0.01, coupled=False, use_inv=False, use_coeff=True,
        one_pass=True, sr=True), [-1e-3, 0.271, 0.00299, 0.8, 1.0, 0.0]),
}
ADAM_SEED = (123456789, 4096)


def adam_case(name, n, seed=0):
    """numpy inputs of an ADAM_CASES flag set: g, p (fp32 values of the
    param dtype), m, v (v >= 0), scalars [8] fp32, seed [2] int32."""
    p_dt, _, _, sc = ADAM_CASES[name]
    rng = np.random.default_rng(seed)
    scale = 2.0 ** 12 if "fp16" in name else 1.0
    g = (rng.standard_normal(n) * 0.05 * scale).astype(np.float32)
    p = rng.standard_normal(n).astype(np.float32) * 0.2
    m = (rng.standard_normal(n) * 0.01).astype(np.float32)
    v = (rng.random(n) * 1e-4).astype(np.float32)
    scalars = np.array(sc + [0.0, 0.0], np.float32)
    return g, p, m, v, scalars, np.array(ADAM_SEED, np.int32)
