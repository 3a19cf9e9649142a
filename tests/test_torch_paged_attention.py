"""The port's paged attention (deepspeed_tpu_torch/ops/paged_attention.py)
against the JAX package's Pallas kernel (interpret mode on the CPU) and
its one-hot baseline ``inference.kv_cache.paged_attend``.

Inputs come from numpy with a seed and go to both packages. Tolerances
are the JAX kernel tests' own (tests/test_paged_kernel.py): fp32 atol /
rtol 2e-5, bf16 pools 2e-2. The CUDA kernel against this plain version is
in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import kv_cache as jkv
from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu.ops.flash_attention import NEG_INF as JAX_NEG_INF
from deepspeed_tpu_torch.ops import paged_attention as tpa
from torch_cases import PAGED_CASES, paged_case

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _port(c, kv_dtype=torch.float32):
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    return tpa.paged_attention(t(c["q"]), t(c["k"]).to(kv_dtype),
                               t(c["v"]).to(kv_dtype), t(c["bt"]),
                               t(c["pos"]), c["scale"]).float().numpy()


def _jax_kernel(c, kv_dtype=jnp.float32):
    out = jpa.paged_attention(jnp.asarray(c["q"]),
                              jnp.asarray(c["k"], kv_dtype),
                              jnp.asarray(c["v"], kv_dtype),
                              jnp.asarray(c["bt"]), jnp.asarray(c["pos"]),
                              scale=c["scale"])
    return np.asarray(out, np.float32)


def _jax_onehot(c):
    J, bs = c["bt"].shape[2], c["k"].shape[3]
    bt = jnp.asarray(c["bt"])
    sel = jkv.block_select(bt, c["k"].shape[1])
    grid = jnp.arange(J * bs, dtype=jnp.int32)[None, None, None, :]
    pos_mask = grid <= jnp.asarray(c["pos"])[..., None]
    return np.asarray(jkv.paged_attend(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]), sel,
        pos_mask, c["scale"], JAX_NEG_INF))


@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_fp32_matches_jax_kernel_and_onehot(name):
    spec = dict(PAGED_CASES[name])
    c = paged_case(sum(map(ord, name)), **spec)
    out = _port(c)
    np.testing.assert_allclose(out, _jax_kernel(c), **F32_TOL)
    np.testing.assert_allclose(out, _jax_onehot(c), **F32_TOL)


def test_bf16_pool_matches_jax_kernel():
    c = paged_case(2, [[9, 18, 24, 2]])
    np.testing.assert_allclose(_port(c, torch.bfloat16),
                               _jax_kernel(c, jnp.bfloat16), **BF16_TOL)


def test_dead_streams_emit_exact_zeros():
    c = paged_case(4, [[11, 0, 0, 6]], K=4)
    out = _port(c)
    assert (out[0, 1] == 0.0).all() and (out[0, 2] == 0.0).all()
    assert np.abs(out[0, 0]).sum() > 0 and np.abs(out[0, 3]).sum() > 0


def test_masked_keys_contribute_nothing():
    # Garbage (inf/nan) in blocks the table does not name, and inf keys
    # past every row's position, must not reach the output: masked keys
    # get probability exactly 0, never exp(NEG_INF - m) of a bad score.
    c = paged_case(6, [[10, 3]], K=2)
    ref = _port(c)
    bs = c["k"].shape[3]
    used = set(c["bt"][c["bt"] >= 0].tolist())
    for a in (c["k"], c["v"]):
        for b in range(a.shape[1]):
            if b not in used:
                a[:, b] = np.nan
    blk, last = c["bt"][0, 0, 1], int(c["pos"][0, 0].max())
    c["k"][0, blk, :, last % bs + 1:] = np.inf
    out = _port(c)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, ref)


def test_live_block_counts_match_jax_rule():
    bt = np.array([[[3, 4, -1, -1], [-1, -1, -1, -1], [1, 2, 5, 6]]],
                  np.int32)
    pos = np.array([[[9], [4], [100]]], np.int32)
    n = tpa.live_block_counts(torch.from_numpy(bt), torch.from_numpy(pos), 8)
    assert n.tolist() == [[2, 0, 4]]


def _serving_shapes():
    """(streams, heads, table width, rows) of every paged-attention call
    the serving paths make: decode (K = 1) and verify (K = spec_k + 1)
    over max_slots streams, chunked prefill (K = the chunk) over one
    stream a group, for each GPT-2 config's heads, max_len and block
    size."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS
    heads = sorted({c.num_heads for c in GPT2_CONFIGS.values()})
    for max_len in (128, 256, 512, 1024, 2048):
        for bs in (2 ** i for i in range(12) if 2 ** i <= max_len):
            J = max_len // bs
            chunks = [c for c in (8, 16, 32, 64, 128, 256) if max_len % c == 0]
            for nH in heads:
                for slots in range(1, 65):
                    for K in [1] + [k + 1 for k in range(1, 9)]:
                        yield slots, nH, J, K
                for K in chunks:
                    yield 1, nH, J, K


def test_split_count_covers_every_serving_shape():
    """The kernel's split count (host side, static shapes only) is at
    least 1 and at most the table width, reaches the target block count
    unless the table is narrower, and its shares of the live entries
    (``paged_split_range``, the kernel's rule) tile [0, nlive) in order,
    each non-empty whenever nlive >= the split count."""
    seen = set()
    for shape in _serving_shapes():
        if shape in seen:
            continue
        seen.add(shape)
        GQ, nH, J, K = shape
        ns = tpa.paged_splits(GQ, nH, J, K)
        blocks = GQ * nH * -(-K // tpa.ROWS_PER_BLOCK)
        assert 1 <= ns <= J
        assert ns == J or ns * blocks >= tpa.TARGET_BLOCKS
        for nlive in {0, 1, ns, ns + 1, (ns + J) // 2, J}:
            if nlive > J:
                continue
            shares = [tpa.paged_split_range(nlive, ns, i) for i in range(ns)]
            assert shares[0][0] == 0 and shares[-1][1] == nlive
            assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
            if nlive >= ns:
                assert all(b1 > b0 for b0, b1 in shares)
    assert len(seen) > 1000
    # chip_smoke's cases and the serving smoke's decode: 3 splits at 8
    # streams of 12 heads, 11 for one 32-row chunk.
    assert tpa.paged_splits(8, 12, 64, 1) == 3
    assert tpa.paged_splits(8, 12, 64, 4) == 3
    assert tpa.paged_splits(1, 12, 64, 32) == 11


def test_cost_model_matches_jax():
    for kw in (dict(context=1), dict(context=17), dict(context=1024),
               dict(pool_blocks=64)):
        for fn in ("attend_flops_per_token", "attend_hbm_bytes_per_token"):
            assert getattr(tpa, fn)(12, 64, 16, num_layers=12, **kw) == \
                getattr(jpa, fn)(12, 64, 16, num_layers=12, **kw)
    with pytest.raises(ValueError, match="exactly one"):
        tpa.attend_flops_per_token(4, 16, 8)
