"""The port's flash attention (deepspeed_tpu_torch/ops/flash_attention.py)
against the JAX package's, on the CPU: the JAX side runs the Pallas
kernels in interpret mode (``_flash`` and its VJP, ``_flash_fwd`` for the
logsumexp), the port its plain versions through the same autograd
Function the card runs. Inputs are numpy arrays from a seed; both sides
get the same int32 dropout seed.

Tolerances:
- the dropout keep mask is bit-equal to ``_dropout_keep``, in both
  orientations;
- fp32: o, dq, dk, dv within 1e-5 of the largest magnitude of each
  (measured: at most 9.2e-7), lse within 1e-5 absolute (measured 9.6e-7);
- bf16: o, dq, dk, dv within 2**-7 of the largest magnitude — 2 bf16 ulp
  of it — (measured: at most 4.0e-3; the JAX forward at S=384 is the
  online softmax over 128-blocks, the port's plain version the whole-row
  formula, so p rounds to bf16 at different running maxima), lse within
  1e-5.
S = 128 takes the fused backward (K2c) on both sides, S = 384 the split
dq + dk/dv kernels (K2a/K2b) with 128-blocks on the JAX side; head dim
32 in every combination, and 64 (the training width) in the causal ones.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import flash_attention as jf
from deepspeed_tpu_torch import ops
from deepspeed_tpu_torch.models.transformer import dense_attention
from deepspeed_tpu_torch.ops import flash_attention as tf

B, NH = 1, 2
SEED = -987654321
REL_TOL = {"fp32": 1e-5, "bf16": 2.0 ** -7}
LSE_TOL = 1e-5
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("seed, bh, qi, kj", [
    (0, 0, 0, 0), (-123456789, 5, 1, 2), (2 ** 31 - 1, 95, 7, 3),
    (-(2 ** 31), 11, 0, 5)])
def test_dropout_keep_bit_equal_jax(seed, bh, qi, kj, transposed):
    for rate in (0.1, 0.5):
        want = np.asarray(jf._dropout_keep(
            jnp.int32(seed), jnp.int32(bh), qi, kj, 128, 64, rate,
            transposed=transposed))
        got = tf.dropout_keep(seed, bh, qi, kj, 128, 64, rate,
                              transposed=transposed).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0.02 < 1 - got.mean() < 0.7


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5, 1e-7, 0.123456789,
                                  0.9999999])
def test_integer_keep_threshold_is_the_float_test(rate):
    """The kernels keep an element iff (x >> 8) >= ceil(rate * 2**24) in
    fp32 (csrc/flash_tiles.cuh keep_threshold); for every 24-bit value
    that is the JAX test (x >> 8) * 2**-24 >= float32(rate)."""
    m = np.arange(2 ** 24, dtype=np.int64)
    r = np.float32(rate)
    u = m.astype(np.float32) * np.float32(1.0 / 16777216.0)
    threshold = int(np.ceil(r * np.float32(16777216.0)))
    np.testing.assert_array_equal(m >= threshold, u >= r)


def test_full_grid_mask_is_the_tiles_mask():
    """The plain versions' whole-grid mask equals the per-tile masks the
    kernels regenerate, head by head."""
    grid = tf._keep_grid(torch.tensor(SEED, dtype=torch.int32), 3, 256, 256,
                         0.1, torch.device("cpu"))
    for bh in range(3):
        tile = tf.dropout_keep(SEED, bh, 1, 3, 128, 64, 0.1)
        assert torch.equal(grid[bh, 128:256, 192:256], tile)


def _jax_flash(q, k, v, do, S, causal, drop, dt):
    D = q.shape[-1]

    def bh(x):
        return jnp.asarray(x, JDT[dt]).transpose(0, 2, 1, 3).reshape(
            B * NH, S, D)
    scale = 1.0 / math.sqrt(D)
    o, vjp = jax.vjp(
        lambda a, b, c: jf._flash(a, b, c, jnp.int32(SEED), scale, causal,
                                  drop), bh(q), bh(k), bh(v))
    grads = vjp(bh(do))
    _, lse = jf._flash_fwd(bh(q), bh(k), bh(v), None, scale, causal, drop,
                           jnp.int32(SEED))

    def back(x):
        return np.asarray(x.astype(jnp.float32)).reshape(
            B, NH, S, D).transpose(0, 2, 1, 3)
    return [back(o)] + [back(g) for g in grads], np.asarray(lse)[:, 0]


# (S, causal, dropout, dtype, head_dim): every combination at head dim 32,
# and the causal ones at the training width, 64.
_JAX_CASES = [
    pytest.param(S, causal, drop, dt, 32, id=f"{S}-{causal}-{drop}-{dt}")
    for dt in ("fp32", "bf16") for drop in (0.0, 0.1)
    for causal in (True, False) for S in (128, 384)] + [
    pytest.param(S, True, drop, dt, 64, id=f"{S}-True-{drop}-{dt}-d64")
    for dt in ("fp32", "bf16") for drop in (0.0, 0.1) for S in (128, 384)]


@pytest.mark.parametrize("S, causal, drop, dt, D", _JAX_CASES)
def test_flash_forward_and_grads_match_jax(S, causal, drop, dt, D):
    rng = np.random.default_rng(S + causal)
    q, k, v, do = (rng.standard_normal((B, S, NH, D)).astype(np.float32)
                   for _ in range(4))
    want, want_lse = _jax_flash(q, k, v, do, S, causal, drop, dt)
    leaves = [torch.from_numpy(x).to(TDT[dt]).requires_grad_()
              for x in (q, k, v)]
    seed = torch.tensor(SEED, dtype=torch.int32)
    scale = 1.0 / math.sqrt(D)
    o = tf.flash(*leaves, seed, scale, causal, drop)
    o.backward(torch.from_numpy(do).to(TDT[dt]))
    _, lse = tf.flash_fwd_plain(*leaves, causal, scale, drop, seed)
    assert tf.use_fused_bwd(S, S) == (S == 128)
    assert sum(ops.launch_counts().values()) == 0     # CPU: no kernels
    got = [o.detach()] + [t.grad for t in leaves]
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.dtype == TDT[dt]
        err = np.abs(a.float().numpy() - b).max() / np.abs(b).max()
        assert err <= REL_TOL[dt], (name, err)
    np.testing.assert_allclose(lse.detach().numpy(), want_lse, atol=LSE_TOL,
                               rtol=0)


def test_routing_matches_jax_rules():
    """Dense fallback for a mask or S % 128 != 0, and the fused-or-split
    backward rule."""
    for S, fused in ((128, True), (256, True), (384, False), (512, True),
                     (768, False), (1024, True), (2048, False)):
        assert tf.use_fused_bwd(S, S) == fused
        assert tf._pick_block(S) == jf._pick_block(S)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 96, 2, 32)).astype(
        np.float32)) for _ in range(3))
    for fn in (tf.flash_attention, tf.flash_attention_plain,
               tf.auto_attention):
        torch.testing.assert_close(fn(q, k, v, causal=True),
                                   dense_attention(q, k, v, causal=True),
                                   rtol=0, atol=0)


def test_flash_attention_draws_its_seed_from_the_generator():
    """Dropout on: the seed is one int32 draw from ``rng`` (the plain
    reference draws the same one), so kernel path and plain path see the
    same masks; deterministic calls draw nothing."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 2, 32)).astype(
        np.float32)) for _ in range(3))
    outs = []
    for fn in (tf.flash_attention, tf.flash_attention_plain):
        g = torch.Generator().manual_seed(5)
        outs.append(fn(q, k, v, causal=True, attn_dropout=0.1, rng=g,
                       deterministic=False))
        outs.append(torch.rand((), generator=g))
    torch.testing.assert_close(outs[0], outs[2], rtol=0, atol=0)
    assert float(outs[1]) == float(outs[3])
    g = torch.Generator().manual_seed(5)
    det = tf.flash_attention(q, k, v, causal=True, attn_dropout=0.1, rng=g)
    assert float(torch.rand((), generator=g)) == \
        float(torch.rand((), generator=torch.Generator().manual_seed(5)))
    torch.testing.assert_close(det, dense_attention(q, k, v, causal=True),
                               rtol=1e-5, atol=1e-6)
