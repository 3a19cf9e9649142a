"""The port's grouped GEMM (``ops/grouped_gemm.py``, K9's plain version
on the CPU) against the JAX module: ``_grouped_matmul`` (the Pallas
kernel in interpret mode) and ``grouped_ffn`` with its custom VJP.

Inputs come from numpy seeds. The bf16/fp16 operands are dyadic
(multiples of 1/8 and 1/16 with small numerators), so every fp32 sum of
their products is exact in any order: the two sides' pre-activations
are equal before the epilogue rounds them, and a rounding-order flip of
the product cannot move a GELU output by more than its own slope.

Tolerances (tests/torch_cases.py): fp32 1e-5 (``grouped_ffn`` outputs
and gradients: 1e-5 of the leaf's largest magnitude); bf16/fp16 outputs
2 ulp floored at 1e-5; bf16 gradients 2^-7 of the leaf's largest
magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import grouped_gemm as jgg
from deepspeed_tpu_torch import ops
from deepspeed_tpu_torch.ops import grouped_gemm as tgg
from torch_cases import assert_close

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "fp16": (torch.float16, jnp.float16)}
ACTS = (None, "gelu_tanh", "gelu_exact")


def _operand(rng, shape, dtype_name, denom):
    """Gaussian for fp32; for 16-bit types small integers over ``denom``
    (exactly representable, exact fp32 sums)."""
    if dtype_name == "fp32":
        return rng.standard_normal(shape).astype(np.float32) * 8 / denom
    return (rng.integers(-8, 9, shape) / denom).astype(np.float32)


def _pair(x, dtype_name):
    tdt, jdt = DTYPES[dtype_name]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("M", [40, 64])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_grouped_matmul_matches_jax(dtype_name, act, M):
    """K and N not multiples of 128 (200, 136); with and without bias."""
    rng = np.random.default_rng(M + 7 * ACTS.index(act))
    E, K, N = 2, 200, 136
    a_t, a_j = _pair(_operand(rng, (E, M, K), dtype_name, 8), dtype_name)
    b_t, b_j = _pair(_operand(rng, (E, K, N), dtype_name, 16), dtype_name)
    bias = (rng.integers(-8, 9, (E, N)) / 4).astype(np.float32)
    for with_bias in (False, True):
        bt = torch.from_numpy(bias) if with_bias else None
        bj = jnp.asarray(bias) if with_bias else None
        got = tgg.grouped_matmul(a_t, b_t, bias=bt, act=act)
        want = jgg._grouped_matmul(a_j, b_j, bias=bj, act=act)
        assert got.dtype == a_t.dtype and got.shape == (E, M, N)
        assert_close(_np(got), _np(want), dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_grouped_matmul_swapped_operands_match_jax(dtype_name):
    """The backward's operand forms: a = x^T ([E, H, C] view) and b =
    w^T ([E, F, H] view), read through their strides."""
    rng = np.random.default_rng(3)
    E, C, H, F = 3, 40, 72, 96
    x = _operand(rng, (E, C, H), dtype_name, 8)
    w = _operand(rng, (E, F, H), dtype_name, 16)
    dz = _operand(rng, (E, C, F), dtype_name, 16)
    xt, xj = _pair(x, dtype_name)
    wt, wj = _pair(w, dtype_name)
    dzt, dzj = _pair(dz, dtype_name)
    for got, want in (
            (tgg.grouped_matmul(xt.transpose(1, 2), dzt),
             jgg._grouped_matmul(jgg._swap(xj), dzj)),
            (tgg.grouped_matmul(dzt, wt),
             jgg._grouped_matmul(dzj, wj)),
            (tgg.grouped_matmul(xt, wt.transpose(1, 2), act="gelu_tanh"),
             jgg._grouped_matmul(xj, jgg._swap(wj), act="gelu_tanh"))):
        assert_close(_np(got), _np(want), dtype_name)


def _ffn_inputs(dtype_name, seed, E=3, C=40, H=72, F=136):
    rng = np.random.default_rng(seed)
    arrs = [_operand(rng, (E, C, H), dtype_name, 8),
            _operand(rng, (E, H, F), dtype_name, 16),
            _operand(rng, (E, F), dtype_name, 8),
            _operand(rng, (E, F, H), dtype_name, 32),
            _operand(rng, (E, H), dtype_name, 8)]
    dy = _operand(rng, (E, C, H), dtype_name, 16)
    return arrs, dy


def _port_ffn(fn, arrs, dy, dtype_name, exact):
    tdt = DTYPES[dtype_name][0]
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrs]
    y = fn(*leaves, exact)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy).to(tdt))
    return y, grads


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_grouped_ffn_forward_and_grads_match_jax(dtype_name, exact):
    arrs, dy = _ffn_inputs(dtype_name, 11 + exact)
    jdt = DTYPES[dtype_name][1]
    jargs = [jnp.asarray(a).astype(jdt) for a in arrs]
    jy, vjp = jax.vjp(lambda *a: jgg.grouped_ffn(*a, exact), *jargs)
    jgrads = vjp(jnp.asarray(dy).astype(jdt))
    ops.reset_launch_counts()
    y, grads = _port_ffn(tgg.grouped_ffn, arrs, dy, dtype_name, exact)
    assert sum(ops.launch_counts().values()) == 0     # CPU: no kernels
    assert y.dtype == DTYPES[dtype_name][0]
    if dtype_name == "fp32":
        np.testing.assert_allclose(_np(y), _np(jy),
                                   atol=1e-5 * np.abs(_np(jy)).max(), rtol=0)
    else:
        assert_close(_np(y), _np(jy), dtype_name)
    tol = 1e-5 if dtype_name == "fp32" else 2.0 ** -7
    for g, jg in zip(grads, jgrads):
        assert g.dtype == DTYPES[dtype_name][0]
        jg = _np(jg)
        np.testing.assert_allclose(_np(g), jg, atol=tol * np.abs(jg).max(),
                                   rtol=0)


@pytest.mark.parametrize("exact", [False, True])
def test_grouped_ffn_backward_matches_plain_autograd(exact):
    """The hand-written backward (recompute, five grouped GEMMs) against
    autograd through ``grouped_ffn_plain`` (fp32)."""
    arrs, dy = _ffn_inputs("fp32", 5)
    y, grads = _port_ffn(tgg.grouped_ffn, arrs, dy, "fp32", exact)
    yp, gp = _port_ffn(tgg.grouped_ffn_plain, arrs, dy, "fp32", exact)
    torch.testing.assert_close(y, yp, rtol=0, atol=0)
    for g, p in zip(grads, gp):
        np.testing.assert_allclose(_np(g), _np(p),
                                   atol=1e-5 * np.abs(_np(p)).max(), rtol=0)


def test_check_grouped_gemm():
    """Every ds_config value runs the grouped FFN, except False on a CUDA
    device (no plain path on the card); other values raise."""
    for flag in (True, False, "auto"):
        tgg.check_grouped_gemm(flag, "cpu")
    for flag in (True, "auto"):
        tgg.check_grouped_gemm(flag, "cuda")
    with pytest.raises(NotImplementedError, match="no CUDA path"):
        tgg.check_grouped_gemm(False, "cuda")
    with pytest.raises(ValueError, match="grouped_gemm"):
        tgg.check_grouped_gemm("sometimes", "cpu")


def test_grouped_matmul_rejects_bad_operands():
    a = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="act"):
        tgg.grouped_matmul(a, torch.zeros(2, 16, 4), act="relu")
    with pytest.raises(ValueError, match=r"\[E, K, N\]"):
        tgg.grouped_matmul(a, torch.zeros(2, 8, 4))
    with pytest.raises(ValueError, match="bias"):
        tgg.grouped_matmul(a, torch.zeros(2, 16, 4), bias=torch.zeros(4))


# ------------------------------------------------------------------ #
# The card route (``_gg_plan``): read from shapes, strides and base
# addresses alone, so it is held here on meta and CPU tensors.
# ------------------------------------------------------------------ #
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _sw(t):
    return t.transpose(1, 2)


# The seven K9 launches of one MoE layer and micro-batch on the card's
# path (8 experts, capacity 2560, hidden 768, FFN 3072): (a, b) as the
# forward and grouped_ffn's backward hand them over, and the plan each
# must get: (a major, b major, BN).
def _moe_cases(dtype=torch.bfloat16):
    E, C, H, F = 8, 2560, 768, 3072
    x, w1, h = _meta(E, C, H, dtype=dtype), _meta(E, H, F, dtype=dtype), \
        _meta(E, C, F, dtype=dtype)
    w2, dy, dz = _meta(E, F, H, dtype=dtype), _meta(E, C, H, dtype=dtype), \
        _meta(E, C, F, dtype=dtype)
    return {"fwd_up": (x, w1, "gelu_tanh", ("K", "N", 128)),
            "fwd_down": (h, w2, None, ("K", "N", 256)),
            "bwd_z1": (x, w1, None, ("K", "N", 256)),
            "bwd_dh": (dy, _sw(w2), None, ("K", "K", 256)),
            "bwd_dw2": (_sw(h), dy, None, ("M", "N", 256)),
            "bwd_dw1": (_sw(x), dz, None, ("M", "N", 256)),
            "bwd_dx": (dz, _sw(w1), None, ("K", "K", 256))}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(_moe_cases()))
def test_gg_plan_at_the_moe_path_shapes(case, dtype):
    """Every launch of the MoE path reads its operands in place (the
    backward's transposed views by the kernel's other major) with the
    tile rule's BN, and stages nothing."""
    a, b, act, (am, bm, bn) = _moe_cases(dtype)[case]
    plan = tgg._gg_plan(a, b, act)
    assert plan == tgg.GGPlan("wgmma", am, bm, (128, bn), ())


def _views(E, M, K, N, dtype=torch.bfloat16):
    """The operand forms of tests/test_torch_cuda.py's K9 card test on
    small CPU tensors: contiguous, transposed (the other dim at stride
    1), a K stride of 2, and a base 2 bytes off alignment."""
    a = torch.zeros(E, M, K, dtype=dtype)
    b = torch.zeros(E, K, N, dtype=dtype)
    at = a.transpose(1, 2).contiguous().transpose(1, 2)
    bt = b.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.zeros(E, M, 2 * K, dtype=dtype)[..., ::2]
    off = torch.zeros(E, M, K + 1, dtype=dtype)[..., 1:]
    return {"a": a, "b": b, "at": at, "bt": bt, "wide": wide, "off": off}


# (shape, a form, b form) -> (a major, b major, staged). Rows of 2 * K or
# 2 * N bytes must be multiples of 16: K 200, 96, 264 and N 136, 520 are;
# N 300 (600 bytes) is not, and neither is M 260 or 300 as the stride of
# a transposed a.
STAGING = [
    ((3, 40, 200, 136), "a", "b", ("K", "N", ())),
    ((3, 40, 200, 136), "at", "b", ("M", "N", ())),
    ((3, 40, 200, 136), "a", "bt", ("K", "K", ())),
    ((3, 40, 200, 136), "at", "bt", ("M", "K", ())),
    ((3, 40, 200, 136), "wide", "b", ("K", "N", ("a",))),
    ((3, 40, 200, 136), "off", "b", ("K", "N", ("a",))),
    ((2, 260, 96, 300), "a", "b", ("K", "N", ("b",))),
    ((2, 260, 96, 300), "at", "b", ("K", "N", ("a", "b"))),
    ((2, 260, 96, 300), "a", "bt", ("K", "K", ())),
    ((2, 260, 96, 300), "off", "bt", ("K", "K", ("a",))),
    ((2, 300, 264, 520), "a", "b", ("K", "N", ())),
    ((2, 300, 264, 520), "at", "bt", ("K", "K", ("a",))),
    ((2, 300, 264, 520), "wide", "bt", ("K", "K", ("a",))),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("i", range(len(STAGING)))
def test_gg_plan_stages_exactly_what_tma_cannot_read(i, dtype):
    shape, fa, fb, (am, bm, staged) = STAGING[i]
    v = _views(*shape, dtype=dtype)
    plan = tgg._gg_plan(v[fa], v[fb])
    assert (plan.route, plan.a_major, plan.b_major, plan.staged) == \
        ("wgmma", am, bm, staged)
    # staging lays a out K-major and b N-major with 16-byte rows, which
    # the plan then reads with no copy
    a2 = tgg._stage(v[fa]) if "a" in staged else v[fa]
    b2 = tgg._stage(v[fb]) if "b" in staged else v[fb]
    assert tgg._gg_plan(a2, b2).staged == ()
    assert torch.equal(a2, v[fa]) and torch.equal(b2, v[fb])


def test_gg_plan_ignores_the_stride_of_a_dim_of_one():
    """A dim of size 1 is never stepped along, so its stride does not
    stage the operand; the same stride on two experts does (54 bytes)."""
    b = torch.zeros(1, 16, 8, dtype=torch.bfloat16)
    base = torch.zeros(1000, dtype=torch.bfloat16)
    one = base.as_strided((1, 3, 8), (27, 8, 1))
    two = base.as_strided((2, 3, 8), (27, 8, 1))
    assert tgg._gg_plan(one, b[:, :8]).staged == ()
    assert tgg._gg_plan(two, torch.zeros(2, 8, 8,
                                         dtype=torch.bfloat16)).staged == \
        ("a",)


def test_gg_plan_fp32_reads_any_strides():
    """fp32 takes the SIMT kernel, which reads through any strides."""
    v = _views(2, 260, 96, 300, dtype=torch.float32)
    plan = tgg._gg_plan(v["wide"], v["bt"])
    assert plan == tgg.GGPlan("simt", "K", "K", tgg.GG_F32_TILE, ())


@pytest.mark.parametrize("E, M, N, act, bn", [
    (8, 2560, 3072, "gelu_tanh", 128),  # up-projection: GELU epilogue
    (8, 2560, 3072, "gelu_exact", 128),
    (8, 2560, 3072, None, 256),    # recompute: 1920 vs 3840 tiles, 15 waves
    (8, 2560, 768, None, 256),     # down-projection: 4 waves either way
    (8, 3072, 768, None, 256),     # dw2: 5 waves either way
    (3, 40, 136, None, 256),       # one wave either way: a tie
    (8, 2560, 300, None, 128),     # 2 waves at 128, 3 at 256
])
def test_gg_tile_rule(E, M, N, act, bn):
    assert tgg._gg_tile(E, M, N, act, 132) == bn
