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
