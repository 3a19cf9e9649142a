"""The port's training kernels' plain versions against the JAX Pallas
kernels (interpret mode on the CPU), called directly: LayerNorm backward
(K3b, ``_ln_backward``), bias+GELU backward (K4b, ``_fbg_bwd_impl``),
the grad sum of squares (K5, ``_run_sqnorm``) and the fused Adam pass
(K6, ``_run_group``), plus ``torch.autograd.gradcheck`` of the port's
differentiable ops in fp64.

Tolerances: K3b/K4b fp32 dx within 1e-5 relative, bf16 within 2 bf16
ulp floored at 1e-5, dscale/dbias within 1e-5 relative; K5 relative
1e-6; K6 params and moments within 4 fp32 ulp of the larger operand of
their last add. The JAX kernel's own cross-program contract is 2 ulp:
XLA may contract ``a*b + c`` into an FMA, which rounds once where the
port's op-by-op form rounds twice; where two terms cancel, that one
rounding is many ulp of the small result, hence ulp of the operand; and
the coupled decay ``g + wd*p`` and the update ``u`` carry one such
rounding each into the last add (measured at most 3, ROADMAP §3). A
forced skip leaves them bit-equal, the cast copy within 1 ulp of its
dtype, the stochastic rounding equal to JAX's on >= 99.9% of elements
and within 1 bf16 ulp everywhere. The CUDA kernels against these plain
versions are in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import fused_elementwise as jfe
from deepspeed_tpu.ops import fused_update as jfu
from deepspeed_tpu_torch.ops import fused_elementwise as tfe
from deepspeed_tpu_torch.ops import fused_update as tfu
from torch_cases import ADAM_CASES, adam_case, assert_close, ulps

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "fp16": (torch.float16, jnp.float16)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    H = shape[-1]
    return ((rng.standard_normal(shape) * 2 + 0.5).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            (1 + 0.1 * rng.standard_normal(H)).astype(np.float32))


@pytest.mark.parametrize("gs", [False, True])
@pytest.mark.parametrize("H", [128, 200, 768])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_layer_norm_backward_matches_jax(dtype_name, H, gs):
    tdt, jdt = DTYPES[dtype_name]
    s, dy, res, scale = _inputs(H + gs, (2, 5, H))
    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    j = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    dx, dsc, dbi = tfe.layer_norm_backward(t(s), torch.from_numpy(scale),
                                           t(dy), t(res) if gs else None)
    jdx, jdsc, jdbi = jfe._ln_backward(j(s), jnp.asarray(scale), j(dy),
                                       j(res) if gs else None, 1e-5)
    assert dx.dtype == tdt and dx.shape == (2, 5, H)
    assert_close(_np(dx), _np(jdx), dtype_name)
    for a, b in ((dsc, jdsc), (dbi, jdbi)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("F", [128, 200, 3072])
@pytest.mark.parametrize(
    "dtype_name, exact", [("fp32", False), ("bf16", False), ("fp32", True),
                          ("bf16", True)],
    ids=["fp32", "bf16", "fp32-exact", "bf16-exact"])
def test_bias_gelu_backward_matches_jax(dtype_name, exact, F):
    """Both GELU forms; the erf form's fp32 dz within 2e-6 (XLA's fp32
    erf and exp against torch's, see test_torch_fused_elementwise.py)."""
    tdt, jdt = DTYPES[dtype_name]
    rng = np.random.default_rng(F)
    y = (rng.standard_normal((6, F)) * 3).astype(np.float32)
    b = rng.standard_normal(F).astype(np.float32)
    g = rng.standard_normal((6, F)).astype(np.float32)
    dz, db = tfe.bias_gelu_backward(torch.from_numpy(y).to(tdt),
                                    torch.from_numpy(b),
                                    torch.from_numpy(g).to(tdt), exact)
    jdz, jdb = jfe._fbg_bwd_impl(jnp.asarray(y, jdt), jnp.asarray(b),
                                 jnp.asarray(g, jdt), exact)
    assert dz.dtype == tdt
    if exact and dtype_name == "fp32":
        np.testing.assert_allclose(_np(dz), _np(jdz), atol=2e-6, rtol=0)
    else:
        assert_close(_np(dz), _np(jdz), dtype_name)
    np.testing.assert_allclose(_np(db), _np(jdb), rtol=1e-5, atol=1e-5)


def _gradcheck(fn, *shapes, seed=0):
    gen = torch.Generator().manual_seed(seed)
    args = [torch.randn(s, generator=gen, dtype=torch.float64,
                        requires_grad=True) for s in shapes]
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-7)


@pytest.mark.parametrize("op", ["layer_norm", "residual_layer_norm",
                                "bias_gelu", "bias_gelu_exact"])
def test_autograd_functions_pass_gradcheck_fp64(op):
    if op == "layer_norm":
        _gradcheck(lambda x, s, b: tfe.fused_layer_norm(x, s, b),
                   (3, 4, 8), (8,), (8,))
    elif op == "residual_layer_norm":
        _gradcheck(lambda x, d, s, b: tfe.fused_residual_layer_norm(
            x, d, s, b), (3, 8), (3, 8), (8,), (8,))
    else:
        exact = op == "bias_gelu_exact"
        _gradcheck(lambda y, b: tfe.fused_bias_gelu(y, b, exact), (3, 4, 8),
                   (8,))


def test_residual_layer_norm_gives_both_inputs_one_cotangent():
    x, d = torch.randn(4, 16, requires_grad=True), \
        torch.randn(4, 16, requires_grad=True)
    s, y = tfe.fused_residual_layer_norm(x, d, torch.ones(16),
                                         torch.zeros(16))
    (s.sum() * 0.5 + (y * y).sum()).backward()
    assert torch.equal(x.grad, d.grad)


def _flat(seed, rows=16):
    """A flat fp32 group buffer of rows * 1024 elements (the JAX kernel's
    [rows, 1024] geometry) with a zero tail, as padded buffers have."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(rows * 1024) * 0.3).astype(np.float32)
    g[-777:] = 0.0
    return g


def test_sqnorm_matches_jax():
    g = _flat(7)
    got = float(tfu.sqnorm(torch.from_numpy(g)))
    want = float(jfu._run_sqnorm(jnp.asarray(g)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    g[5] = np.inf
    assert not np.isfinite(float(tfu.sqnorm(torch.from_numpy(g))))


def _ulps_of_operands(a, b, t1, t2):
    """max |a - b| in fp32 ulp of max(|a|, |b|, |t1|, |t2|)."""
    mag = np.maximum.reduce([np.abs(a), np.abs(b), np.abs(t1), np.abs(t2)])
    return float(ulps(mag + np.abs(a - b), mag, "fp32").max())


@pytest.mark.parametrize("name", sorted(ADAM_CASES))
def test_fused_adam_matches_jax_run_group(name):
    p_dt, c_dt, kw, _ = ADAM_CASES[name]
    g, p, m, v, scalars, seed = adam_case(name, 16 * 1024, seed=11)
    tp_dt = getattr(torch, p_dt)
    jp_dt = getattr(jnp, p_dt)
    tc_dt = None if c_dt is None else getattr(torch, c_dt)
    T = torch.from_numpy
    p_t = T(p).to(tp_dt)
    pn, mn, vn, cn = tfu.fused_adam_plain(
        T(g), p_t, T(m), T(v), T(scalars), T(seed), b1=0.9, b2=0.999,
        eps=1e-8, cast_dtype=tc_dt, **kw)
    jargs = dict(b1=0.9, b2=0.999, eps=1e-8, wd=kw["wd"],
                 coupled=kw["coupled"], use_inv=kw["use_inv"],
                 use_coeff=kw["use_coeff"], one_pass=kw["one_pass"],
                 sr=kw["sr"], cast=c_dt is not None, out_dtype=jp_dt,
                 cast_dtype=None if c_dt is None else getattr(jnp, c_dt))
    jpn, jmn, jvn, jcn = jfu._run_group(
        jnp.asarray(g), jnp.asarray(p, jp_dt), jnp.asarray(m),
        jnp.asarray(v), jnp.asarray(scalars)[None],
        jnp.asarray(seed)[None], **jargs)
    assert pn.dtype == tp_dt and mn.dtype == torch.float32
    if scalars[5] > 0:                       # forced skip: bit-equal, held
        np.testing.assert_array_equal(_np(pn), _np(p_t))
        np.testing.assert_array_equal(_np(mn), m)
        np.testing.assert_array_equal(_np(vn), v)
        np.testing.assert_array_equal(_np(jpn), _np(p_t))
    # The operands of each last add: (1-b1)g and b1*m; (1-b2)g^2 and
    # b2*v; p and u*lr.
    p64 = _np(p_t).astype(np.float64)
    ge = g.astype(np.float64)
    ge = ge * (scalars[4] if kw["use_inv"] else 1.0) * \
        (scalars[3] if kw["use_coeff"] else 1.0)
    if kw["coupled"]:
        ge = ge + kw["wd"] * p64
    for a, b, t1, t2 in ((mn, jmn, 0.1 * ge, 0.9 * m),
                         (vn, jvn, 0.001 * ge * ge, 0.999 * v)):
        assert _ulps_of_operands(_np(a), _np(b), t1, t2) <= 4
    if kw["sr"]:
        pa, pb = _np(pn), _np(jpn)
        assert np.mean(pa == pb) >= 0.999, np.mean(pa == pb)
        assert ulps(pa, pb, "bf16").max() <= 1
    else:
        assert _ulps_of_operands(_np(pn), _np(jpn), p64, p64) <= 4
    if c_dt is not None:
        assert cn.dtype == tc_dt
        assert ulps(_np(cn), _np(jcn), "bf16" if c_dt == "bfloat16"
                    else "fp16").max() <= 1
