"""The port's LayerNorm / residual LayerNorm / bias+GELU
(deepspeed_tpu_torch/ops/fused_elementwise.py) against the JAX fused
Pallas kernels (interpret mode on the CPU) and the jnp references.

Tolerances: fp32 1e-5; bf16 and fp16 at most 2 ulp (the JAX module's
own contract); the residual sum ``s`` bit-equal. The LayerNorm cases
include the shapes by which the CUDA kernel picks its instance: H 197
(no 16-byte vector divides it: the width-1 instance) and fp16 (eight
elements a vector, as bf16). The CUDA kernels against these plain
versions are in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.ops import fused_elementwise as jfe
from deepspeed_tpu_torch.ops import fused_elementwise as tfe
from torch_cases import assert_close

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "fp16": (torch.float16, jnp.float16)}
ROWS = 6


def _inputs(seed, H):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((ROWS, H)) * 2 + 0.5).astype(np.float32)
    d = rng.standard_normal((ROWS, H)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(H)).astype(np.float32)
    return x, d, scale, bias


def _to_np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_close(a, b, dtype_name):
    assert_close(_to_np(a), _to_np(b), dtype_name)


@pytest.mark.parametrize("H", [128, 197, 768, 1600])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16", "fp16"])
def test_layer_norm(H, dtype_name):
    tdt, jdt = DTYPES[dtype_name]
    x, _, scale, bias = _inputs(H, H)
    out = tfe.fused_layer_norm(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(scale),
                               torch.from_numpy(bias))
    assert out.dtype == tdt
    xj = jnp.asarray(x, jdt)
    _assert_close(out, jfe.fused_layer_norm(xj, jnp.asarray(scale),
                                            jnp.asarray(bias)), dtype_name)
    _assert_close(out, jtr.layer_norm(xj, jnp.asarray(scale),
                                      jnp.asarray(bias)), dtype_name)


@pytest.mark.parametrize("H", [128, 197, 768, 1600])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16", "fp16"])
def test_residual_layer_norm(H, dtype_name):
    tdt, jdt = DTYPES[dtype_name]
    x, d, scale, bias = _inputs(H + 1, H)
    s, y = tfe.fused_residual_layer_norm(
        torch.from_numpy(x).to(tdt), torch.from_numpy(d).to(tdt),
        torch.from_numpy(scale), torch.from_numpy(bias))
    xj, dj = jnp.asarray(x, jdt), jnp.asarray(d, jdt)
    sj, yj = jfe.fused_residual_layer_norm(xj, dj, jnp.asarray(scale),
                                           jnp.asarray(bias))
    np.testing.assert_array_equal(_to_np(s), _to_np(sj))     # bit-equal
    np.testing.assert_array_equal(_to_np(s), _to_np(xj + dj))
    _assert_close(y, yj, dtype_name)
    _assert_close(y, jtr.layer_norm(xj + dj, jnp.asarray(scale),
                                    jnp.asarray(bias)), dtype_name)


# (dtype, exact): the tanh cases keep their ids, the erf form's are
# "<dtype>-exact".
GELU_FORMS = pytest.mark.parametrize(
    "dtype_name, exact", [("fp32", False), ("bf16", False), ("fp32", True),
                          ("bf16", True)],
    ids=["fp32", "bf16", "fp32-exact", "bf16-exact"])


def _assert_gelu_close(a, b, dtype_name, exact):
    """The erf form in fp32 within 2e-6; otherwise the module's
    tolerances. XLA's fp32 erf is off by up to 2.9e-7 absolute (torch's
    and CUDA's by 6e-8), which ``0.5 * z * (1 + erf)`` scales by z/2:
    1.1e-6 measured where 1 + erf cancels. The tanh form differs from the
    erf form by up to 4.7e-4, at z = 2.70."""
    if exact and dtype_name == "fp32":
        np.testing.assert_allclose(_to_np(a), _to_np(b), atol=2e-6, rtol=0)
    else:
        _assert_close(a, b, dtype_name)


@pytest.mark.parametrize("F", [128, 768, 1600, 3072])
@GELU_FORMS
def test_bias_gelu(F, dtype_name, exact):
    tdt, jdt = DTYPES[dtype_name]
    rng = np.random.default_rng(F)
    y = (rng.standard_normal((ROWS, F)) * 3).astype(np.float32)
    b = rng.standard_normal(F).astype(np.float32)
    out = tfe.fused_bias_gelu(torch.from_numpy(y).to(tdt),
                              torch.from_numpy(b), exact)
    assert out.dtype == tdt
    yj = jnp.asarray(y, jdt)
    _assert_gelu_close(out, jfe.fused_bias_gelu(yj, jnp.asarray(b), exact),
                       dtype_name, exact)
    # The jnp reference adds the bias in the storage dtype, then GELUs.
    ref = jax.nn.gelu((yj.astype(jnp.float32) + b).astype(jdt)
                      .astype(jnp.float32), approximate=not exact)
    _assert_gelu_close(out, ref.astype(jdt), dtype_name, exact)


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_bias_gelu_exact_vjp_matches_jax(dtype_name):
    """The erf form's forward and VJP through the port's autograd
    Function against JAX ``fused_bias_gelu(y, b, True)`` (the Pallas
    kernels in interpret mode) at y = 3 randn: fp32 within 2e-6, bf16
    within 2 ulp."""
    tdt, jdt = DTYPES[dtype_name]
    rng = np.random.default_rng(11)
    y = (rng.standard_normal((ROWS, 768)) * 3).astype(np.float32)
    b = rng.standard_normal(768).astype(np.float32)
    g = rng.standard_normal((ROWS, 768)).astype(np.float32)
    yt = torch.from_numpy(y).to(tdt).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    out = tfe.fused_bias_gelu(yt, bt, True)
    out.backward(torch.from_numpy(g).to(tdt))
    jout, vjp = jax.vjp(lambda a, c: jfe.fused_bias_gelu(a, c, True),
                        jnp.asarray(y, jdt), jnp.asarray(b))
    jdy, jdb = vjp(jnp.asarray(g, jdt))
    _assert_gelu_close(out.detach(), jout, dtype_name, True)
    _assert_gelu_close(yt.grad, jdy, dtype_name, True)
    np.testing.assert_allclose(_to_np(bt.grad), _to_np(jdb), rtol=1e-5,
                               atol=1e-5)


def test_cpu_path_counts_no_launch():
    before = (tfe.fused_layer_norm.launches, tfe.fused_bias_gelu.launches)
    x = torch.ones(2, 128)
    tfe.fused_layer_norm(x, torch.ones(128), torch.zeros(128))
    tfe.fused_bias_gelu(x, torch.zeros(128))
    assert (tfe.fused_layer_norm.launches,
            tfe.fused_bias_gelu.launches) == before


def test_non_cpu_non_cuda_tensor_raises():
    # Only a CPU tensor takes the plain version; any other device gets
    # the kernel or an error, never a silent fallback.
    x = torch.empty(2, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfe.fused_layer_norm(x, torch.ones(128), torch.zeros(128))
    with pytest.raises(ValueError, match="no kernel"):
        tfe.fused_bias_gelu(x, torch.zeros(128))
