"""Fused elementwise kernels of the transformer block: residual-add +
LayerNorm and the bias+GELU FFN epilogue, forward and backward.

Port of ``deepspeed_tpu/ops/fused_elementwise.py``. The kernels are CUDA
C++ in ``csrc/fused_elementwise.cu`` (replacing the Pallas kernels
``_ln_fwd_kernel``, ``_ln_bwd_kernel``, ``_gelu_fwd_kernel`` and
``_gelu_bwd_kernel``); the note at the top of that file gives their
bound and design. ``fused_layer_norm``, ``fused_residual_layer_norm``
and ``fused_bias_gelu`` are differentiable: where autograd records the
call they run a ``torch.autograd.Function`` whose forward runs the
forward kernel and saves what the JAX VJPs save (``(x, scale)``,
``(s, scale)``, ``(y, bias)``) and whose backward runs the backward
kernel, which recomputes the LayerNorm statistics and the GELU input
instead of saving them; elsewhere (serving) they launch the forward
kernel with no autograd node. The residual variant returns one combined
cotangent to both ``x`` and ``delta``.

Each kernel wrapper (``_ln_forward``, ``layer_norm_backward``,
``_bias_gelu_forward``, ``bias_gelu_backward``):

- launches its kernel for a CUDA tensor (and raises on what the kernel
  does not take — there is no fallback);
- runs its plain PyTorch version (``*_plain`` below, the same
  arithmetic) for a CPU tensor, which is how the CPU tests run;
- counts its kernel launches in a plain int attribute, ``.launches``
  (the forward LayerNorm counts on ``fused_layer_norm`` or
  ``fused_residual_layer_norm``, the forward GELU on
  ``fused_bias_gelu``).

Numerics contract (the JAX module's): statistics and the GELU curve in
fp32 (fp64 for fp64 inputs, which ``gradcheck`` uses); the residual sum
is rounded to the storage dtype before the statistics read it, so ``s``
is bit-equal to the unfused ``x + delta``; bias+GELU rounds ``y + b`` to
the storage dtype, then applies the tanh form (or, with ``exact``, the
erf form) and rounds once at the output. dscale/dbias come back in the
parameter's dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import op_builder
from . import costs

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_GELU_C = 0.044715
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain versions compute in: fp32, or fp64 for fp64."""
    return torch.promote_types(dtype, torch.float32)


# --------------------------------------------------------------------- #
# Plain PyTorch versions (CPU path, and the kernels' reference on card)
# --------------------------------------------------------------------- #
def layer_norm_plain(x: torch.Tensor, delta: Optional[torch.Tensor],
                     scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``s = x + delta`` (or ``x``), ``y = LN(s)`` with fp32 statistics.
    Returns ``(s, y)`` in x's dtype."""
    s = x if delta is None else x + delta
    acc = _acc(x.dtype)
    s32 = s.to(acc)
    mean = s32.mean(-1, keepdim=True)
    c = s32 - mean
    var = (c * c).mean(-1, keepdim=True)
    y = c * torch.rsqrt(var + eps) * scale.to(acc) + bias.to(acc)
    return s, y.to(x.dtype)


def ln_backward_plain(s: torch.Tensor, scale: torch.Tensor,
                      dy: torch.Tensor, gs: Optional[torch.Tensor],
                      eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The LayerNorm input gradient (plus the residual cotangent ``gs``)
    and dscale/dbias, with mean/rstd recomputed from ``s`` exactly as the
    forward computes them. Returns ``(ds, dscale, dbias)``."""
    acc = _acc(s.dtype)
    H = s.shape[-1]
    s32 = s.reshape(-1, H).to(acc)
    dy32 = dy.reshape(-1, H).to(acc)
    mean = s32.sum(-1, keepdim=True) / H
    c = s32 - mean
    rstd = torch.rsqrt((c * c).sum(-1, keepdim=True) / H + eps)
    xhat = c * rstd
    dxhat = dy32 * scale.to(acc)
    m1 = dxhat.sum(-1, keepdim=True) / H
    m2 = (dxhat * xhat).sum(-1, keepdim=True) / H
    dx = (dxhat - m1 - xhat * m2) * rstd
    if gs is not None:
        dx = dx + gs.reshape(-1, H).to(acc)
    dscale = (dy32 * xhat).sum(0)
    dbias = dy32.sum(0)
    return (dx.to(s.dtype).reshape(s.shape), dscale.to(scale.dtype),
            dbias.to(scale.dtype))


def gelu_tanh(z: torch.Tensor) -> torch.Tensor:
    """The tanh-form GELU (GPT-2's gelu_new), in z's dtype."""
    u = _SQRT_2_OVER_PI * (z + _GELU_C * z * z * z)
    return 0.5 * z * (1.0 + torch.tanh(u))


def gelu_f32(z: torch.Tensor, exact: bool) -> torch.Tensor:
    """The JAX package's ``_gelu_f32``: the erf form (``exact``) or the
    tanh form, in z's dtype."""
    if exact:
        return 0.5 * z * (1.0 + torch.erf(z / math.sqrt(2.0)))
    return gelu_tanh(z)


def _gelu_input(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``z = y + b`` rounded to y's storage dtype, widened back."""
    acc = _acc(y.dtype)
    return (y.to(acc) + bias.to(acc)).to(y.dtype).to(acc)


def dgelu_f32(z: torch.Tensor, exact: bool) -> torch.Tensor:
    """The JAX package's ``_dgelu_f32``: the derivative of the erf form
    (``exact``) or of the tanh form, in z's dtype."""
    if exact:
        phi = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
        return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0))) + z * phi
    u = _SQRT_2_OVER_PI * (z + _GELU_C * z * z * z)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * z * z)
    return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du


def bias_gelu_plain(y: torch.Tensor, bias: torch.Tensor,
                    exact: bool = False) -> torch.Tensor:
    return gelu_f32(_gelu_input(y, bias), exact).to(y.dtype)


def bias_gelu_backward_plain(y: torch.Tensor, bias: torch.Tensor,
                             g: torch.Tensor, exact: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dz = g * gelu'(z)`` with z recomputed from the saved matmul
    output; ``dbias`` = the column sum of dz. Returns ``(dz, dbias)``."""
    z = _gelu_input(y, bias)
    dz = g.to(z.dtype) * dgelu_f32(z, exact)
    F = y.shape[-1]
    return dz.to(y.dtype), dz.reshape(-1, F).sum(0).to(bias.dtype)


# --------------------------------------------------------------------- #
# Kernel launches
# --------------------------------------------------------------------- #
def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if tensors[0].dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes float32, bfloat16 or "
                        f"float16, got {tensors[0].dtype}")
    for t in tensors[1:]:
        if t.dtype != tensors[0].dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and "
                            f"{tensors[0].dtype}")


def _vec32(v: torch.Tensor, n: int, device: torch.device,
           name: str) -> torch.Tensor:
    """A [n] parameter vector as the fp32 contiguous buffer the kernel
    reads (a no-op for fp32 parameters)."""
    if v.shape != (n,) or v.device != device:
        raise ValueError(f"{name}: expected a [{n}] vector on {device}, "
                         f"got {tuple(v.shape)} on {v.device}")
    return v.detach().to(torch.float32).contiguous()


@costs.declares("K3f", costs.ln_forward_decl)
def _ln_forward(x: torch.Tensor, delta: Optional[torch.Tensor],
                scale: torch.Tensor, bias: torch.Tensor, eps: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3f: ``(s, y)``; ``s`` is x itself without a residual."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, delta, scale, bias, eps)
    _check_cuda("layer_norm", x, *(() if delta is None else (delta,)))
    if delta is not None and delta.shape != x.shape:
        raise ValueError(f"layer_norm: delta {tuple(delta.shape)} vs x "
                         f"{tuple(x.shape)}")
    H = x.shape[-1]
    rows = x.numel() // H if H else 0
    sc = _vec32(scale, H, x.device, "layer_norm scale")
    bi = _vec32(bias, H, x.device, "layer_norm bias")
    y = torch.empty_like(x)
    s = torch.empty_like(x) if delta is not None else None
    lib = op_builder.load()
    rc = lib.dstt_layer_norm(
        x.data_ptr(), None if delta is None else delta.data_ptr(),
        sc.data_ptr(), bi.data_ptr(), None if s is None else s.data_ptr(),
        y.data_ptr(), rows, H, float(eps), _DTYPE_CODES[x.dtype],
        op_builder.stream_ptr(x.device))
    op_builder.check(rc, "layer_norm")
    if delta is None:
        fused_layer_norm.launches += 1
        return x, y
    fused_residual_layer_norm.launches += 1
    return s, y


@costs.declares("K3b", costs.ln_backward_decl)
def layer_norm_backward(s: torch.Tensor, scale: torch.Tensor,
                        dy: torch.Tensor, gs: Optional[torch.Tensor],
                        eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3b: ``(ds, dscale, dbias)`` — the LayerNorm input gradient plus
    the residual cotangent ``gs`` (None without a residual), and the
    parameter gradients, which the kernel's call sums from its per-block
    partials in a second launch (block order: bit-repeatable)."""
    if s.device.type == "cpu":
        return ln_backward_plain(s, scale, dy, gs, eps)
    _check_cuda("layer_norm_backward", s, dy, *(() if gs is None else (gs,)))
    H = s.shape[-1]
    rows = s.numel() // H
    if dy.shape != s.shape or (gs is not None and gs.shape != s.shape):
        raise ValueError("layer_norm_backward: s, dy and gs must have one "
                         "shape")
    if H > 2048:
        raise ValueError(f"layer_norm_backward: the kernel takes H <= 2048, "
                         f"got {H}")
    sc = _vec32(scale, H, s.device, "layer_norm_backward scale")
    dx = torch.empty_like(s)
    if rows == 0:
        zeros = torch.zeros(H, dtype=scale.dtype, device=s.device)
        return dx, zeros, zeros.clone()
    lib = op_builder.load()
    blocks = lib.dstt_layer_norm_bwd_blocks(rows)
    parts = torch.empty((2, blocks, H), dtype=torch.float64, device=s.device)
    out = torch.empty((2, H), dtype=torch.float32, device=s.device)
    rc = lib.dstt_layer_norm_bwd(
        s.data_ptr(), sc.data_ptr(), dy.data_ptr(),
        None if gs is None else gs.data_ptr(), dx.data_ptr(),
        parts.data_ptr(), out.data_ptr(), rows, H, float(eps),
        _DTYPE_CODES[s.dtype], op_builder.stream_ptr(s.device))
    op_builder.check(rc, "layer_norm_backward")
    layer_norm_backward.launches += 1
    dsc_dbi = out.to(scale.dtype)
    return dx, dsc_dbi[0], dsc_dbi[1]


layer_norm_backward.launches = 0


@costs.declares("K4f", costs.gelu_forward_decl)
def _bias_gelu_forward(y: torch.Tensor, bias: torch.Tensor,
                       exact: bool = False) -> torch.Tensor:
    """K4f: ``gelu(y + bias)``, the erf form where ``exact``."""
    if y.device.type == "cpu":
        return bias_gelu_plain(y, bias, exact)
    _check_cuda("bias_gelu", y)
    F = y.shape[-1]
    b = _vec32(bias, F, y.device, "bias_gelu bias")
    out = torch.empty_like(y)
    lib = op_builder.load()
    rc = lib.dstt_bias_gelu(y.data_ptr(), b.data_ptr(), out.data_ptr(),
                            y.numel(), F, int(exact), _DTYPE_CODES[y.dtype],
                            op_builder.stream_ptr(y.device))
    op_builder.check(rc, "bias_gelu")
    fused_bias_gelu.launches += 1
    return out


@costs.declares("K4b", costs.gelu_backward_decl)
def bias_gelu_backward(y: torch.Tensor, bias: torch.Tensor,
                       g: torch.Tensor, exact: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4b: ``(dz, dbias)`` with ``dz = g * gelu'(round(y + b))`` (the
    erf form's derivative where ``exact``); dbias, which the kernel's
    call sums from its per-row-run partials in a second launch (run
    order: bit-repeatable)."""
    if y.device.type == "cpu":
        return bias_gelu_backward_plain(y, bias, g, exact)
    _check_cuda("bias_gelu_backward", y, g)
    if g.shape != y.shape:
        raise ValueError("bias_gelu_backward: y and g must have one shape")
    F = y.shape[-1]
    rows = y.numel() // F
    b = _vec32(bias, F, y.device, "bias_gelu_backward bias")
    lib = op_builder.load()
    splits = lib.dstt_bias_gelu_bwd_splits(rows)
    dz = torch.empty_like(y)
    part = torch.empty((max(splits, 1), F), dtype=torch.float32,
                       device=y.device)
    dbias = torch.empty(F, dtype=torch.float32, device=y.device)
    rc = lib.dstt_bias_gelu_bwd(y.data_ptr(), b.data_ptr(), g.data_ptr(),
                                dz.data_ptr(), part.data_ptr(),
                                dbias.data_ptr(), rows, F, int(exact),
                                _DTYPE_CODES[y.dtype],
                                op_builder.stream_ptr(y.device))
    op_builder.check(rc, "bias_gelu_backward")
    bias_gelu_backward.launches += 1
    return dz, dbias.to(bias.dtype)


bias_gelu_backward.launches = 0


# --------------------------------------------------------------------- #
# Differentiable ops
# --------------------------------------------------------------------- #
class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y = _ln_forward(x, None, scale, bias, eps)[1]
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dsc, dbi = layer_norm_backward(x, scale, dy.contiguous(), None,
                                           ctx.eps)
        return dx, dsc, dbi.to(ctx.bias_dtype), None


class _ResidualLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, scale, bias, eps):
        s, y = _ln_forward(x, delta, scale, bias, eps)
        ctx.save_for_backward(s, scale)
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        # A post-LN block discards s: its cotangent then arrives as None
        # (not a zero buffer) and K3b runs without gs.
        ctx.set_materialize_grads(False)
        return s, y

    @staticmethod
    def backward(ctx, gs, gy):
        s, scale = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(s)
        ds, dsc, dbi = layer_norm_backward(
            s, scale, gy.contiguous(),
            None if gs is None else gs.contiguous(), ctx.eps)
        # d(x + delta)/dx == d(x + delta)/ddelta == identity: both inputs
        # receive the same combined cotangent.
        return ds, ds, dsc, dbi.to(ctx.bias_dtype), None


class _BiasGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bias, exact):
        out = _bias_gelu_forward(y, bias, exact)
        ctx.save_for_backward(y, bias)
        ctx.exact = exact
        return out

    @staticmethod
    def backward(ctx, g):
        y, bias = ctx.saved_tensors
        return (*bias_gelu_backward(y, bias, g.contiguous(), ctx.exact),
                None)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records this call; without it (serving) the ops
    launch their forward kernel directly, with no autograd node."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics, one pass forward
    and one backward."""
    if _needs_grad(x, scale, bias):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _ln_forward(x, None, scale, bias, eps)[1]


fused_layer_norm.launches = 0


def fused_residual_layer_norm(x: torch.Tensor, delta: torch.Tensor,
                              scale: torch.Tensor, bias: torch.Tensor,
                              eps: float = 1e-5
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``s = x + delta; y = LN(s)`` in one pass; returns ``(s, y)`` —
    the same LayerNorm kernel with its residual flag set."""
    if _needs_grad(x, delta, scale, bias):
        return _ResidualLayerNorm.apply(x, delta, scale, bias, eps)
    return _ln_forward(x, delta, scale, bias, eps)


fused_residual_layer_norm.launches = 0


def fused_bias_gelu(y: torch.Tensor, bias: torch.Tensor,
                    exact: bool = False) -> torch.Tensor:
    """``gelu(y + bias)`` in one pass — the FFN up-projection epilogue;
    ``y`` is the raw matmul output. ``exact`` selects the erf form; the
    default is the tanh form (GPT-2's gelu_new)."""
    if _needs_grad(y, bias):
        return _BiasGelu.apply(y, bias, exact)
    return _bias_gelu_forward(y, bias, exact)


fused_bias_gelu.launches = 0


__all__ = ["fused_layer_norm", "fused_residual_layer_norm",
           "fused_bias_gelu", "layer_norm_backward", "bias_gelu_backward",
           "layer_norm_plain", "ln_backward_plain", "bias_gelu_plain",
           "bias_gelu_backward_plain", "gelu_tanh", "gelu_f32",
           "dgelu_f32"]
