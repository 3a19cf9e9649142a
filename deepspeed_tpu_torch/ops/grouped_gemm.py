"""Grouped GEMM of the MoE expert FFN (port of
``deepspeed_tpu/ops/grouped_gemm.py``).

The kernel is CUDA C++ in ``csrc/grouped_gemm.cu`` (replacing the Pallas
kernel ``_gg_kernel``, K9); the note at the top of that file gives its
bound and design.

- ``grouped_matmul(a [E,M,K], b [E,K,N], bias [E,N]?, act?)`` — the
  kernel wrapper: ``out[e] = act(a[e] @ b[e] + bias[e])``. For a CUDA
  tensor it launches the kernel and counts the launch in
  ``grouped_matmul.launches``; for a CPU tensor it runs
  ``grouped_matmul_plain``, the same arithmetic in PyTorch. bf16/fp16
  take the TMA + wgmma kernel: ``_gg_plan`` reads which dimension of
  each operand has stride 1 (so the backward's transposed views need no
  copy) and picks the tile (BN through ``ops/autotune.resolve``, with
  ``_gg_tile`` as its heuristic); an operand TMA cannot describe (no unit
  stride, an unaligned base, a stride not a multiple of 16 bytes) is
  copied into a contiguous buffer first, counted in
  ``grouped_matmul.staged``. fp32 takes a SIMT kernel that reads any
  strides.
- ``grouped_ffn(x, w1, b1, w2, b2, exact)`` — the expert FFN
  ``gelu(x @ w1 + b1) @ w2 + b2`` per expert as two grouped GEMMs, a
  ``torch.autograd.Function`` whose backward mirrors the JAX custom VJP:
  it saves only the inputs, recomputes the pre-activation, and computes
  dh, dw2, dw1 and dx with the same kernel on swapped operands (seven
  launches per call, forward and backward); db1/db2 are fp32 sums
  rounded once.
- ``grouped_ffn_plain`` — the same function in plain PyTorch,
  differentiated by autograd (the card's yardstick step).
- ``check_grouped_gemm(flag, device)`` validates ``MoEConfig.
  grouped_gemm``.

Numerics (the JAX module's): fp32 accumulation; ``z = acc + bias``
rounded once to the storage dtype; GELU in fp32 on the rounded z,
rounded once at the output.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import autotune
from . import op_builder
from . import costs
from .fused_elementwise import gelu_f32

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ACT_CODES = {None: 0, "gelu_tanh": 1, "gelu_exact": 2}
# The wgmma kernel's tiles: BM rows by BN columns, and the blocks of each
# that share an SM (csrc/grouped_gemm.cu, Ring).
GG_BM = 128
GG_TILES = (128, 256)
GG_BLOCKS_PER_SM = {128: 2, 256: 1}
# The SIMT kernel's tile (fp32).
GG_F32_TILE = (64, 64)
H100_SMS = 132


def check_grouped_gemm(flag="auto", device="cpu") -> None:
    """Validate ``MoEConfig.grouped_gemm`` on ``device``. The expert FFN
    always runs as ``grouped_ffn``: its kernel on a CUDA device, its
    plain versions on the CPU (the JAX interpret mode's counterpart);
    the value is kept for ds_config parity. False on a CUDA device
    raises: the port has no plain path on the card."""
    if flag not in (True, False, "auto"):
        raise ValueError(f"grouped_gemm must be True/False/'auto', got "
                         f"{flag!r}")
    if flag is False and torch.device(device).type == "cuda":
        raise NotImplementedError(
            "grouped_gemm=False has no CUDA path in the port — the expert "
            "FFN runs as its grouped-GEMM kernel there (ROADMAP: not "
            "planned)")


def _check_shapes(a: torch.Tensor, b: torch.Tensor,
                  bias: Optional[torch.Tensor], act: Optional[str]) -> None:
    if act not in _ACT_CODES:
        raise ValueError(f"grouped_matmul: act must be None, 'gelu_tanh' or "
                         f"'gelu_exact', got {act!r}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or \
            a.shape[2] != b.shape[1]:
        raise ValueError(f"grouped_matmul: a [E, M, K] and b [E, K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if bias is not None and tuple(bias.shape) != (a.shape[0], b.shape[2]):
        raise ValueError(f"grouped_matmul: bias [E, N] = "
                         f"{[a.shape[0], b.shape[2]]}, got "
                         f"{tuple(bias.shape)}")


def grouped_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         act: Optional[str] = None) -> torch.Tensor:
    """K9's plain version: the product in fp32 (fp64 for fp64), then the
    kernel's epilogue with its rounding."""
    _check_shapes(a, b, bias, act)
    acc_t = torch.promote_types(a.dtype, torch.float32)
    acc = torch.matmul(a.to(acc_t), b.to(acc_t))
    if bias is not None:
        acc = acc + bias.to(acc_t)[:, None, :]
    z = acc.to(a.dtype)
    if act is not None:
        z = gelu_f32(z.to(acc_t), act == "gelu_exact").to(a.dtype)
    return z


@dataclasses.dataclass(frozen=True)
class GGPlan:
    """How ``grouped_matmul`` runs K9 on a CUDA device.

    ``route``: "wgmma" (bf16/fp16, the TMA + wgmma kernel) or "simt"
    (fp32). ``a_major``: the dimension of ``a`` with stride 1 as the
    kernel reads it, "K" or "M"; ``b_major``: "N" or "K" (after staging).
    ``tile``: (BM, BN). ``staged``: the operands, of "a" and "b", that
    TMA cannot describe; the wrapper copies each into a contiguous buffer
    with rows padded to 8 elements (K-major a, N-major b) and runs the
    same kernel on it."""
    route: str
    a_major: str
    b_major: str
    tile: Tuple[int, int]
    staged: Tuple[str, ...]


def _tma_ok(t: torch.Tensor, fast: int) -> bool:
    """Whether TMA can read the 3-D ``t`` with dim ``fast`` along a box's
    128-byte rows: stride 1 there, a 16-byte aligned base, and every other
    dim of more than one element at a positive stride that is a multiple
    of 16 bytes (a dim of size 1 is never stepped along)."""
    if t.stride(fast) != 1 or t.data_ptr() % 16:
        return False
    isz = t.element_size()
    return all(t.shape[d] == 1 or (t.stride(d) > 0 and
                                   t.stride(d) * isz % 16 == 0)
               for d in range(3) if d != fast)


@functools.lru_cache(maxsize=None)
def _gg_tile(E: int, M: int, N: int, act: Optional[str] = None,
             sms: int = H100_SMS) -> int:
    """BN of the wgmma tile for an [E, M, N] output. With an activation,
    128: the GELU epilogue is long, and the second block an SM runs its
    products meanwhile. Else the one whose blocks fill the card's block
    slots (``sms`` multiprocessors times the blocks an SM holds) with the
    larger share of useful outputs over the waves they take; 256 on a
    tie, where its wider tile reads each operand fewer times. (At the
    MoE path's seven shapes on an H100 80GB HBM3 at 700 W,
    ``profile_torch_moe.py --parts tiles`` read BN 256 at 0.162-0.192 ms
    without an activation, 8-17% under BN 128, and 0.290 against 0.263
    with GELU.)"""
    if act is not None:
        return 128

    def useful(bn):
        slots = sms * GG_BLOCKS_PER_SM[bn]
        tiles = E * -(-M // GG_BM) * -(-N // bn)
        waves = -(-tiles // slots)
        return E * M * N / (waves * slots * GG_BM * bn)
    return 256 if useful(256) >= useful(128) else 128


def _gg_resolve(a: torch.Tensor, b: torch.Tensor,
                bias: Optional[torch.Tensor], act: Optional[str],
                a_major: str, b_major: str, sms: int) -> int:
    """BN through the tile resolver: the candidates ``GG_TILES`` (every
    one gives the same bits), ``_gg_tile`` the heuristic, the key the
    output's dims, the activation and the operands' majors. On the card
    a search times ``grouped_matmul`` at each BN on zeros laid out as
    ``a``, ``b`` and ``bias``."""
    E, M, K = a.shape
    N = b.shape[2]
    measure = None
    if a.device.type == "cuda" and autotune.search_allowed():
        zeros = []

        def runner(bn):
            if not zeros:
                zeros.extend([torch.zeros_like(a), torch.zeros_like(b),
                              None if bias is None
                              else torch.zeros_like(bias)])
            return grouped_matmul(*zeros, act, _tile=bn)
        measure = autotune.measure_from_runner(runner)
    return autotune.resolve(
        "grouped_gemm", (E, M, K, N, _ACT_CODES[act], int(a_major == "M"),
                         int(b_major == "K")), a.dtype,
        _gg_tile(E, M, N, act, sms), GG_TILES, measure)


def _gg_plan(a: torch.Tensor, b: torch.Tensor, act: Optional[str] = None,
             sms: int = H100_SMS, bias: Optional[torch.Tensor] = None,
             tile: Optional[int] = None) -> GGPlan:
    """The route, majors, tile and staged operands of ``grouped_matmul(a,
    b, bias, act)`` on a CUDA device; reads shapes, strides, dtypes and
    base addresses only (meta or CPU tensors answer too, where the tile
    is the resolver's without a search). A K-major ``a`` and an N-major
    ``b`` are taken where both majors are possible. ``tile`` pins BN
    (no resolve)."""
    E, M, K = a.shape
    N = b.shape[2]
    if a.dtype == torch.float32:
        # the SIMT kernel walks the dim of stride 1 when only one has it
        a_major = "M" if a.stride(1) == 1 != a.stride(2) else "K"
        b_major = "K" if b.stride(1) == 1 != b.stride(2) else "N"
        return GGPlan("simt", a_major, b_major, GG_F32_TILE, ())
    staged = []
    if _tma_ok(a, 2):
        a_major = "K"
    elif _tma_ok(a, 1):
        a_major = "M"
    else:
        a_major = "K"
        staged.append("a")
    if _tma_ok(b, 2):
        b_major = "N"
    elif _tma_ok(b, 1):
        b_major = "K"
    else:
        b_major = "N"
        staged.append("b")
    if tile is None:
        tile = _gg_resolve(a, b, bias, act, a_major, b_major, sms)
    return GGPlan("wgmma", a_major, b_major, (GG_BM, tile), tuple(staged))


def _stage(t: torch.Tensor) -> torch.Tensor:
    """``t`` [E, R, C] copied into a contiguous buffer whose rows are
    padded to a multiple of 8 elements (16 bytes), viewed back as [E, R,
    C]: the same values with C at stride 1."""
    E, R, C = t.shape
    buf = torch.empty((E, R, -(-C // 8) * 8), dtype=t.dtype, device=t.device)
    view = buf[..., :C]
    view.copy_(t)
    grouped_matmul.staged += 1
    return view


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@costs.declares("K9", costs.grouped_gemm_decl)
def grouped_matmul(a: torch.Tensor, b: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   act: Optional[str] = None,
                   _tile: Optional[int] = None) -> torch.Tensor:
    """K9: ``out[e] = act(a[e] @ b[e] + bias[e])`` for every expert e.

    ``a`` [E, M, K] and ``b`` [E, K, N] of one dtype (fp32, bf16 or
    fp16), any strides; ``bias`` [E, N] (read as fp32) or None; ``act``
    None, "gelu_tanh" or "gelu_exact". The output is contiguous, in
    ``a.dtype``. ``_tile`` (bf16/fp16 on the card: 128 or 256) pins BN
    past the resolver, for tests, probes and the resolver's own search
    (as the JAX ``_grouped_matmul``'s ``_tile``); the bits do not depend
    on it."""
    if a.device.type == "cpu":
        return grouped_matmul_plain(a, b, bias, act)
    _check_shapes(a, b, bias, act)
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"grouped_matmul: no kernel for device {dev}")
    if b.device != dev or (bias is not None and bias.device != dev):
        raise ValueError("grouped_matmul: operands on different devices")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"grouped_matmul: the kernel takes a and b of one "
                        f"dtype out of float32, bfloat16, float16; got "
                        f"{a.dtype} and {b.dtype}")
    if _tile not in (None, *GG_TILES):
        raise ValueError(f"grouped_matmul: _tile must be None or one of "
                         f"{GG_TILES}, got {_tile!r}")
    E, M, K = a.shape
    N = b.shape[2]
    bias32 = None if bias is None else \
        bias.detach().to(torch.float32).contiguous()
    out = torch.empty((E, M, N), dtype=a.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = op_builder.load()
    bias_ptr = None if bias32 is None else bias32.data_ptr()
    stream = op_builder.stream_ptr(dev)
    if a.dtype == torch.float32:
        rc = lib.dstt_grouped_gemm_f32(
            a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(), bias_ptr,
            out.data_ptr(), E, M, K, N, _ACT_CODES[act], stream)
    else:
        plan = _gg_plan(a, b, act, _sm_count(
            dev.index if dev.index is not None
            else torch.cuda.current_device()), bias, _tile)
        if "a" in plan.staged:
            a = _stage(a)
        if "b" in plan.staged:
            b = _stage(b)
        a_mn, b_k = plan.a_major == "M", plan.b_major == "K"
        rc = lib.dstt_grouped_gemm(
            a.data_ptr(), a.stride(0), a.stride(2 if a_mn else 1), int(a_mn),
            b.data_ptr(), b.stride(0), b.stride(2 if b_k else 1), int(b_k),
            bias_ptr, out.data_ptr(), E, M, K, N, _ACT_CODES[act],
            _DTYPE_CODES[a.dtype], plan.tile[1], stream)
    op_builder.check(rc, "grouped_matmul")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
grouped_matmul.staged = 0


def _act_name(exact: bool) -> str:
    return "gelu_exact" if exact else "gelu_tanh"


def _swap(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(1, 2)


def _ffn_forward(x, w1, b1, w2, b2, exact):
    h = grouped_matmul(x, w1, bias=b1, act=_act_name(exact))
    return grouped_matmul(h, w2, bias=b2)


class _GroupedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, exact):
        # Saves the inputs only: the [E, C, F] pre-activation is
        # recomputed in the backward.
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.exact = exact
        return _ffn_forward(x, w1, b1, w2, b2, exact)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        approximate = "none" if ctx.exact else "tanh"
        z1 = grouped_matmul(x, w1, bias=b1)                 # [E, C, F]
        # h = round(gelu(z1)) and dz = round(dh * gelu'(z1)), each one
        # fused elementwise pass evaluated in fp32 (PyTorch's GELU and
        # its backward; the JAX package evaluates _gelu_f32/_dgelu_f32 in
        # XLA, outside the kernel, and rounds at the same points).
        h = F.gelu(z1, approximate=approximate)
        dh = grouped_matmul(dy, _swap(w2))                  # [E, C, F]
        dz = torch.ops.aten.gelu_backward(dh, z1, approximate=approximate)
        dw2 = grouped_matmul(_swap(h), dy).to(w2.dtype)
        db2 = dy.sum(1, dtype=torch.float32).to(b2.dtype)
        dw1 = grouped_matmul(_swap(x), dz).to(w1.dtype)
        db1 = dz.sum(1, dtype=torch.float32).to(b1.dtype)
        dx = grouped_matmul(dz, _swap(w1))
        return dx, dw1, db1, dw2, db2, None


def grouped_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor,
                exact: bool = False) -> torch.Tensor:
    """The expert FFN ``gelu(x @ w1 + b1) @ w2 + b2`` per expert, as two
    fused grouped GEMMs. ``x`` [E, C, H]; ``w1`` [E, H, F]; ``b1`` [E,
    F]; ``w2`` [E, F, H]; ``b2`` [E, H]; all of one dtype. Default GELU
    is the tanh form (``exact=True``: erf)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _GroupedFFN.apply(x, w1, b1, w2, b2, exact)
    return _ffn_forward(x, w1, b1, w2, b2, exact)


def grouped_ffn_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor,
                      exact: bool = False) -> torch.Tensor:
    """``grouped_ffn`` on the plain versions, differentiated by
    autograd."""
    h = grouped_matmul_plain(x, w1, b1, _act_name(exact))
    return grouped_matmul_plain(h, w2, b2)


__all__ = ["check_grouped_gemm", "grouped_matmul", "grouped_matmul_plain",
           "grouped_ffn", "grouped_ffn_plain"]
