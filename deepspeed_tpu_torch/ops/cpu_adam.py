"""DeepSpeedCPUAdam: host-resident Adam/AdamW for ZeRO-Offload (port of
``deepspeed_tpu/ops/cpu_adam.py``).

The state is fp32 CPU tensors in host memory: the masters (owned by the
caller) and both moments (owned here), updated in place by the C++ SIMD
kernel ``csrc/cpu_adam.cpp`` through ``ctypes`` (pointers from
``data_ptr()``; ctypes releases the GIL for the call, so calls from
several threads run at once). A step can also write the bf16 copy of
the updated masters in the same pass (the ``_plus_copy`` entry points):
that copy is what goes back to the card. bf16 gradients go to the
kernel as they are (the ``_bf16g`` entry points); any other gradient
is read as fp32.

The library is built with the host's C++ compiler at first use
(``op_builder.load_host``). There is no fallback: a missing compiler or
a failed build raises. ``cpu_adam_plain`` and ``grad_norm_sq_plain``
are the same step and norm in plain torch ops (the JAX module's
``_numpy_step``, and the fp64 norm), for the tests and the card
smoke to hold the kernel against; the engine never calls them.

Team size. Each call runs with the OpenMP team ``threads`` (default:
OpenMP's own default, read once at load; a call on a leaf of fewer than
``MIN_PER_THREAD`` elements a thread takes fewer threads), set on the
calling thread for the call and restored after it (the process shares
one OpenMP runtime with torch's CPU ops). Adam is elementwise, so its
bits do not depend on the team. Nor do a norm's: it sums the fp64
squares in numpy's order for ``np.sum`` (pairwise within blocks of 8192
elements, the blocks in index order; threads take whole blocks), so on
any team and any host it gives the bits of the JAX module's numpy path
(``DeepSpeedCPUAdam.grad_norm_sq`` without its library).
"""
from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import op_builder
from .fused_update import tree_flatten

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_F = ctypes.c_float
_D = ctypes.c_double
_ADAM = [_P, _P, _P, _P, _I64, _I32, _F, _F, _F, _F, _F, _I32, _F]
_ADAM_COPY = [_P, _P, _P, _P, _P, _I64, _I32, _F, _F, _F, _F, _F, _I32, _F]

# C signatures (argtypes, restype) of csrc/cpu_adam.cpp's entry points.
HOST_SIGNATURES = {
    "ds_adam_step": (_ADAM, None),
    "ds_adam_step_plus_copy": (_ADAM_COPY, None),
    "ds_adam_step_plus_copy_bf16g": (_ADAM_COPY, None),
    "ds_adam_step_bf16g": (_ADAM, None),
    "ds_grad_norm_sq_bf16": ([_P, _I64, _D], _D),
    "ds_grad_norm_sq": ([_P, _I64, _D], _D),
    "ds_omp_set_threads": ([_I32], None),
    "ds_omp_max_threads": ([], _I32),
    "ds_stream_adam_traffic": ([_P, _P, _P, _P, _P, _I64], None),
    "ds_stream_read": ([_P, _I64], ctypes.c_double),
}

_default_threads: Optional[int] = None
# The fewest elements an Adam call gives each thread of its team.
MIN_PER_THREAD = 1 << 16
_count_lock = threading.Lock()


def native_lib() -> ctypes.CDLL:
    """The host kernel library with its signatures set (built at first
    use; raises if it cannot be built)."""
    global _default_threads
    lib = op_builder.load_host()
    if _default_threads is None:
        for name, (argtypes, restype) in HOST_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _default_threads = int(lib.ds_omp_max_threads())
    return lib


def default_threads() -> int:
    """OpenMP's default team size on this host (``OMP_NUM_THREADS``, else
    the cores), as read when the library was loaded."""
    native_lib()
    return _default_threads


@contextlib.contextmanager
def _team(lib: ctypes.CDLL, threads: int):
    """The calling thread's OpenMP team is ``threads`` inside."""
    prev = int(lib.ds_omp_max_threads())
    lib.ds_omp_set_threads(int(threads))
    try:
        yield
    finally:
        lib.ds_omp_set_threads(prev)


def _leaf_team(team: int, n: int) -> int:
    """The team a call on ``n`` elements takes of ``team``: at least
    ``MIN_PER_THREAD`` elements a thread (a team costs more to wake than
    it saves on a small leaf). A function of the two alone, so a norm
    asked for on the same team gives the same bits."""
    return min(team, max(1, n // MIN_PER_THREAD))


def _host(t: torch.Tensor, what: str, dtype=None) -> torch.Tensor:
    if not isinstance(t, torch.Tensor) or t.device.type != "cpu" or \
            not t.is_contiguous():
        raise ValueError(f"cpu_adam: {what} must be a contiguous CPU "
                         f"tensor, got {getattr(t, 'device', type(t))}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"cpu_adam: {what} must be {dtype}, got {t.dtype}")
    return t


def _grad(g: Any, n: int) -> torch.Tensor:
    """A gradient leaf as the kernel reads it: bf16 as it is, anything
    else as contiguous fp32 (the JAX module's ``np.asarray(g,
    np.float32)``)."""
    g = torch.as_tensor(g)
    if g.device.type != "cpu":
        raise ValueError("cpu_adam: gradients must be CPU tensors")
    if g.dtype != torch.bfloat16:
        g = g.to(torch.float32)
    g = g.contiguous()
    if g.numel() != n:
        raise ValueError(f"cpu_adam: a gradient of {g.numel()} elements "
                         f"for a parameter of {n}")
    return g


class DeepSpeedCPUAdam:
    """Host Adam over a tree (or list) of fp32 CPU masters, updated in
    place; the moments are this object's, one per leaf."""

    def __init__(self, params: Any, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 adamw_mode: bool = True, threads: Optional[int] = None):
        self.lr = float(lr)
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.adamw_mode = bool(adamw_mode)
        self.step_count = 0
        leaves, _ = tree_flatten(params)
        self.exp_avg = [torch.zeros(tuple(l.shape), dtype=torch.float32)
                        for l in leaves]
        self.exp_avg_sq = [torch.zeros(tuple(l.shape), dtype=torch.float32)
                           for l in leaves]
        self._lib = native_lib()
        self.threads = int(threads or _default_threads)

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step_count, "exp_avg": list(self.exp_avg),
                "exp_avg_sq": list(self.exp_avg_sq)}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """The moments are copied into owned, contiguous fp32 tensors (a
        decoded checkpoint's arrays are read-only views)."""
        self.step_count = int(sd["step"])
        self.exp_avg = [_owned_f32(a) for a in sd["exp_avg"]]
        self.exp_avg_sq = [_owned_f32(a) for a in sd["exp_avg_sq"]]

    # ------------------------------------------------------------------ #
    def step(self, master_leaves: Sequence[torch.Tensor],
             grad_leaves: Sequence[Any], lr: Optional[float] = None,
             grad_scale: float = 1.0,
             bf16_out: Optional[Sequence[torch.Tensor]] = None,
             threads: Optional[int] = None) -> None:
        """One step over every leaf (the tick advances first)."""
        self.step_count += 1
        self.step_leaves(master_leaves, grad_leaves,
                         range(len(master_leaves)), lr=lr,
                         grad_scale=grad_scale, bf16_out=bf16_out,
                         step=self.step_count, threads=threads)

    def step_leaves(self, master_leaves: Sequence[torch.Tensor],
                    grad_leaves: Sequence[Any], indices: Sequence[int],
                    lr: Optional[float] = None, grad_scale: float = 1.0,
                    bf16_out: Optional[Sequence[torch.Tensor]] = None,
                    step: Optional[int] = None,
                    threads: Optional[int] = None) -> None:
        """Adam on ``master_leaves[i]`` for ``i`` in ``indices`` from
        ``grad_leaves[j]`` (the j-th gradient pairs with the j-th
        index), in place. ``step`` is the bias-correction tick, passed
        explicitly so that concurrent per-bucket callers share one step
        (calls on disjoint leaves are thread-safe). ``grad_scale`` folds
        the loss-scale inverse and the clip coefficient into the
        gradient read; ``bf16_out[i]`` (bf16 CPU tensors) receives the
        bf16 copy of the updated leaf in the same pass."""
        t = int(self.step_count if step is None else step)
        lr = self.lr if lr is None else float(lr)
        team = threads or self.threads
        for j, i in enumerate(indices):
            n = master_leaves[i].numel()
            with _team(self._lib, _leaf_team(team, n)):
                self._step_leaf(i, master_leaves[i], grad_leaves[j], t, lr,
                                grad_scale,
                                None if bf16_out is None else bf16_out[i])

    def _step_leaf(self, i: int, p: torch.Tensor, g: Any, t: int, lr: float,
                   grad_scale: float, out: Optional[torch.Tensor]) -> None:
        lib = self._lib
        p = _host(p, "a master", torch.float32)
        m, v = self.exp_avg[i], self.exp_avg_sq[i]
        g = _grad(g, p.numel())
        args = (p.numel(), t, lr, self.betas[0], self.betas[1], self.eps,
                self.weight_decay, int(self.adamw_mode), float(grad_scale))
        bf16 = g.dtype == torch.bfloat16
        if out is not None:
            out = _host(out, "a bf16 copy", torch.bfloat16)
            fn = lib.ds_adam_step_plus_copy_bf16g if bf16 \
                else lib.ds_adam_step_plus_copy
            bufs = (p, g, m, v, out)
        else:
            fn = lib.ds_adam_step_bf16g if bf16 else lib.ds_adam_step
            bufs = (p, g, m, v)
        _count(DeepSpeedCPUAdam.step_leaves)
        fn(*(b.data_ptr() for b in bufs), *args)

    def grad_norm_sq(self, grad_leaves: Sequence[Any],
                     grad_scale: float = 1.0,
                     threads: Optional[int] = None) -> float:
        """Squared L2 norm of the scaled gradients: one fp64 sum per leaf
        from the kernel (on ``_leaf_team`` of the team), added in list
        order."""
        lib = self._lib
        team = threads or self.threads
        acc = 0.0
        for g in grad_leaves:
            g = _grad(g, torch.as_tensor(g).numel())
            fn = lib.ds_grad_norm_sq_bf16 if g.dtype == torch.bfloat16 \
                else lib.ds_grad_norm_sq
            with _team(lib, _leaf_team(team, g.numel())):
                _count(DeepSpeedCPUAdam.grad_norm_sq)
                acc += float(fn(g.data_ptr(), g.numel(), float(grad_scale)))
        return acc

    def grad_norm(self, grad_leaves: Sequence[Any], grad_scale: float = 1.0,
                  threads: Optional[int] = None) -> float:
        return float(np.sqrt(self.grad_norm_sq(grad_leaves, grad_scale,
                                               threads)))


# Calls of the kernel (one a leaf): ``.launches`` of the two methods.
DeepSpeedCPUAdam.step_leaves.launches = 0
DeepSpeedCPUAdam.grad_norm_sq.launches = 0


def _count(fn) -> None:
    with _count_lock:              # (pool threads call at once)
        fn.launches += 1


def reset_host_launch_counts() -> None:
    DeepSpeedCPUAdam.step_leaves.launches = 0
    DeepSpeedCPUAdam.grad_norm_sq.launches = 0


def host_launch_counts() -> Dict[str, int]:
    """The host kernel's calls: Adam (``ds_adam_step*``) and norm
    (``ds_grad_norm_sq*``), one a leaf."""
    return {"cpu_adam_step": DeepSpeedCPUAdam.step_leaves.launches,
            "cpu_adam_norm": DeepSpeedCPUAdam.grad_norm_sq.launches}


def _owned_f32(a: Any) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).contiguous().clone()
    return torch.from_numpy(np.array(a, np.float32, order="C", copy=True))


# --------------------------------------------------------------------- #
# Plain versions (tests and the card smoke only)
# --------------------------------------------------------------------- #
def _powf(x: float, y: float) -> float:
    """The C library's ``powf`` (the kernel's bias corrections; numpy's
    float32 power can differ from it by an ulp, which ``1 - beta2^t``
    magnifies a hundredfold)."""
    global _libm
    if _libm is None:
        _libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        _libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
        _libm.powf.restype = ctypes.c_float
    return float(_libm.powf(x, y))


_libm: Optional[ctypes.CDLL] = None


class _Consts:
    """The kernel's fp32 constants of one step (``ds_adam_step``'s
    prologue)."""

    def __init__(self, step, lr, betas, eps, weight_decay, grad_scale):
        f32 = np.float32
        self.b1, self.b2 = f32(betas[0]), f32(betas[1])
        self.lr, self.decay = f32(lr), f32(weight_decay)
        bc1 = f32(1) - f32(_powf(self.b1, step))
        bc2 = f32(1) - f32(_powf(self.b2, step))
        self.step_size = float(self.lr / bc1)
        self.inv_bc2_sqrt = float(f32(1) / np.sqrt(bc2))
        self.omb1 = float(f32(1) - self.b1)
        self.omb2 = float(f32(1) - self.b2)
        self.eps = float(f32(eps))
        self.grad_scale = float(f32(grad_scale))


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def adam_moments_plain(p, g, m, v, k: _Consts, adamw_mode: bool) -> None:
    """The moments' half of the step, in place on ``m``, ``v``. Where g++
    fuses ``a*b + c`` into an FMA (``m*b1 + (g*omb1)`` and ``v*b2 +
    (g*g*omb2)``, the forms read from the library's code) the sum is
    taken in fp64, where the fp32 product is exact, and rounded once."""
    g = g.to(torch.float32) * k.grad_scale
    if not adamw_mode and k.decay != 0:
        g = g + float(k.decay) * p
    m.copy_(_f32(_f64(m) * float(k.b1) + _f64(g * k.omb1)))
    v.copy_(_f32(_f64(v) * float(k.b2) + _f64(g * g * k.omb2)))


def adam_params_plain(p, m, v, k: _Consts, adamw_mode: bool) -> None:
    """The parameters' half of the step from the updated moments, in
    place on ``p`` (its FMAs as in ``adam_moments_plain``)."""
    # (sqrt in fp64: torch's fp32 sqrt on the CPU is not always the
    # correctly rounded value the kernel's sqrtps gives)
    denom = _f32(_f64(_f32(torch.sqrt(_f64(v)))) * k.inv_bc2_sqrt + k.eps)
    new = _f32(_f64(p) - k.step_size * _f64(m / denom))
    if adamw_mode:
        new = _f32(_f64(new) - float(k.lr * k.decay) * _f64(p))
    p.copy_(new)


def cpu_adam_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, *, step: int, lr: float,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8, weight_decay: float = 0.0,
                   adamw_mode: bool = True, grad_scale: float = 1.0,
                   bf16_out: Optional[torch.Tensor] = None) -> None:
    """One Adam step in plain torch ops, in place on the fp32 ``p``,
    ``m``, ``v``: the JAX module's ``_numpy_step`` with the kernel's
    fp32 constants (``1 - beta``, the bias corrections by the C
    library's ``powf``, the step size and ``1/sqrt(bc2)``, all rounded
    to fp32 as the kernel computes them) and its expression order, each
    of the kernel's contracted ``a*b + c`` rounded once. g++ may fuse
    either product of ``a*b + c*d``, so each add of the two agrees within
    a few fp32 ulp of its larger operand (``adam_moments_plain`` and
    ``adam_params_plain`` are the two halves, for holding each against
    the kernel)."""
    k = _Consts(step, lr, betas, eps, weight_decay, grad_scale)
    adam_moments_plain(p, g, m, v, k, adamw_mode)
    adam_params_plain(p, m, v, k, adamw_mode)
    if bf16_out is not None:
        bf16_out.copy_(p.to(torch.bfloat16))


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """The fp32 spacing at ``|x|``."""
    a = x.abs().to(torch.float32)
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def adam_ulp_gaps(p0: torch.Tensor, g: torch.Tensor, m0: torch.Tensor,
                  v0: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                  v: torch.Tensor, *, step: int, lr: float,
                  betas: Tuple[float, float] = (0.9, 0.999),
                  eps: float = 1e-8, weight_decay: float = 0.0,
                  adamw_mode: bool = True, grad_scale: float = 1.0
                  ) -> Dict[str, float]:
    """How far a kernel step (``p0, m0, v0`` → ``p, m, v``) lies from
    the plain one, each quantity in fp32 ulp of the largest term its
    last add sums: ``m`` and ``v`` against ``adam_moments_plain``, ``p``
    against ``adam_params_plain`` from the kernel's own moments (so that
    each quantity's own rounding is measured, not the moments' carried
    into ``p``). The terms: ``m0*b1`` and the gradient's (with the
    coupled decay's term beside the scaled gradient), ``v0*b2`` and the
    squared gradient's, ``p0``, ``step_size*m/denom`` and
    ``lr*decay*p0``."""
    k = _Consts(step, lr, betas, eps, weight_decay, grad_scale)
    mp, vp, pp = m0.clone(), v0.clone(), p0.clone()
    adam_moments_plain(p0, g, mp, vp, k, adamw_mode)
    adam_params_plain(pp, m, v, k, adamw_mode)
    ga = g.to(torch.float32).abs() * k.grad_scale
    if not adamw_mode:
        ga = ga + float(k.decay) * p0.abs()
    denom = torch.sqrt(v.double()).float() * k.inv_bc2_sqrt + k.eps
    scale = {
        "m": torch.maximum(m0.abs() * float(k.b1), ga * k.omb1),
        "v": torch.maximum(v0 * float(k.b2), ga * ga * k.omb2),
        "p": torch.maximum(torch.maximum(
            p0.abs(), k.step_size * m.abs() / denom),
            float(k.lr * k.decay) * p0.abs() if adamw_mode
            else torch.zeros_like(p0))}
    return {name: float(((got - want).abs() / _ulp(scale[name])).max())
            for name, got, want in (("p", p, pp), ("m", m, mp),
                                    ("v", v, vp))}


def grad_norm_sq_plain(g: torch.Tensor, grad_scale: float = 1.0) -> float:
    """Squared L2 norm of ``g * grad_scale`` (the product and the sum of
    the squares in fp64, torch's order)."""
    gd = g.to(torch.float64) * grad_scale
    return float(torch.sum(gd * gd))


__all__ = ["DeepSpeedCPUAdam", "cpu_adam_plain", "grad_norm_sq_plain",
           "adam_ulp_gaps", "adam_moments_plain", "adam_params_plain",
           "host_launch_counts", "reset_host_launch_counts",
           "native_lib", "default_threads", "HOST_SIGNATURES"]
