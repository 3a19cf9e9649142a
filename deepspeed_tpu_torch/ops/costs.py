"""What each kernel of the port does: one function a kernel from its
shapes to ``Cost(flops, bytes, macs)``.

``bytes`` is what the kernel must move (each input read once, each
output written once), ``flops`` the operations it does on them, at the
counts ``chip_smoke.py`` prices its bounds with (it reads these
functions); ``macs`` the multiply-accumulates of a matmul-shaped kernel
(0 for the elementwise ones). The flops profiler
(profiling/flops_profiler) counts a kernel's call at its declared cost
and not at the aten ops of its plain version, which it hides: a CUDA
kernel behind ``ctypes`` is invisible to a dispatch mode, and the CPU
and the card then count the same.

``declares(kernel_id, cost_fn)`` decorates a wrapper: while a walk is
active (``WALK.active``), a call declares ``cost_fn(*args, **kwargs)``
to it and hides its own aten ops; otherwise it adds one global read to
the call.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import numpy as np


class Cost(NamedTuple):
    flops: float
    bytes: float
    macs: float = 0.0


class _Walk:
    """The flops profiler's walk in progress (None: no walk)."""
    active: Any = None


WALK = _Walk()


def declares(kernel_id: str, cost_fn: Callable[..., Cost]):
    """Decorate a kernel wrapper with its declared cost."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            walk = WALK.active
            if walk is None:
                return fn(*args, **kwargs)
            with walk.declared(kernel_id, cost_fn(*args, **kwargs)):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def _rows(x) -> int:
    return x.numel() // x.shape[-1] if x.shape[-1] else 0


# --------------------------------------------------------------------- #
# The formulas (chip_smoke.py prices its bounds with these)
# --------------------------------------------------------------------- #
def layer_norm_fwd(rows: int, H: int, itemsize: int, residual: bool
                   ) -> Cost:
    """K3f: x (and delta) read, y (and s) written, fp32 scale and bias
    read; 8 operations an element."""
    n_io = (4 if residual else 2) * rows * H * itemsize
    return Cost(8 * rows * H, n_io + 2 * H * 4)


def layer_norm_bwd(rows: int, H: int, itemsize: int, residual: bool
                   ) -> Cost:
    """K3b: s and dy (and gs) read, ds written, the fp32 scale read and
    dscale/dbias written; 12 operations an element."""
    n_io = (4 if residual else 3) * rows * H * itemsize
    return Cost(12 * rows * H, n_io + 3 * H * 4)


def bias_gelu_fwd(rows: int, F: int, itemsize: int) -> Cost:
    """K4f: y read, gelu(y + b) written, the fp32 bias read; 12
    operations an element."""
    return Cost(12 * rows * F, 2 * rows * F * itemsize + F * 4)


def bias_gelu_bwd(rows: int, F: int, itemsize: int) -> Cost:
    """K4b: y and g read, dz written, the fp32 bias read and dbias
    written; 20 operations an element."""
    return Cost(20 * rows * F, 3 * rows * F * itemsize + 2 * F * 4)


def sqnorm_cost(n: int) -> Cost:
    """K5: n fp32 read, one written; a multiply and an add each."""
    return Cost(2 * n, 4 * n + 4)


def fused_adam_cost(n: int, p_itemsize: int,
                    cast_itemsize: int = 0) -> Cost:
    """K6: g read, p read and written, m and v read and written (fp32),
    the cast copy written; 20 operations an element."""
    return Cost(20 * n, n * (4 + p_itemsize + 8 + p_itemsize + 8 +
                             cast_itemsize))


def causal_pairs(B: int, nH: int, S: int, causal: bool = True) -> int:
    """(q, k) pairs of dense attention over B x nH heads of length S."""
    return B * nH * (S * (S + 1) // 2 if causal else S * S)


def layout_pairs(layout: np.ndarray, S: int, causal: bool, B: int) -> int:
    """(q, k) pairs a block layout ``[nH, nb, nb]`` keeps at sequence S
    (the causal rule inside a diagonal block), over a batch of B."""
    lay = np.asarray(layout) != 0
    nb = lay.shape[-1]
    bs = S // nb
    if not causal:
        return int(B * lay.sum() * bs * bs)
    i, j = np.indices((nb, nb))
    per = np.where(j < i, bs * bs, np.where(j == i, bs * (bs + 1) // 2, 0))
    return int(B * (lay * per[None]).sum())


def flash_fwd_cost(B: int, S: int, nH: int, D: int, pairs: int,
                   itemsize: int = 2) -> Cost:
    """K1 (and K7): q, k, v read, o written, the fp32 lse written; QK^T
    and PV over the kept pairs."""
    N = B * nH * S * D
    return Cost(4 * D * pairs, 4 * N * itemsize + B * nH * S * 4,
                2 * D * pairs)


def flash_bwd_fused_cost(B: int, S: int, nH: int, D: int, pairs: int,
                         itemsize: int = 2) -> Cost:
    """K2c (and K8a): q, k, v, do read, dq, dk, dv written, lse and
    delta read; five products over the kept pairs."""
    N = B * nH * S * D
    return Cost(10 * D * pairs, 7 * N * itemsize + 2 * B * nH * S * 4,
                5 * D * pairs)


def flash_bwd_dq_cost(B: int, S: int, nH: int, D: int, pairs: int,
                      itemsize: int = 2) -> Cost:
    """K2a (and K8b): q, k, v, do read, dq written; three products."""
    N = B * nH * S * D
    return Cost(6 * D * pairs, 5 * N * itemsize + 2 * B * nH * S * 4,
                3 * D * pairs)


def flash_bwd_dkv_cost(B: int, S: int, nH: int, D: int, pairs: int,
                       itemsize: int = 2) -> Cost:
    """K2b (and K8c): q, k, v, do read, dk, dv written; four
    products."""
    N = B * nH * S * D
    return Cost(8 * D * pairs, 6 * N * itemsize + 2 * B * nH * S * 4,
                4 * D * pairs)


def grouped_gemm_cost(E: int, M: int, K: int, N: int, itemsize: int,
                      bias: bool) -> Cost:
    """K9: a, b read, the output written, the fp32 bias read."""
    nbytes = (E * M * K + E * K * N + E * M * N) * itemsize + \
        (E * N * 4 if bias else 0)
    return Cost(2.0 * E * M * K * N, nbytes, float(E * M * K * N))


def paged_attention_cost(q_numel: int, itemsize: int, blocks: int,
                         nH: int, bs: int, D: int, kv_itemsize: int,
                         table_numel: int, pos_numel: int,
                         keys: int) -> Cost:
    """K10: q read and the output written, the K and V tiles of
    ``blocks`` distinct live table entries read once, the tables read;
    QK^T and PV over ``keys`` attended keys a row and head."""
    nbytes = (2 * q_numel * itemsize + 2 * blocks * nH * bs * D * kv_itemsize
              + table_numel * 4 + pos_numel * 4)
    return Cost(4 * D * nH * keys, nbytes, 2 * D * nH * keys)


# --------------------------------------------------------------------- #
# The wrappers' declarations (their arguments -> Cost), host metadata
# only: nothing here reads the device.
# --------------------------------------------------------------------- #
def ln_forward_decl(x, delta, scale, bias, eps=1e-5) -> Cost:
    return layer_norm_fwd(_rows(x), x.shape[-1], x.element_size(),
                          delta is not None)


def ln_backward_decl(s, scale, dy, gs, eps=1e-5) -> Cost:
    return layer_norm_bwd(_rows(s), s.shape[-1], s.element_size(),
                          gs is not None)


def gelu_forward_decl(y, bias, exact=False) -> Cost:
    return bias_gelu_fwd(_rows(y), y.shape[-1], y.element_size())


def gelu_backward_decl(y, bias, g, exact=False) -> Cost:
    return bias_gelu_bwd(_rows(y), y.shape[-1], y.element_size())


def sqnorm_decl(g) -> Cost:
    return sqnorm_cost(g.numel())


def fused_adam_decl(g, p, m, v, scalars, seed, *, cast_out=None,
                    **flags) -> Cost:
    return fused_adam_cost(p.numel(), p.element_size(),
                           0 if cast_out is None else cast_out.element_size())


def _flash_pairs(q, causal: bool, layout: Optional[Any]) -> int:
    B, S, nH, _ = q.shape
    if layout is None or not isinstance(layout, np.ndarray):
        # (a layout on the card would need a device read: the dense
        # count, an upper bound, is declared instead)
        return causal_pairs(B, nH, S, causal)
    return layout_pairs(layout, S, causal, B)


def flash_fwd_decl(q, k, v, causal, scale, dropout=0.0, seed=None,
                   layout=None, heads=None) -> Cost:
    B, S, nH, D = q.shape
    return flash_fwd_cost(B, S, nH, D, _flash_pairs(q, causal, layout),
                          q.element_size())


def flash_bwd_dq_decl(q, k, v, do, lse, delta, causal, scale,
                      dropout=0.0, seed=None, layout=None,
                      heads=None) -> Cost:
    B, S, nH, D = q.shape
    return flash_bwd_dq_cost(B, S, nH, D, _flash_pairs(q, causal, layout),
                             q.element_size())


def flash_bwd_dkv_decl(q, k, v, do, lse, delta, causal, scale,
                       dropout=0.0, seed=None, layout=None,
                       heads=None) -> Cost:
    B, S, nH, D = q.shape
    return flash_bwd_dkv_cost(B, S, nH, D, _flash_pairs(q, causal, layout),
                              q.element_size())


def flash_bwd_fused_decl(q, k, v, do, lse, delta, causal, scale,
                         dropout=0.0, seed=None, heads=None) -> Cost:
    B, S, nH, D = q.shape
    return flash_bwd_fused_cost(B, S, nH, D, causal_pairs(B, nH, S, causal),
                                q.element_size())


def sparse_fwd_decl(q, k, v, layout, causal, scale, *rest, **kw) -> Cost:
    B, S, nH, D = q.shape
    return flash_fwd_cost(B, S, nH, D, layout_pairs(layout, S, causal, B),
                          q.element_size())


def _sparse_bwd(cost_fn):
    def decl(q, k, v, do, lse, delta, layout, causal, *rest, **kw) -> Cost:
        B, S, nH, D = q.shape
        return cost_fn(B, S, nH, D, layout_pairs(layout, S, causal, B),
                       q.element_size())
    return decl


sparse_bwd_dq_decl = _sparse_bwd(flash_bwd_dq_cost)
sparse_bwd_dkv_decl = _sparse_bwd(flash_bwd_dkv_cost)
sparse_bwd_fused_decl = _sparse_bwd(flash_bwd_fused_cost)


def grouped_gemm_decl(a, b, bias=None, act=None, **kw) -> Cost:
    E, M, K = a.shape
    return grouped_gemm_cost(E, M, K, b.shape[2], a.element_size(),
                             bias is not None)


def paged_attention_decl(q, pk, pv, bt, pos, scale, *rest, **kw) -> Cost:
    """Without a device read: every table entry counted as a live block
    and every position of the tables as an attended key (upper
    bounds)."""
    nH, bs, D = pk.shape[2], pk.shape[3], pk.shape[4]
    keys = pos.numel() * bt.shape[-1] * bs
    return paged_attention_cost(q.numel(), q.element_size(), bt.numel(),
                                nH, bs, D, pk.element_size(), bt.numel(),
                                pos.numel(), keys)


__all__ = ["Cost", "WALK", "declares", "layer_norm_fwd", "layer_norm_bwd",
           "bias_gelu_fwd", "bias_gelu_bwd", "sqnorm_cost",
           "fused_adam_cost", "causal_pairs", "layout_pairs",
           "flash_fwd_cost", "flash_bwd_fused_cost", "flash_bwd_dq_cost",
           "flash_bwd_dkv_cost", "grouped_gemm_cost",
           "paged_attention_cost"]
