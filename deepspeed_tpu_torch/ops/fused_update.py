"""The fused one-pass Adam step over flat parameter groups.

Port of ``deepspeed_tpu/ops/fused_update.py``. Two kernels, CUDA C++ in
``csrc/fused_update.cu`` (the note at its top gives their bound and
design):

- ``sqnorm`` (K5, replaces ``_sqnorm_kernel``): per-block sum-of-squares
  partials of a flat fp32 grad buffer, summed with one ``torch.sum``.
  It gives the global norm and, through ``isfinite(norm)``, the fp16
  overflow vote.
- ``fused_adam_apply`` (K6, replaces ``_fused_adam_kernel``): one pass
  over g, p, m, v — unscale × clip coefficient, coupled or decoupled
  weight decay, Adam with bias correction, fp32 moments, the overflow
  skip as a select, the compute-dtype cast copy, and in-kernel bf16
  stochastic rounding — in place on p, m, v.

Each wrapper launches its kernel for CUDA tensors, runs its plain
PyTorch version (``sqnorm_plain``, ``fused_adam_plain``: the same
arithmetic) for CPU tensors, and counts its launches in ``.launches``.

``FusedAdam`` is the front end (``fused_adam``/``fused_step`` of the JAX
module): the scalar carry of ``_base_scalars`` (bias correction in
optax's association order) and the one-pass region — norm → overflow
vote → clip coefficient → skip select — with the step count held on
overflow. All of it stays on the device: a step costs no host sync.

Layout. The JAX module interleaves every leaf over V=8 virtual shards
so that ZeRO can shard the buffers over dp. On one card the port keeps
one contiguous flat buffer per dtype group (``FlatGroup``), with each
parameter a view into it, so no step copies parameters into or out of
the buffer. Groups follow ``_float_groups``: leaves grouped by dtype,
groups sorted by dtype name, leaves in the order ``tree_flatten`` gives
(dict keys sorted, as in JAX). ``models/convert.py`` carries moments
between the two layouts.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, \
    Union

import torch

from . import op_builder
from ..runtime.utils import clip_coefficient

ScheduleOrFloat = Union[Callable, float]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_U32 = 0xFFFFFFFF


# --------------------------------------------------------------------- #
# Trees and flat groups
# --------------------------------------------------------------------- #
def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """Leaves of a nested dict/list/tuple tree in JAX's order (dict keys
    sorted) and a spec to rebuild it."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, specs = [], []
        for k in keys:
            lv, sp = tree_flatten(tree[k])
            leaves += lv
            specs.append(sp)
        return leaves, ("dict", keys, specs)
    if isinstance(tree, (list, tuple)):
        leaves, specs = [], []
        for t in tree:
            lv, sp = tree_flatten(t)
            leaves += lv
            specs.append(sp)
        return leaves, (type(tree).__name__, None, specs)
    return [tree], None


def tree_unflatten(spec: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(sp):
        if sp is None:
            return next(it)
        kind, keys, subs = sp
        if kind == "dict":
            return {k: build(s) for k, s in zip(keys, subs)}
        out = [build(s) for s in subs]
        return tuple(out) if kind == "tuple" else out
    return build(spec)


def dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def float_groups(leaves: List[Any]) -> List[Tuple[torch.dtype, List[int]]]:
    """``[(dtype, [leaf index])]`` of the floating leaves, sorted by dtype
    name (the JAX ``_float_groups``)."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            groups.setdefault(leaf.dtype, []).append(i)
    return sorted(groups.items(), key=lambda kv: dtype_name(kv[0]))


class FlatGroup:
    """One dtype group of parameters as one contiguous flat buffer.

    ``param`` holds the parameters (``views()`` gives each leaf as a view
    into it), ``grad`` the fp32 gradients (same offsets), and ``cast``,
    when the engine keeps one, the compute-dtype copy of the parameters
    that the fused step rewrites in the same pass."""

    def __init__(self, leaves: List[torch.Tensor], dtype: torch.dtype,
                 device: torch.device, cast_dtype: Optional[torch.dtype]):
        self.dtype = dtype
        self.shapes = [tuple(t.shape) for t in leaves]
        self.sizes = [t.numel() for t in leaves]
        self.offsets = [sum(self.sizes[:i]) for i in range(len(leaves))]
        self.numel = sum(self.sizes)
        self.param = torch.empty(self.numel, dtype=dtype, device=device)
        with torch.no_grad():
            for t, v in zip(leaves, self.views(self.param)):
                v.copy_(t.detach())
        self.grad = torch.zeros(self.numel, dtype=torch.float32,
                                device=device)
        self.cast = None
        if cast_dtype is not None and cast_dtype != dtype:
            self.cast = self.param.to(cast_dtype)

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        return [buf.narrow(0, o, n).view(s)
                for o, n, s in zip(self.offsets, self.sizes, self.shapes)]


# --------------------------------------------------------------------- #
# Plain PyTorch versions (CPU path, and the kernels' reference on card)
# --------------------------------------------------------------------- #
def sqnorm_plain(g: torch.Tensor) -> torch.Tensor:
    g = g.float()
    return torch.sum(g * g)


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64 (the JAX
    ``_hash_u32``); multiplications split so no product leaves int64."""
    def mul(a, c):
        lo, hi = c & 0xFFFF, c >> 16
        return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32
    x = x ^ (x >> 16)
    x = mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def stochastic_round_bits(x: torch.Tensor, noise: torch.Tensor
                          ) -> torch.Tensor:
    """Add 16-bit ``noise`` (int64 in [0, 2^16)) to fp32 ``x``'s mantissa
    tail and truncate to bf16; inf/nan pass through rounded to
    nearest."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _U32
    r = (bits + noise) & 0xFFFF0000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    out = r.view(torch.float32).to(torch.bfloat16)
    return torch.where(torch.isfinite(x), out, x.to(torch.bfloat16))


def fused_adam_plain(g, p, m, v, scalars, seed, *, b1: float, b2: float,
                     eps: float, wd: float, coupled: bool, use_inv: bool,
                     use_coeff: bool, one_pass: bool, sr: bool,
                     cast_dtype: Optional[torch.dtype] = None):
    """The K6 arithmetic, op by op in the JAX kernel's association order.
    Returns new ``(p, m, v, cast_or_None)``; the inputs are not
    modified. ``scalars`` = [neg_lr, bc1, bc2, coeff, inv, skip, 0, 0],
    ``seed`` = [sr seed, base index] (int32)."""
    f32 = torch.float32
    g = g.to(f32)
    if use_inv:
        g = g * scalars[4]
    if use_coeff:
        g = g * scalars[3]
    p32 = p.to(f32)
    if coupled and wd:
        g = g + wd * p32
    m_new = (1 - b1) * g + b1 * m
    v_new = (1 - b2) * (g * g) + b2 * v
    u = (m_new / scalars[1]) / (torch.sqrt(v_new / scalars[2]) + eps)
    if (not coupled) and wd:
        u = u + wd * p32
    new_p = p32 + u * scalars[0]
    if one_pass:
        keep_old = scalars[5] > 0.0
        new_p = torch.where(keep_old, p32, new_p)
        m_new = torch.where(keep_old, m, m_new)
        v_new = torch.where(keep_old, v, v_new)
    cast = None if cast_dtype is None else new_p.to(cast_dtype)
    if sr:
        idx = (seed[1].to(torch.int64) & _U32) + torch.arange(
            new_p.numel(), device=new_p.device, dtype=torch.int64)
        noise = _hash_u32((idx & _U32) ^ (seed[0].to(torch.int64) & _U32)) \
            & 0xFFFF
        p_new = stochastic_round_bits(new_p, noise.reshape(new_p.shape))
    else:
        p_new = new_p.to(p.dtype)
    return p_new, m_new, v_new, cast


# --------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------- #
def _check(name: str, dev: torch.device, **tensors: torch.Tensor) -> None:
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def sqnorm(g: torch.Tensor) -> torch.Tensor:
    """K5: the sum of squares of a flat fp32 buffer (a 0-dim tensor)."""
    if g.device.type == "cpu":
        return sqnorm_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"sqnorm: no kernel for device {g.device}")
    _check("sqnorm", g.device, g=g)
    if g.dtype != torch.float32 or g.dim() != 1 or g.numel() == 0:
        raise TypeError("sqnorm: the kernel takes a non-empty flat float32 "
                        f"buffer, got {g.dtype} {tuple(g.shape)}")
    lib = op_builder.load()
    blocks = lib.dstt_sqnorm_blocks(g.numel())
    partial = torch.empty(blocks, dtype=torch.float32, device=g.device)
    rc = lib.dstt_sqnorm(g.data_ptr(), g.numel(), partial.data_ptr(),
                         op_builder.stream_ptr(g.device))
    op_builder.check(rc, "sqnorm")
    sqnorm.launches += 1
    return torch.sum(partial)


sqnorm.launches = 0


def fused_adam_apply(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, scalars: torch.Tensor,
                     seed: torch.Tensor, *, b1: float, b2: float,
                     eps: float, wd: float, coupled: bool, use_inv: bool,
                     use_coeff: bool, one_pass: bool, sr: bool,
                     cast_out: Optional[torch.Tensor] = None) -> None:
    """K6: one fused Adam pass over a flat group, in place on ``p``,
    ``m``, ``v`` (and ``cast_out`` when given)."""
    cast_dtype = None if cast_out is None else cast_out.dtype
    flags = dict(b1=b1, b2=b2, eps=eps, wd=wd, coupled=coupled,
                 use_inv=use_inv, use_coeff=use_coeff, one_pass=one_pass,
                 sr=sr)
    if p.device.type == "cpu":
        pn, mn, vn, cn = fused_adam_plain(g, p, m, v, scalars, seed,
                                          cast_dtype=cast_dtype, **flags)
        with torch.no_grad():
            p.copy_(pn)
            m.copy_(mn)
            v.copy_(vn)
            if cast_out is not None:
                cast_out.copy_(cn)
        return
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam: no kernel for device {p.device}")
    extra = {} if cast_out is None else {"cast_out": cast_out}
    _check("fused_adam", p.device, g=g, p=p, m=m, v=v, scalars=scalars,
           seed=seed, **extra)
    n = p.numel()
    for key, t, dt in (("g", g, torch.float32), ("m", m, torch.float32),
                       ("v", v, torch.float32)):
        if t.dtype != dt or t.numel() != n:
            raise TypeError(f"fused_adam: {key} must be [{n}] {dt}, got "
                            f"{tuple(t.shape)} {t.dtype}")
    if scalars.dtype != torch.float32 or scalars.numel() != 8 or \
            seed.dtype != torch.int32 or seed.numel() != 2:
        raise TypeError("fused_adam: scalars must be [8] float32 and seed "
                        "[2] int32")
    if p.dtype == torch.float32:
        if sr:
            raise TypeError("fused_adam: stochastic rounding writes bf16 "
                            "params, got float32")
        if cast_out is not None and (cast_out.numel() != n or cast_dtype
                                     not in (torch.bfloat16, torch.float16)):
            raise TypeError("fused_adam: the cast copy must be [n] bfloat16 "
                            f"or float16, got {cast_dtype}")
    elif p.dtype != torch.bfloat16 or cast_out is not None:
        raise TypeError(f"fused_adam: params must be float32 (optionally "
                        f"with a cast copy) or bfloat16, got {p.dtype}")
    bits = (1 * coupled) | (2 * use_inv) | (4 * use_coeff) | \
        (8 * one_pass) | (16 * bool(wd))
    lib = op_builder.load()
    rc = lib.dstt_fused_adam(
        g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
        None if cast_out is None else cast_out.data_ptr(),
        scalars.data_ptr(), seed.data_ptr(), n, _DTYPE_CODES[p.dtype],
        _DTYPE_CODES.get(cast_dtype, -1), int(sr), bits, b1, 1 - b1, b2,
        1 - b2, eps, wd, op_builder.stream_ptr(p.device))
    op_builder.check(rc, "fused_adam")
    fused_adam_apply.launches += 1


fused_adam_apply.launches = 0


# --------------------------------------------------------------------- #
# Front end
# --------------------------------------------------------------------- #
class FusedAdamState(NamedTuple):
    """One flat fp32 moment buffer per dtype group, in the groups'
    layout; ``count`` is the int32 number of updates taken."""
    count: torch.Tensor
    m: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]


class FusedAdam:
    """Adam / AdamW as the one-pass fused step (``fused_adam`` of the JAX
    module). ``adam_w_mode=True`` decays decoupled (``optax.adamw``);
    False folds L2 decay into the gradient before the moments."""

    def __init__(self, learning_rate: ScheduleOrFloat, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.adam_w_mode = bool(adam_w_mode)

    def init(self, groups: List[FlatGroup]) -> FusedAdamState:
        dev = groups[0].param.device
        zeros = lambda: tuple(torch.zeros(grp.numel, dtype=torch.float32,  # noqa: E731
                                          device=dev) for grp in groups)
        return FusedAdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            m=zeros(), v=zeros())

    def lr_at(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``count`` as an fp32 device tensor (a
        Python float is filled in on the device, never copied from the
        host, which would sync the host with the card)."""
        lr = self.learning_rate(count) if callable(self.learning_rate) \
            else self.learning_rate
        if isinstance(lr, torch.Tensor):
            return lr.to(torch.float32)
        return torch.full((), lr, dtype=torch.float32, device=count.device)

    def _base_scalars(self, count: torch.Tensor,
                      inv_scale: Optional[torch.Tensor]) -> torch.Tensor:
        """[neg_lr, bc1, bc2, inv]: bias correction as optax evaluates
        it (``1 - b ** (count + 1)`` in fp32), ``neg_lr = -1 * lr``."""
        f32 = torch.float32
        count_inc = (count + 1).to(f32)
        one = torch.ones((), dtype=f32, device=count.device)
        bc1 = one - torch.pow(torch.full_like(one, self.b1), count_inc)
        bc2 = one - torch.pow(torch.full_like(one, self.b2), count_inc)
        neg_lr = -one * self.lr_at(count)
        inv = one if inv_scale is None else inv_scale.to(f32)
        return torch.stack([neg_lr, bc1, bc2, inv])

    def step(self, groups: List[FlatGroup], state: FusedAdamState, *,
             clip: float = 0.0, inv_scale: Optional[torch.Tensor] = None,
             fp16: bool = False, compute_norm: bool = True,
             sr_seed: Optional[torch.Tensor] = None
             ) -> Tuple[FusedAdamState, torch.Tensor, torch.Tensor]:
        """One-pass clipped update of every group, in place on the
        groups' params (and cast copies) and the state's moments.
        ``inv_scale`` unscales fp16 loss-scaled grads in the kernel;
        ``sr_seed`` (int32 0-dim) turns on stochastic rounding for bf16
        groups. Returns ``(state, grad_norm, overflow)``; ``grad_norm``
        is -1 when not computed."""
        dev = state.count.device
        f32 = torch.float32
        base = self._base_scalars(state.count, inv_scale)
        if compute_norm:
            nsq = torch.zeros((), dtype=f32, device=dev)
            for grp in groups:
                nsq = nsq + sqnorm(grp.grad)
            # norm of the UNSCALED grads: ||g*inv|| == inv * ||g||.
            grad_norm = torch.sqrt(nsq) * base[3]
        else:
            grad_norm = torch.full((), -1.0, dtype=f32, device=dev)
        if fp16:
            # inf/nan anywhere in the grads make the sum of squares
            # non-finite: the norm read doubles as the overflow vote.
            overflow = torch.logical_not(torch.isfinite(grad_norm))
        else:
            overflow = torch.zeros((), dtype=torch.bool, device=dev)
        use_coeff = bool(compute_norm and clip and clip > 0)
        coeff = clip_coefficient(grad_norm, clip) if use_coeff \
            else torch.ones((), dtype=f32, device=dev)
        skip = overflow.to(f32)
        zero = torch.zeros((), dtype=f32, device=dev)
        scalars = torch.stack([base[0], base[1], base[2], coeff, base[3],
                               skip, zero, zero])
        for gi, grp in enumerate(groups):
            sr = sr_seed is not None and grp.dtype == torch.bfloat16
            seed = torch.stack([
                (sr_seed + gi) if sr_seed is not None else
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev)]).to(
                    torch.int32)
            fused_adam_apply(
                grp.grad, grp.param, state.m[gi], state.v[gi], scalars, seed,
                b1=self.b1, b2=self.b2, eps=self.eps, wd=self.weight_decay,
                coupled=not self.adam_w_mode, use_inv=inv_scale is not None,
                use_coeff=use_coeff, one_pass=True, sr=sr,
                cast_out=None if sr else grp.cast)
        count = state.count + torch.logical_not(overflow).to(torch.int32)
        return FusedAdamState(count, state.m, state.v), grad_norm, overflow


__all__ = ["FusedAdam", "FusedAdamState", "FlatGroup", "float_groups",
           "tree_flatten", "tree_unflatten", "sqnorm", "sqnorm_plain",
           "fused_adam_apply", "fused_adam_plain", "stochastic_round_bits"]
