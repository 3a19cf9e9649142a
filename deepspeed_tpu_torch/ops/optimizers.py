"""The optimizers of the training engine and their construction (port of
``deepspeed_tpu/ops/optimizers.py`` and of the JAX engine's shared apply,
``runtime/engine.py::_clipped_update``).

Every optimizer implements one interface, ``FlatOptimizer``: ``init``
builds its state over the engine's flat parameter groups (a
``FlatGroup`` on one card and at ZeRO stage 0, a rank's ``ShardGroup``
rows of the V-interleaved layout at stages 1-3 across ranks), and
``step`` runs what every optimizer shares, in the JAX engine's order:

1. the global grad norm by K5 (``sqnorm``, summed over the ranks at
   shard-local ZeRO), of the unscaled grads (times ``inv_scale``, which
   also carries 1/dp across ranks);
2. the fp16 overflow vote: a non-finite norm;
3. the clip coefficient ``min(1, clip / (norm + 1e-6))``;
4. the optimizer's own update (``_apply``);
5. on overflow the parameters and the whole state kept (the count
   included, so the learning rate holds);
6. master-free bf16: the fp32 sum ``p + u`` rounded stochastically;
7. the compute-dtype copy (the cast cache) re-cast from the parameters.

The optimizers:

- ``FusedAdam``: Adam / AdamW as the one-pass fused kernel K6
  (``ops/fused_update.fused_adam_apply``), the default of the Adam
  family (``optimizer.params.fused`` on), which folds steps 1-7 into its
  pass;
- ``AdamChain`` (``fused: false``), ``Lamb``, ``SGD``, ``Adagrad``,
  ``RMSprop`` and ``Lion``: the optax chains ``build_optimizer`` of the
  JAX package builds, with optax 0.2.6's formulas, defaults and state,
  as plain PyTorch over the flat buffers (the JAX package computes them
  with optax, outside any Pallas kernel, so there is no TPU kernel to
  port). Their state is ``FlatState``: the count and, by the name optax
  gives it, one fp32 buffer per group in the groups' layout;
- ``TorchOptimizer``: a ``torch.optim`` optimizer over the fp32 master
  leaves (the ds_config name fall-through, and client optimizers of the
  reference's form). At ZeRO 1-3 across ranks it steps this rank's
  part of each leaf, which the elementwise classes allow
  (``ELEMENTWISE_TORCH_OPTIM``); its checkpoint is ``torch.optim``'s
  ``state_dict``, one a rank.

The count is the optax chain's: it feeds the schedule (optax's
``ScaleByScheduleState.count``) and the bias correction, and an
overflow-skipped step does not advance it.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, NamedTuple, Optional, \
    Tuple, Union

import torch

from .. import constants as C
from ..runtime.utils import clip_coefficient
from ..utils.logging import logger
from .fused_update import (FlatGroup, FusedAdamState, ShardGroup,
                           _int32, fused_adam_apply, sqnorm,
                           stochastic_round_indexed)

ScheduleOrFloat = Union[Callable, float]
Group = Union[FlatGroup, ShardGroup]

# The JAX optimizer file's leaf list (``tree_leaves`` of the optax state):
# each entry a count leaf or a named per-parameter buffer, leaf by leaf.
COUNT = "count"


def _common(params: Dict[str, Any]):
    lr = params.get("lr", 1e-3)
    betas = params.get("betas", (0.9, 0.999))
    eps = params.get("eps", 1e-8)
    weight_decay = params.get("weight_decay", 0.0)
    return lr, tuple(betas), eps, weight_decay


class FlatState(NamedTuple):
    """The state of an optax-chain optimizer: ``count`` (int32, the
    updates taken) and ``bufs``, one fp32 buffer per group under each of
    the state's names (``mu``, ``nu``, ``trace``, ``sum_of_squares``),
    in the groups' layout."""
    count: torch.Tensor
    bufs: Dict[str, Tuple[torch.Tensor, ...]]


def state_buffers(state: Any) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """The per-group buffers of an optimizer state by name (the fused
    Adam's ``m``/``v``; 1-bit Adam's ``m``, ``v``, ``worker_error``,
    ``server_error``)."""
    if isinstance(state, FusedAdamState):
        return {"m": state.m, "v": state.v}
    if isinstance(state, FlatState):
        return state.bufs
    from .onebit import STATE_BUFFERS, OnebitState
    if isinstance(state, OnebitState):
        return {name: getattr(state, name) for name in STATE_BUFFERS}
    return {}


class FlatOptimizer:
    """The interface of the engine's optimizers (module docstring).

    A subclass supplies ``init(groups)`` and ``_apply`` (its update of
    every group, in place); ``jax_layout`` names its state's leaves in
    the order of the JAX optimizer file."""

    def __init__(self, learning_rate: ScheduleOrFloat):
        self.learning_rate = learning_rate

    def lr_at(self, count: Any) -> torch.Tensor:
        """The learning rate at ``count`` as an fp32 device tensor (a
        Python float is filled in on the device, never copied from the
        host, which would sync the host with the card)."""
        lr = self.learning_rate(count) if callable(self.learning_rate) \
            else self.learning_rate
        if isinstance(lr, torch.Tensor):
            return lr.to(torch.float32)
        return torch.full((), float(lr), dtype=torch.float32,
                          device=count.device)

    def init(self, groups: List[Group]) -> Any:
        raise NotImplementedError

    def jax_layout(self) -> List[str]:
        """The JAX optimizer file's leaves: ``COUNT`` or a buffer name
        (then one leaf per parameter leaf, in tree order)."""
        raise NotImplementedError

    def step(self, groups: List[Group], state: Any, *, clip: float = 0.0,
             inv_scale: Optional[torch.Tensor] = None, fp16: bool = False,
             compute_norm: bool = True,
             sr_seed: Optional[torch.Tensor] = None,
             norm_reduce: Optional[Callable[[torch.Tensor], Any]] = None,
             norm_mask: Optional[List[bool]] = None,
             norm_cross: Optional[Callable[[torch.Tensor], Any]] = None
             ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
        """One clipped update of every group, in place on the groups'
        params (and cast copies) and the state's buffers.
        ``inv_scale`` unscales the accumulated grads (fp16 loss scale,
        and 1/dp across ranks); ``sr_seed`` (int32 0-dim) rounds bf16
        groups stochastically (master-free). ``ShardGroup``s are a
        rank's rows: ``norm_reduce`` (an in-place all-reduce) sums what
        a norm needs over the ranks. ``norm_mask`` (one flag a group):
        the groups the norm counts (a pipeline stage leaves out the tied
        leaves another stage counts); ``norm_cross`` then sums the
        norm's square over the pipeline stages. Returns ``(state, grad_norm,
        overflow)``; ``grad_norm`` is -1 when not computed."""
        dev = state.count.device
        f32 = torch.float32
        inv = None if inv_scale is None else inv_scale.to(f32)
        if compute_norm:
            nsq = torch.zeros((), dtype=f32, device=dev)
            for gi, grp in enumerate(groups):
                if norm_mask is None or norm_mask[gi]:
                    nsq = nsq + sqnorm(grp.grad)
            if norm_reduce is not None:
                norm_reduce(nsq)
            if norm_cross is not None:
                norm_cross(nsq)
            # the norm of the UNSCALED grads: ||g*inv|| == inv * ||g||.
            grad_norm = torch.sqrt(nsq) * (inv if inv is not None else 1.0)
        else:
            grad_norm = torch.full((), -1.0, dtype=f32, device=dev)
        if fp16:
            # inf/nan anywhere in the grads make the sum of squares
            # non-finite: the norm read doubles as the overflow vote.
            overflow = torch.logical_not(torch.isfinite(grad_norm))
        else:
            overflow = torch.zeros((), dtype=torch.bool, device=dev)
        coeff = clip_coefficient(grad_norm, clip) \
            if compute_norm and clip and clip > 0 else None
        state = self._apply(groups, state, inv=inv, coeff=coeff,
                            overflow=overflow if fp16 else None,
                            sr_seed=sr_seed, norm_reduce=norm_reduce)
        return state, grad_norm, overflow

    def _apply(self, groups, state, *, inv, coeff, overflow, sr_seed,
               norm_reduce):
        raise NotImplementedError


# --------------------------------------------------------------------- #
# The fused Adam (K6)
# --------------------------------------------------------------------- #
class FusedAdam(FlatOptimizer):
    """Adam / AdamW as the one-pass fused step (``fused_adam`` of the JAX
    module). ``adam_w_mode=True`` decays decoupled (``optax.adamw``);
    False folds L2 decay into the gradient before the moments."""

    def __init__(self, learning_rate: ScheduleOrFloat, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.adam_w_mode = bool(adam_w_mode)

    def init(self, groups: List[Group]) -> FusedAdamState:
        dev = groups[0].param.device
        def zeros():
            return tuple(torch.zeros(grp.numel, dtype=torch.float32,
                                     device=dev) for grp in groups)
        return FusedAdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            m=zeros(), v=zeros())

    def _base_scalars(self, count: torch.Tensor,
                      inv_scale: Optional[torch.Tensor]) -> torch.Tensor:
        """[neg_lr, bc1, bc2, inv]: bias correction as optax evaluates
        it (``1 - b ** (count + 1)`` in fp32), ``neg_lr = -1 * lr``."""
        one = torch.ones((), dtype=torch.float32, device=count.device)
        bc1, bc2 = bias_corrections(count, self.b1, self.b2)
        neg_lr = -one * self.lr_at(count)
        inv = one if inv_scale is None else inv_scale
        return torch.stack([neg_lr, bc1, bc2, inv])

    def _apply(self, groups, state, *, inv, coeff, overflow, sr_seed,
               norm_reduce):
        dev = state.count.device
        f32 = torch.float32
        base = self._base_scalars(state.count, inv)
        one = torch.ones((), dtype=f32, device=dev)
        zero = torch.zeros((), dtype=f32, device=dev)
        skip = overflow.to(f32) if overflow is not None else zero
        scalars = torch.stack([base[0], base[1], base[2],
                               coeff if coeff is not None else one,
                               base[3], skip, zero, zero])
        for gi, grp in enumerate(groups):
            sr = sr_seed is not None and grp.dtype == torch.bfloat16
            fused_adam_apply(
                grp.grad, grp.param, state.m[gi], state.v[gi], scalars,
                _group_seed(sr_seed, gi, grp, dev),
                b1=self.b1, b2=self.b2, eps=self.eps, wd=self.weight_decay,
                coupled=not self.adam_w_mode, use_inv=inv is not None,
                use_coeff=coeff is not None, one_pass=True, sr=sr,
                cast_out=None if sr else grp.cast)
        return FusedAdamState(_advance(state.count, overflow), state.m,
                              state.v)


def bias_corrections(count: torch.Tensor, b1: float, b2: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``1 - b ** (count + 1)`` for both decays, in fp32 (optax's
    ``bias_correction`` at ``safe_increment(count)``)."""
    f32 = torch.float32
    count_inc = (count + 1).to(f32)
    one = torch.ones((), dtype=f32, device=count.device)
    return (one - torch.pow(torch.full_like(one, b1), count_inc),
            one - torch.pow(torch.full_like(one, b2), count_inc))


def _group_seed(sr_seed: Optional[torch.Tensor], gi: int, grp: Group,
                dev: torch.device) -> torch.Tensor:
    """[sr seed, the group's first element in the V-layout] (the JAX
    seed row: the base as an int32 that wraps as uint32)."""
    return torch.stack([
        (sr_seed + gi) if sr_seed is not None else
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.full((), _int32(grp.base), dtype=torch.int32,
                   device=dev)]).to(torch.int32)


def _advance(count: torch.Tensor, overflow: Optional[torch.Tensor]
             ) -> torch.Tensor:
    if overflow is None:
        return count + 1
    return count + torch.logical_not(overflow).to(torch.int32)


# --------------------------------------------------------------------- #
# The optax chains, as plain PyTorch over the flat buffers
# --------------------------------------------------------------------- #
class _Ctx(NamedTuple):
    """What an optimizer's update of one group reads besides the grads,
    the params and its buffers."""
    grp: Group
    neg_lr: torch.Tensor          # -1 * lr(count), fp32
    count: torch.Tensor           # the count before this update
    norm_reduce: Optional[Callable[[torch.Tensor], Any]]


class OptaxChain(FlatOptimizer):
    """An optax chain as plain PyTorch over the flat buffers. A subclass
    names its buffers and their initial values (``buffers``), the JAX
    file's leaf order (``jax_layout``) and its update of one group
    (``update``: the fp32 grads after the unscale and the clip, the fp32
    params, its buffers → the update to add to the params, the new
    buffers), written in the chain's order of operations."""

    def buffers(self) -> Dict[str, float]:
        """Each buffer's name and initial value."""
        return {}

    def init(self, groups: List[Group]) -> FlatState:
        dev = groups[0].param.device
        bufs = {}
        for name, value in self.buffers().items():
            # optax fills its state like the params (full_like): a value
            # rounded to a bf16 group's dtype starts there (master-free).
            bufs[name] = tuple(
                torch.full((grp.numel,), value, dtype=grp.dtype,
                           device=dev).to(torch.float32) for grp in groups)
        return FlatState(torch.zeros((), dtype=torch.int32, device=dev),
                         bufs)

    def update(self, g: torch.Tensor, p: torch.Tensor,
               bufs: Dict[str, torch.Tensor], ctx: _Ctx
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def _apply(self, groups, state, *, inv, coeff, overflow, sr_seed,
               norm_reduce):
        dev = state.count.device
        neg_lr = -1.0 * self.lr_at(state.count)
        for gi, grp in enumerate(groups):
            # (the JAX engine's unscale, then clip_grad_norm_'s multiply)
            g = grp.grad
            if inv is not None:
                g = g * inv
            if coeff is not None:
                g = g * coeff
            p32 = grp.param.to(torch.float32)
            old = {name: bufs[gi] for name, bufs in state.bufs.items()}
            u, new = self.update(g, p32, old, _Ctx(grp, neg_lr, state.count,
                                                   norm_reduce))
            summed = p32 + u
            if grp.dtype == torch.bfloat16 and sr_seed is not None:
                new_p = stochastic_round_indexed(
                    summed, _group_seed(sr_seed, gi, grp, dev))
            else:
                new_p = summed.to(grp.dtype)
            _commit(grp.param, new_p, overflow)
            for name, t in new.items():
                _commit(old[name], t, overflow)
            if grp.cast is not None:
                grp.cast.copy_(grp.param)
        return FlatState(_advance(state.count, overflow), state.bufs)


def _commit(dst: torch.Tensor, new: torch.Tensor,
            overflow: Optional[torch.Tensor]) -> None:
    """``dst`` takes ``new``, or keeps its value where the step
    overflowed (a select on the device: no host sync)."""
    if overflow is None:
        dst.copy_(new)
    else:
        torch.where(overflow, dst, new, out=dst)


def _moments(g, bufs, b1, b2):
    """optax ``update_moment`` (order 1) and ``update_moment_per_elem_
    norm`` (order 2): ``(1 - b) * g**k + b * t``."""
    mu = (1 - b1) * g + b1 * bufs["mu"]
    nu = (1 - b2) * (g * g) + b2 * bufs["nu"]
    return mu, nu


def _scale_by_adam(g, bufs, ctx, b1, b2, eps):
    """optax ``scale_by_adam`` (eps_root 0): the bias-corrected moments'
    ratio and the new moments."""
    mu, nu = _moments(g, bufs, b1, b2)
    bc1, bc2 = bias_corrections(ctx.count, b1, b2)
    return (mu / bc1) / (torch.sqrt(nu / bc2) + eps), {"mu": mu, "nu": nu}


class AdamChain(OptaxChain):
    """Adam / AdamW unfused (``optimizer.params.fused: false``): with
    ``adam_w_mode`` ``optax.adamw`` (scale_by_adam → add_decayed_weights
    → scale_by_learning_rate); else the coupled chain
    add_decayed_weights → scale_by_adam → scale_by_learning_rate (the
    decay left out at 0, ``optax.adam``)."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, adam_w_mode=True):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.adam_w_mode = bool(adam_w_mode)

    def buffers(self):
        return {"mu": 0.0, "nu": 0.0}

    def jax_layout(self):
        return [COUNT, "mu", "nu", COUNT]

    def update(self, g, p, bufs, ctx):
        wd = self.weight_decay
        if wd and not self.adam_w_mode:
            g = g + wd * p
        u, new = _scale_by_adam(g, bufs, ctx, self.b1, self.b2, self.eps)
        if wd and self.adam_w_mode:
            u = u + wd * p
        return ctx.neg_lr * u, new


class Lamb(AdamChain):
    """Lamb as the JAX package builds it (the reference's FusedLamb):
    scale_by_adam → add_decayed_weights → the per-leaf trust ratio
    ``||p|| / ||u||`` (1 where either norm is 0) clamped to
    [min_coeff, max_coeff] → scale_by_learning_rate. The norms are each
    leaf's, in fp32: over a ``FlatGroup`` each leaf is one contiguous
    range; over a rank's ``ShardGroup`` rows each leaf is one column
    range of every row, so the squares summed over the rows are segment-
    summed by leaf and the ``[2, leaves]`` sums all-reduced over the
    ranks (the zero padding adds nothing). The ratio is applied a leaf
    at a time, in place on the update."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, min_coeff=0.01, max_coeff=10.0):
        super().__init__(learning_rate, b1, b2, eps, weight_decay, True)
        self.min_coeff, self.max_coeff = float(min_coeff), float(max_coeff)

    def update(self, g, p, bufs, ctx):
        u, new = _scale_by_adam(g, bufs, ctx, self.b1, self.b2, self.eps)
        if self.weight_decay:
            u = u + self.weight_decay * p
        sums = torch.stack([_leaf_sums(p * p, ctx.grp),
                            _leaf_sums(u * u, ctx.grp)])
        if ctx.norm_reduce is not None and isinstance(ctx.grp, ShardGroup):
            ctx.norm_reduce(sums)
        p_norm, u_norm = torch.sqrt(sums[0]), torch.sqrt(sums[1])
        ratio = torch.where((p_norm > 0.0) & (u_norm > 0.0),
                            p_norm / u_norm, torch.ones_like(p_norm))
        ratio = torch.clamp(ratio, self.min_coeff, self.max_coeff)
        return ctx.neg_lr * _leaf_scale_(u, ratio, ctx.grp), new


def _leaf_segments(grp: Group
                   ) -> Tuple[List[List[Tuple[int, int]]], int, int]:
    """``([[(offset, length)] a leaf], rows, row length)``: a
    ``FlatGroup`` is one row of contiguous leaves; a ``ShardGroup``
    ``rows_per_rank`` rows of ``Lpad`` columns, each leaf a column range
    (a range a layer slice in the per-layer form)."""
    if isinstance(grp, ShardGroup):
        if grp.ranged:
            raise NotImplementedError(
                "Lamb's per-leaf trust ratio at a dp that does not divide "
                f"V = {grp.shards} (a rank's range cuts leaves across rows) "
                "is not ported yet (ROADMAP queue 1 item 6's leftovers)")
        return grp.segments(), grp.rows_per_rank, grp.Lpad
    return [[seg] for seg in zip(grp.offsets, grp.sizes)], 1, grp.numel


def _leaf_sums(sq: torch.Tensor, grp: Group) -> torch.Tensor:
    """Each leaf's sum of the (non-negative) flat ``sq``, fp32
    ``[leaves]``: one multi-tensor reduction over the leaves' ranges
    (of the column sums, for rows); a leaf of several ranges adds their
    sums in order."""
    segs, rows, width = _leaf_segments(grp)
    x = sq.view(rows, width).sum(0) if rows > 1 else sq
    sums = torch._foreach_norm([x.narrow(0, off, n) for leaf in segs
                                for off, n in leaf], 1)
    out, k = [], 0
    for leaf in segs:
        acc = sums[k]
        for extra in sums[k + 1:k + len(leaf)]:
            acc = acc + extra
        out.append(acc)
        k += len(leaf)
    return torch.stack(out)


def _leaf_scale_(u: torch.Tensor, per_leaf: torch.Tensor,
                 grp: Group) -> torch.Tensor:
    """``u`` (flat, the group's layout) times each leaf's value of
    ``per_leaf`` on that leaf's elements, in place: one multiply a
    range (the padding, where ``u`` is 0, is left as it is)."""
    segs, rows, width = _leaf_segments(grp)
    u2 = u.view(rows, width)
    for leaf, r in zip(segs, per_leaf.unbind()):
        for off, n in leaf:
            u2.narrow(1, off, n).mul_(r)
    return u


class SGD(OptaxChain):
    """``optax.sgd``: the trace ``t = g + momentum * t`` (Nesterov: the
    update ``g + momentum * t``) → scale_by_learning_rate; with weight
    decay add_decayed_weights first. No trace at momentum 0."""

    def __init__(self, learning_rate, momentum=0.0, nesterov=False,
                 weight_decay=0.0):
        super().__init__(learning_rate)
        self.momentum = float(momentum or 0.0)
        self.nesterov = bool(nesterov)
        self.weight_decay = float(weight_decay)

    def buffers(self):
        return {"trace": 0.0} if self.momentum else {}

    def jax_layout(self):
        return ["trace", COUNT] if self.momentum else [COUNT]

    def update(self, g, p, bufs, ctx):
        if self.weight_decay:
            g = g + self.weight_decay * p
        if not self.momentum:
            return ctx.neg_lr * g, {}
        t = g + self.momentum * bufs["trace"]
        u = g + self.momentum * t if self.nesterov else t
        return ctx.neg_lr * u, {"trace": t}


class Adagrad(OptaxChain):
    """``optax.adagrad``: scale_by_rss (``s = g*g + s`` from
    ``initial_accumulator_value`` 0.1; the update ``g * rsqrt(s + eps)``,
    0 where ``s`` is 0) → scale_by_learning_rate."""

    def __init__(self, learning_rate, eps=1e-10,
                 initial_accumulator_value=0.1):
        super().__init__(learning_rate)
        self.eps = float(eps)
        self.initial = float(initial_accumulator_value)

    def buffers(self):
        return {"sum_of_squares": self.initial}

    def jax_layout(self):
        return ["sum_of_squares", COUNT]

    def update(self, g, p, bufs, ctx):
        s = g * g + bufs["sum_of_squares"]
        inv = torch.where(s > 0, torch.rsqrt(s + self.eps),
                          torch.zeros_like(s))
        return ctx.neg_lr * (inv * g), {"sum_of_squares": s}


class RMSprop(OptaxChain):
    """``optax.rmsprop`` (0.2.6 defaults: eps inside the root, initial
    scale 0): scale_by_rms (``nu = (1 - decay) * g*g + decay * nu``, the
    update ``g * rsqrt(nu + eps)``) → scale_by_learning_rate → the trace
    (``t = u + momentum * t``), which exists at momentum 0 too."""

    def __init__(self, learning_rate, decay=0.99, eps=1e-8, momentum=0.0):
        super().__init__(learning_rate)
        self.decay, self.eps = float(decay), float(eps)
        self.momentum = float(momentum)

    def buffers(self):
        return {"nu": 0.0, "trace": 0.0}

    def jax_layout(self):
        return ["nu", COUNT, "trace"]

    def update(self, g, p, bufs, ctx):
        nu = (1 - self.decay) * (g * g) + self.decay * bufs["nu"]
        u = ctx.neg_lr * (torch.rsqrt(nu + self.eps) * g)
        t = u + self.momentum * bufs["trace"]
        return t, {"nu": nu, "trace": t}


class Lion(OptaxChain):
    """``optax.lion``: scale_by_lion (the update ``sign((1 - b1) * g +
    b1 * mu)``, then ``mu = (1 - b2) * g + b2 * mu``) →
    add_decayed_weights → scale_by_learning_rate."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, weight_decay=0.0):
        super().__init__(learning_rate)
        self.b1, self.b2 = float(b1), float(b2)
        self.weight_decay = float(weight_decay)

    def buffers(self):
        return {"mu": 0.0}

    def jax_layout(self):
        return [COUNT, "mu", COUNT]

    def update(self, g, p, bufs, ctx):
        u = torch.sign((1 - self.b1) * g + self.b1 * bufs["mu"])
        mu = (1 - self.b2) * g + self.b2 * bufs["mu"]
        if self.weight_decay:
            u = u + self.weight_decay * p
        return ctx.neg_lr * u, {"mu": mu}


LeafState = Dict[str, List[torch.Tensor]]


def reference_step(opt: OptaxChain, params: List[torch.Tensor],
                   grads: List[torch.Tensor], state: LeafState, count: int
                   ) -> Tuple[List[torch.Tensor], LeafState]:
    """The plain reference of an optax chain's step: the update written
    again leaf by leaf, in the chain's order of operations, on fp32
    params and the already unscaled and clipped fp32 grads, at the
    count before the step. Returns the new fp32 params (``p + u``) and
    state (by buffer name, a list of leaves); the inputs are not
    modified. The flat optimizers are held against it (on the card,
    ``chip_smoke.py``; on the CPU, itself against optax)."""
    n = len(params)
    f32 = torch.float32
    dev = params[0].device
    lr = opt.learning_rate(count) if callable(opt.learning_rate) \
        else opt.learning_rate
    neg_lr = -1.0 * torch.as_tensor(lr, dtype=f32, device=dev)
    c = torch.tensor(count + 1, dtype=f32, device=dev)
    new: Dict[str, List[torch.Tensor]] = {k: [] for k in state}
    out = []
    for i in range(n):
        p, g = params[i].to(f32), grads[i].to(f32)
        s = {k: v[i] for k, v in state.items()}
        if isinstance(opt, (AdamChain, Lamb)):
            wd = opt.weight_decay
            if isinstance(opt, AdamChain) and not isinstance(opt, Lamb) \
                    and wd and not opt.adam_w_mode:
                g = g + wd * p
            mu = (1 - opt.b1) * g + opt.b1 * s["mu"]
            nu = (1 - opt.b2) * (g * g) + opt.b2 * s["nu"]
            bc1 = 1 - torch.pow(torch.tensor(opt.b1, device=dev), c)
            bc2 = 1 - torch.pow(torch.tensor(opt.b2, device=dev), c)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + opt.eps)
            if wd and (isinstance(opt, Lamb) or opt.adam_w_mode):
                u = u + wd * p
            if isinstance(opt, Lamb):
                pn, un = torch.linalg.vector_norm(p), \
                    torch.linalg.vector_norm(u)
                ratio = torch.where((pn > 0) & (un > 0), pn / un,
                                    torch.ones_like(pn))
                u = u * torch.clamp(ratio, opt.min_coeff, opt.max_coeff)
            u = neg_lr * u
            new["mu"].append(mu)
            new["nu"].append(nu)
        elif isinstance(opt, SGD):
            if opt.weight_decay:
                g = g + opt.weight_decay * p
            if opt.momentum:
                t = g + opt.momentum * s["trace"]
                new["trace"].append(t)
                g = g + opt.momentum * t if opt.nesterov else t
            u = neg_lr * g
        elif isinstance(opt, Adagrad):
            ss = g * g + s["sum_of_squares"]
            new["sum_of_squares"].append(ss)
            u = neg_lr * (torch.where(ss > 0, torch.rsqrt(ss + opt.eps),
                                      torch.zeros_like(ss)) * g)
        elif isinstance(opt, RMSprop):
            nu = (1 - opt.decay) * (g * g) + opt.decay * s["nu"]
            u = neg_lr * (torch.rsqrt(nu + opt.eps) * g)
            u = u + opt.momentum * s["trace"]
            new["nu"].append(nu)
            new["trace"].append(u)
        elif isinstance(opt, Lion):
            u = torch.sign((1 - opt.b1) * g + opt.b1 * s["mu"])
            new["mu"].append((1 - opt.b2) * g + opt.b2 * s["mu"])
            if opt.weight_decay:
                u = u + opt.weight_decay * p
            u = neg_lr * u
        else:
            raise TypeError(f"no reference step for {type(opt).__name__}")
        out.append(p + u)
    return out, new


# --------------------------------------------------------------------- #
# torch.optim optimizers (the name fall-through and client optimizers)
# --------------------------------------------------------------------- #
# The torch.optim classes whose step is elementwise: an element's update
# reads only that element's grad, parameter and state, so each rank can
# step its own part of each leaf (ZeRO 1-3) and get the bits of the
# whole-leaf step. The others depend on a parameter's shape or whole
# norm, or take a closure, and run only where the groups hold whole
# parameters.
ELEMENTWISE_TORCH_OPTIM = frozenset({
    "SGD", "Adam", "AdamW", "Adagrad", "Adadelta", "Adamax", "ASGD",
    "NAdam", "RAdam", "RMSprop", "Rprop"})
_NOT_ELEMENTWISE = {
    "Adafactor": "factors its second moment over a parameter's rows and "
                 "columns",
    "LBFGS": "takes a closure and searches along the whole flat "
             "parameter",
    "SparseAdam": "takes sparse gradients of whole embedding rows",
    "Muon": "orthogonalizes each whole weight matrix",
}


class TorchOptimizer(FlatOptimizer):
    """A ``torch.optim`` optimizer over the fp32 master leaves (views of
    the flat groups): ``factory(params)`` builds it at ``init``; each
    step hands it the unscaled, clipped grads as the leaves' ``.grad``
    and sets every param group's ``lr`` from the schedule at the count.
    At ZeRO 1-3 across ranks (``ShardGroup``s) its parameters are this
    rank's part of each leaf, one tensor a leaf slice (a ``[V/dp, r]``
    block of the rows; the group's range where dp does not divide V),
    which is exact for the elementwise classes
    (``ELEMENTWISE_TORCH_OPTIM``); another class raises there. An fp16
    step reads the overflow vote on the host (one sync) and skips
    ``step()`` on overflow; the count is kept on the host too, so the
    schedule is evaluated at a Python int."""

    def __init__(self, factory: Callable[[List[torch.Tensor]], Any],
                 learning_rate: ScheduleOrFloat, name: str):
        super().__init__(learning_rate)
        self.factory = factory
        self.name = name
        self.opt: Optional[torch.optim.Optimizer] = None
        self._leaves: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._count = 0

    def init(self, groups: List[Group]) -> FlatState:
        for grp in groups:
            if grp.dtype != torch.float32:
                raise ValueError(
                    f"{self.name} updates fp32 master parameters; bf16."
                    "stochastic_rounding (master-free bf16) has none")
        sharded = any(isinstance(grp, ShardGroup) for grp in groups)
        self._leaves = [(p, g) for grp in groups
                        for p, g in zip(*(
                            (grp.local_views(grp.param),
                             grp.local_views(grp.grad))
                            if isinstance(grp, ShardGroup) else
                            (grp.views(grp.param), grp.views(grp.grad))))]
        self.opt = self.factory([p for p, _ in self._leaves])
        if not isinstance(self.opt, torch.optim.Optimizer):
            raise TypeError(f"the optimizer factory returned a "
                            f"{type(self.opt).__name__}, not a "
                            "torch.optim.Optimizer")
        cls = type(self.opt).__name__
        if sharded and cls not in ELEMENTWISE_TORCH_OPTIM:
            why = _NOT_ELEMENTWISE.get(
                cls, "its step is not known to be elementwise (it may "
                "read a parameter's shape or whole norm)")
            raise NotImplementedError(
                f"{self.name} at ZeRO stages 1-3 across ranks: each rank "
                f"steps only its part of each leaf, and {cls} {why}; run it "
                "at ZeRO stage 0 or dp 1, where the groups hold whole "
                "parameters")
        return FlatState(torch.zeros((), dtype=torch.int32,
                                     device=groups[0].param.device), {})

    def _host_lr(self) -> float:
        lr = self.learning_rate(self._count) \
            if callable(self.learning_rate) else self.learning_rate
        return float(lr)

    def _apply(self, groups, state, *, inv, coeff, overflow, sr_seed,
               norm_reduce):
        if overflow is not None and bool(overflow):
            return state
        for grp in groups:
            if inv is not None:
                grp.grad.mul_(inv)
            if coeff is not None:
                grp.grad.mul_(coeff)
        lr = self._host_lr()
        for pg in self.opt.param_groups:
            pg["lr"] = lr
        for p, g in self._leaves:
            p.grad = g
        self.opt.step()
        for grp in groups:
            if grp.cast is not None:
                grp.cast.copy_(grp.param)
        self._count += 1
        return FlatState(state.count + 1, {})

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self._count, "optimizer": self.opt.state_dict()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self._count = int(sd["count"])
        self.opt.load_state_dict(sd["optimizer"])

    def jax_layout(self) -> List[str]:
        raise ValueError(
            f"{self.name}'s state is torch.optim's per-parameter "
            "state_dict, which the JAX checkpoint layout cannot hold: save "
            "engine.optimizer.state_dict() with torch.save instead")


def torch_optim_class(name: str) -> Optional[type]:
    """The ``torch.optim`` optimizer class whose lower-cased name is
    ``name``, if any."""
    for attr in dir(torch.optim):
        cls = getattr(torch.optim, attr)
        if isinstance(cls, type) and issubclass(cls, torch.optim.Optimizer) \
                and attr.lower() == name and cls is not torch.optim.Optimizer:
            return cls
    return None


# --------------------------------------------------------------------- #
# Construction
# --------------------------------------------------------------------- #
def build_optimizer(name: str, params: Dict[str, Any],
                    schedule_fn: ScheduleOrFloat = None) -> FlatOptimizer:
    """Build the optimizer of a ds_config ``optimizer`` section, with
    the JAX package's defaults. ``schedule_fn`` (step -> lr) overrides
    the static ``lr``."""
    name = name.lower()
    lr, betas, eps, weight_decay = _common(params)
    learning_rate = schedule_fn if schedule_fn is not None else lr
    if name in (C.ADAM_OPTIMIZER, C.ADAMW_OPTIMIZER):
        adam_w_mode = params.get("adam_w_mode", name == C.ADAMW_OPTIMIZER)
        cls = FusedAdam if params.get(C.OPTIMIZER_FUSED,
                                      C.OPTIMIZER_FUSED_DEFAULT) \
            else AdamChain
        return cls(learning_rate, b1=betas[0], b2=betas[1], eps=eps,
                   weight_decay=weight_decay, adam_w_mode=adam_w_mode)
    if name == C.ONEBIT_ADAM_OPTIMIZER:
        from .onebit import OnebitAdam
        return OnebitAdam(learning_rate, b1=betas[0], b2=betas[1], eps=eps,
                          weight_decay=weight_decay,
                          freeze_step=int(params.get("freeze_step", 100000)))
    if name == C.LAMB_OPTIMIZER:
        return Lamb(learning_rate, b1=betas[0], b2=betas[1], eps=eps,
                    weight_decay=weight_decay,
                    min_coeff=float(params.get("min_coeff", 0.01)),
                    max_coeff=float(params.get("max_coeff", 10.0)))
    if name == C.SGD_OPTIMIZER:
        return SGD(learning_rate, momentum=params.get("momentum", 0.0),
                   nesterov=params.get("nesterov", False),
                   weight_decay=weight_decay)
    if name == C.ADAGRAD_OPTIMIZER:
        return Adagrad(learning_rate, eps=params.get("eps", 1e-10))
    if name == C.RMSPROP_OPTIMIZER:
        return RMSprop(learning_rate, decay=params.get("alpha", 0.99),
                       eps=eps, momentum=params.get("momentum", 0.0))
    if name == C.LION_OPTIMIZER:
        return Lion(learning_rate, b1=betas[0], b2=betas[1],
                    weight_decay=weight_decay)
    # The reference's fall-through (engine.py:624-628): the torch.optim
    # class of that name, built with the section's params.
    cls = torch_optim_class(name)
    if cls is None or cls is torch.optim.LBFGS:
        raise ValueError(f"Unknown optimizer '{name}'")
    logger.info(f"Using torch.optim.{cls.__name__} for optimizer '{name}'")
    kwargs = dict(params)
    return TorchOptimizer(lambda leaves: cls(leaves, **kwargs),
                          learning_rate, f"torch.optim.{cls.__name__}")


CLIENT_OPTIMIZER_ERROR = (
    "optimizer must be a deepspeed_tpu_torch optimizer (ops.optimizers."
    "FlatOptimizer), callable(schedule_fn) -> one, or a torch.optim."
    "Optimizer subclass or factory (params) -> torch.optim.Optimizer")


def client_optimizer(client: Any, schedule_fn: ScheduleOrFloat,
                     base_lr: float) -> FlatOptimizer:
    """The engine's optimizer from a client's ``optimizer`` argument:
    the port's counterparts of the JAX engine's two forms (an optimizer
    of this module, or ``callable(schedule_fn)`` that returns one), or
    the reference's own form, a ``torch.optim.Optimizer`` subclass
    (built over the master leaves with ``lr=base_lr``) or a factory
    whose first parameter is named ``params``."""
    if isinstance(client, FlatOptimizer):
        return client
    if isinstance(client, type) and issubclass(client, torch.optim.Optimizer):
        return TorchOptimizer(lambda leaves: client(leaves, lr=base_lr),
                              schedule_fn, f"torch.optim.{client.__name__}")
    if isinstance(client, torch.optim.Optimizer):
        raise TypeError(
            CLIENT_OPTIMIZER_ERROR + ": a torch.optim.Optimizer instance "
            "holds tensors the engine does not train (it trains flat "
            "copies of model_params); pass its class or a factory")
    if callable(client):
        try:
            first = next(iter(inspect.signature(client).parameters), None)
        except (TypeError, ValueError):
            first = None
        if first == "params":
            return TorchOptimizer(client, schedule_fn,
                                  getattr(client, "__name__", "factory"))
        out = client(schedule_fn)
        if isinstance(out, FlatOptimizer):
            return out
    raise TypeError(CLIENT_OPTIMIZER_ERROR)


__all__ = ["FlatOptimizer", "FlatState", "FusedAdam", "AdamChain", "Lamb",
           "SGD", "Adagrad", "RMSprop", "Lion", "TorchOptimizer",
           "OptaxChain", "build_optimizer", "client_optimizer",
           "state_buffers", "bias_corrections", "torch_optim_class",
           "reference_step", "COUNT", "ELEMENTWISE_TORCH_OPTIM"]
