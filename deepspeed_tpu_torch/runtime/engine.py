"""The training engine, on one card or one process per card (port of
``deepspeed_tpu/runtime/engine.py::DeepSpeedEngine``, its main path).

``train_batch`` runs one iteration: for each of the gas micro-batches
the loss (scaled by the fp16 loss scale and divided by gas), its
gradients by autograd, and their sum into the fp32 flat gradient
buffers; then the optimizer step (``ops/optimizers.FlatOptimizer.step``:
grad norm, fp16 overflow vote, clip coefficient, the update — the fused
one-pass Adam by default, or Lamb, SGD, Adagrad, RMSprop, Lion, the
unfused Adam chains, a ``torch.optim`` optimizer — overflow skip and
the cast-copy refresh); then the overflow bookkeeping and the dynamic
loss scale. The reference's ``forward`` / ``backward`` / ``step`` trio
runs the same per-micro-batch forward and backward (``_forward_micro``,
``_backward_micro``) and, at the accumulation boundary, the same step
(``_apply_window``), so the two are bit-equal; ``eval_batch`` computes a
loss on the compute-dtype params without a graph. Every quantity of
the step stays a device tensor, so an iteration issues no host sync:
``train_batch`` returns the loss as a 0-dim tensor and the metrics dict
(``last_metrics``) holds tensors. With a ``moe`` block the loss_fn's MoE
stats, averaged over the micro-batches, join the metrics as
``moe_expert_tokens``, ``moe_drop_fraction``, ``moe_aux_loss`` and
``moe_z_loss``.

State. The parameters live in one contiguous flat buffer per dtype
group (fp32 masters, or bf16 with ``bf16.stochastic_rounding``), each
parameter a view into it; the fp32 gradients and the Adam moments live
in flat buffers of the same layout. With bf16/fp16 compute and masters
the engine keeps the compute-dtype copy of the parameters (the JAX
engine's cast cache) as one more flat buffer, which the optimizer
kernel rewrites in its pass. The loss is differentiated with respect to
the views of that copy (the parameters themselves in fp32 and
master-free runs); each micro-batch's gradients are added into the fp32
buffers, never accumulated by autograd in a bf16 ``.grad``.

Data parallelism and ZeRO. With a process group up
(``init_distributed``), each rank trains on its own ``gas * micro``
rows of the global batch and the engine syncs the grads by ZeRO stage,
with explicit collectives (the JAX engine's explicit schedule,
``_build_explicit_zero2_grads``):

- stage 0: the natural flat grads all-reduced, the whole-buffer K5/K6
  on every rank;
- stage 1 (and stage 2 with ``reduce_scatter: false``): all-reduced,
  then each rank updates its rows of the fused optimizer's V-layout
  (``ops/fused_update.ShardGroup``: the shard-local K5/K6, the sum of
  squares all-reduced, K6's noise index from the rank's base);
- stage 2: each micro-step's grads packed into the V-layout in fp32 and
  reduce-scattered, each rank accumulating its rows;
- stage 3: each rank holds only its rows of the masters; every
  micro-step gathers the leaves in the compute dtype
  (``zero/stage3.gather_cast``), saved for the backward pass as
  re-gathers, and the fp32 reduce-scatter is the gather's backward.

At stages 1-2 the updated rows are all-gathered into the natural
buffers the model views and the compute-dtype copy is re-cast from
them. The loss of each rank is its own rows' mean, so the summed grads
are dp times the global mean's: the kernel's unscale multiplies by
1/dp as well (exact for dp a power of two). The reported loss is the
global mean (one scalar all-reduce), and the fp16 overflow vote is
global through the all-reduced norm. At dp 1 none of this runs: every
stage is the one-card step.

Random stream. Each step draws its dropout masks and its stochastic-
rounding seed from a generator derived from the engine's base seed and
the step (``step_generator``; at dp > 1 the dropout stream is also
folded with the rank), as the JAX engine folds the step into its base
key, so a run resumed from a checkpoint draws what a run that never
stopped would have drawn.

Activation recomputation is the model's (``TransformerConfig.
remat_policy``, ``models/remat.py``): the engine differentiates the loss
as it is. A ``progressive_layer_drop`` block builds a
``ProgressiveLayerDrop``; each step passes ``theta_at(global_steps)`` (a
host float) as ``pld_theta`` to a loss_fn that takes it, on every path,
and the model draws which layers to skip on the host.

Checkpoints (``save_checkpoint``, ``load_checkpoint``, the
``checkpoint`` block's async saving, auto-save and SIGTERM save) are
the JAX package's files, read and written in both directions: the
model file ``mp_rank_00_model_states.msgpack`` (``{"module": params}``,
the fp32 masters, or bf16 without masters), the optimizer file
``zero_pp_rank_0_mp_rank_00_optim_states.msgpack`` (the fused Adam's
count and moments in the JAX V-interleaved layout, ``models/
convert.py``; an optax chain's state leaves, counts and per-parameter
buffers in tree order, whole leaves written by rank 0 at any dp; and the
loss-scale scalars), ``engine_meta.json`` (the counters, the seal of
the two-phase commit) and ``latest`` (runtime/async_ckpt.py). At dp > 1
there is one optimizer file per rank (``zero_pp_rank_{d}``): at ZeRO
stage >= 1 a rank's moment rows, gathered to rank 0, which writes
alone. A save from any dp (of the port or of JAX) loads at any dp
dividing 8 by joining the optimizer shards and taking this rank's rows.

ZeRO-Offload (``zero_optimization.cpu_offload`` at stage >= 1): the fp32
masters and the Adam moments live in host memory, in a
``zero/offload.ZeroOffloadOptimizer`` stepped by the host SIMD Adam
(``ops/cpu_adam.py``); the card keeps the compute-dtype parameters and
the fp32 grads (one flat buffer each, in leaf order) and runs no K5/K6.
After the grad pass the grads cross to pinned host memory bucket by
bucket (bf16 in bf16 runs, else fp32), the host runs the two-phase
bucketed step with its own loss-scale machine, and each bucket's
compute-dtype copy goes back; ``overlap_comm`` overlaps the copies with
the host work (one process only). At dp > 1 each rank holds its
partition of each leaf (its grads reduce-scattered along the leaf's
partition axis, the params all-gathered back); stage 3 with offload at
dp > 1 raises. The checkpoint is the JAX offload layout: ``{"offload":
state}`` in the optimizer file and the fp32 masters as the module.

The two stage-0 train steps that replace the grad all-reduce (the JAX
engine's ``_build_onebit_train_step`` and sparse-gradient step):

- 1-bit Adam (``OneBitAdam``, ``ops/onebit.OnebitAdam``): the same
  micro-steps, then no grad all-reduce: the warmup all-reduces the grads
  (mean) inside the optimizer's step, the compression stage only the
  compressed momentum. Whether a step compresses is known on the host
  from an upper bound on the step count, read off the card once, when
  the bound reaches ``freeze_step``. ``train_batch`` only, ZeRO stage 0,
  fp32 masters; ``onebit_comm_bytes`` is the step's payload a rank in
  the packed wire's accounting. The checkpoint is the JAX layout of its
  ``OnebitState`` (the worker error a rank's, on a leading [dp] axis).
- sparse gradients (``sparse_gradients``): at dp > 1 the marked
  embedding leaves' grads skip the all-reduce and travel as CSR rows
  (``_csr_exchange``: the row counts read on the host, the path's host
  syncs); the dense leaves are all-reduced; then the optimizer's step.
  At dp 1 the main path runs, as in JAX.

What the port does not run yet raises ``NotImplementedError``, naming
the ROADMAP slice that brings it: a dp that does not divide 8, MoE at
dp > 1, stage 3 with offload at dp > 1, the pipeline and the other
parallel axes, multi-slice meshes, MoE expert parallelism (ep > 1), a
``torch.optim`` optimizer at ZeRO stages 1-3 across ranks, the trio
under ZeRO-Offload, telemetry's profiler windows, and
``fused_kernels=False`` on CUDA.

Telemetry (``telemetry`` block, monitor/): the JAX engine's spine. Each
step path goes through the recompile sentinel (``train_step``,
``offload_grad_step``, ``sparse_grad_step``; the trio's ``grad_step``,
``grad_step_bwd`` and ``apply_grads``), each step's metrics (device
tensors, with the ``health_leaf_sq`` grad tap) ride the ring to the
drain at ``report_steps``, whose report carries the throughput, the
goodput window and the memory sample; the cost model is built at the
first boundary after every path of the step was walked (its first
call), and arms the per-step ``mfu``. ``flops_profiler`` walks the step
at ``profile_step``. Neither reads the card between boundaries.
"""
from __future__ import annotations

import contextlib
import inspect
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .async_ckpt import (AsyncCheckpointer, CheckpointSnapshot,
                         LATEST_FILE, META_FILE, PreemptSaver,
                         commit_snapshot, crash_point, is_complete)
from .config import DeepSpeedConfig
from .csr_tensor import CSRTensor, all_gather_csr
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .fp16.loss_scaler import LossScaleState, update_loss_scale
from .flax_msgpack import msgpack_restore, msgpack_serialize
from .lr_schedules import get_lr_schedule
from .progressive_layer_drop import ProgressiveLayerDrop
from .. import constants as C
from ..models import convert
from ..models.transformer import check_trainable
from ..ops.grouped_gemm import check_grouped_gemm
from ..ops.fused_update import (FlatGroup, FusedAdamState, ShardGroup,
                                _int32, float_groups, tree_flatten,
                                tree_unflatten)
from ..monitor.health import TapSpec, keystr_paths, leaf_sq_taps
from ..monitor.memory import analytic_state_bytes, device_memory_stats
from ..monitor.telemetry import HEALTH_TAP_KEY, Telemetry
from ..parallel import comm
from ..parallel.topology import dp_rank, dp_world_size
from ..parallel.wire_model import grad_sync_wire_model
from .zero.offload import ZeroOffloadOptimizer, run_bucketed_step
from .zero.partition import describe_sharding, row_plan
from .zero.stage3 import _gather, gather_tree, regather_saved
from ..ops.onebit import OnebitAdam, OnebitState, step_comm_bytes
from ..ops.optimizers import (COUNT, FusedAdam, FlatState, TorchOptimizer,
                              build_optimizer, client_optimizer,
                              state_buffers)
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger
from ..utils.timer import ThroughputTimer


MODEL_FILE = "mp_rank_00_model_states.msgpack"
OPTIM_FILE_FMT = "zero_pp_rank_0_mp_rank_00_optim_states.msgpack"
OPTIM_SHARD_FMT = "zero_pp_rank_{}_mp_rank_00_optim_states.msgpack"
# engine_meta.json's marker of the V-interleaved moment layout.
FUSED_MOMENT_LAYOUT = 2
# What the JAX engine folds into a step's key for its stochastic-
# rounding key (0x5352, "SR").
_SR_FOLD = 0x5352
# What eval_batch folds into the base seed for its default generators
# ("EV").
_EVAL_FOLD = 0x4556
_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A 64-bit seed for ``data`` under ``seed`` (the splitmix64 mix of
    the pair): the port's counterpart of ``jax.random.fold_in``."""
    z = (int(seed) ^ ((int(data) + 1) * 0x9E3779B97F4A7C15)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _leaf_paths(tree: Any, prefix: str = "") -> List[str]:
    """The leaves' key paths ("blocks/qkv_kernel") in ``tree_flatten``
    order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in _leaf_paths(t, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _host_copies(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Whole host copies of device tensors: into pinned memory by
    asynchronous copies and ONE wait on the card (the port's
    counterpart of the JAX engine's one batched ``device_get``); plain
    clones for CPU tensors. A copy, never a view: the fused step
    rewrites the flat buffers in place."""
    if not any(t.device.type == "cuda" for t in tensors):
        return [t.detach().clone() for t in tensors]
    out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
           for t in tensors]
    for o, t in zip(out, tensors):
        o.copy_(t.detach(), non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return out


def _flat_views(buf: torch.Tensor, shapes: List[Tuple[int, ...]]
                ) -> List[torch.Tensor]:
    """Views of consecutive ranges of the flat ``buf``, one a shape."""
    out, off = [], 0
    for s in shapes:
        n = int(np.prod(s, dtype=np.int64))
        out.append(buf[off:off + n].view(s))
        off += n
    return out


def _as_tensor(x: Any) -> torch.Tensor:
    """A tensor over ``x`` (a read-only numpy array, as a decoded file
    gives, is copied first)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


class _Window:
    """One gradient-accumulation window: the step it closes, the
    generator its micro-batches draw from in sequence, PLD's theta, gas,
    the micro-steps done, and the mean loss and MoE stats so far."""

    def __init__(self, step: int, generator: torch.Generator,
                 theta: Optional[float], gas: int):
        self.step = step
        self.generator = generator
        self.theta = theta
        self.gas = gas
        self.done = 0
        self.mean_loss: Optional[torch.Tensor] = None
        self.moe_sum: Dict[str, torch.Tensor] = {}


class EngineState:
    """Everything a step carries, as device tensors: the step count,
    the parameters (views of the flat master buffers), the optimizer
    state, the loss-scale machine, the skipped-step count, and the
    compute-dtype copy of the parameters (None without one)."""

    def __init__(self, step, params, opt_state, loss_scale, growth_count,
                 hysteresis, skipped_steps, cast_params=None):
        self.step = step
        self.params = params
        self.opt_state = opt_state
        self.loss_scale = loss_scale
        self.growth_count = growth_count
        self.hysteresis = hysteresis
        self.skipped_steps = skipped_steps
        self.cast_params = cast_params

    def replace(self, **kw) -> "EngineState":
        d = dict(vars(self))
        d.update(kw)
        return EngineState(**d)


def _make_raw_scaled_loss(loss_fn: Callable, accepts_pld: bool,
                          gas: int) -> Callable:
    """``(params, mb, rng, scale, theta) -> (scaled_loss, (raw_loss,
    aux))``: the loss scaled for the fp16 backward and divided by gas, so
    the accumulated gradients average over the micro-batches; ``theta``
    (progressive layer drop's keep probability) goes to a loss that
    takes ``pld_theta``."""
    def raw_scaled_loss(params, mb, rng, scale, theta):
        out = loss_fn(params, mb, rng, pld_theta=theta) if accepts_pld \
            else loss_fn(params, mb, rng)
        loss, aux = out if isinstance(out, tuple) else (out, None)
        return (loss.float() * scale) / gas, (loss, aux)
    return raw_scaled_loss


def _overflow_resolution(state: EngineState, overflow: torch.Tensor, *,
                         fp16: bool, static_scale: bool, scale_window: int,
                         min_scale: float, hysteresis_init: int
                         ) -> Dict[str, Any]:
    """On overflow hold the step (so the LR holds) and count the skip;
    drive the dynamic loss-scale machine either way. Returns the
    ``EngineState.replace`` fields."""
    taken = torch.logical_not(overflow).to(torch.int32)
    fields: Dict[str, Any] = dict(
        step=state.step + taken,
        skipped_steps=state.skipped_steps + overflow.to(torch.int32))
    if fp16 and not static_scale:
        ls = LossScaleState(
            loss_scale=state.loss_scale, growth_count=state.growth_count,
            hysteresis=state.hysteresis, dynamic=True,
            scale_window=scale_window, min_scale=min_scale,
            hysteresis_init=hysteresis_init, scale_factor=2.0)
        ls = update_loss_scale(ls, overflow)
        fields.update(loss_scale=ls.loss_scale,
                      growth_count=ls.growth_count,
                      hysteresis=ls.hysteresis)
    return fields


def _unported(feature: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{feature} is not ported yet (ROADMAP "
                               f"{where})")


class DeepSpeedEngine:
    """Config-driven training engine: one card, or one process per card
    over the default process group."""

    def __init__(self, args=None, model=None, optimizer=None,
                 model_params=None, training_data=None, lr_scheduler=None,
                 mpu=None, dist_init_required=None, collate_fn=None,
                 config: Union[str, Dict[str, Any], DeepSpeedConfig,
                               None] = None,
                 rng: Union[int, torch.Generator, None] = None,
                 device: Union[str, torch.device, None] = None,
                 sparse_grad_filter: Optional[Callable[[str, Any],
                                                       bool]] = None):
        self.device = resolve_device(device)
        # One process per card: the dp world and rank are the default
        # process group's (parallel/comm.init_distributed).
        if comm.is_initialized():
            self.dp, self.dp_rank = dp_world_size(), dp_rank()
        else:
            env_world = int(os.environ.get("WORLD_SIZE", "1"))
            if env_world > 1:
                raise RuntimeError(
                    f"WORLD_SIZE={env_world} but no process group is "
                    "initialized: call deepspeed_tpu_torch.init_distributed"
                    "() in every process before initialize()")
            self.dp, self.dp_rank = 1, 0
        if mpu is not None and \
                int(mpu.get_data_parallel_world_size()) != self.dp:
            raise ValueError(
                f"mpu says dp {mpu.get_data_parallel_world_size()} but the "
                f"process group has {self.dp} ranks")
        if config is None:
            raise ValueError("DeepSpeed requires a config")
        self.config = config if isinstance(config, DeepSpeedConfig) \
            else DeepSpeedConfig(config, world_size=self.dp)
        if self.config.world_size != self.dp:
            raise ValueError(
                f"the DeepSpeedConfig was solved for world_size "
                f"{self.config.world_size}, the process group has {self.dp}")
        for feature, where in self.config.unported_features():
            raise _unported(feature, where)
        # ZeRO-Offload (at stage >= 1, as in JAX): the host holds the
        # masters and the moments, the card the compute-dtype params.
        zc = self.config.zero_config
        offload = bool(zc.cpu_offload) and \
            self.zero_optimization_stage() >= 1
        if zc.cpu_offload and not offload:
            log_dist("zero_optimization.cpu_offload has no effect at ZeRO "
                     "stage 0 (as in the JAX engine)", ranks=[0])
        self._offload: Optional[ZeroOffloadOptimizer] = None
        # The last offload step's breakdown (the JAX keys; None without
        # offload).
        self.offload_timings: Optional[Dict[str, Any]] = None
        # ZeRO across ranks (only at dp > 1: one card runs every stage as
        # the contiguous one-card path, and stage 3 at dp 1 is stage 2;
        # under offload the card holds whole params and grads).
        stage = self.zero_optimization_stage() \
            if self.dp > 1 and not offload else 0
        self._shard_local = stage >= 1        # K5/K6 on this rank's rows
        self._zero3 = stage >= 3              # params held as rows too
        self._rs_grads = stage >= 3 or (
            stage == 2 and bool(self.config.zero_config.reduce_scatter))
        # The `moe` block promises the moe_* metrics. The model is built
        # apart (TransformerConfig.moe); a block with no MoE stats from
        # the loss_fn behind it raises at the first step.
        self._moe_metrics = self.config.moe_config.num_experts > 0
        if optimizer is not None and offload:
            raise ValueError(
                "a client optimizer does not compose with zero_optimization."
                "cpu_offload: the host runs its own Adam on the masters")

        self.loss_fn, init_params = self._normalize_model(model,
                                                          model_params)
        self.module = model
        cfg = getattr(self.loss_fn, "cfg", None)
        if cfg is not None:
            check_trainable(cfg)
            # (check_trainable and unported_features refuse an
            # expert_parallel_size other than 1 on either side, so the
            # block's and the model's cannot disagree.)
            model_moe = getattr(cfg, "moe", None)
            if model_moe is not None:
                # grouped_gemm=False has no CUDA path: raise here, before
                # anything touches the device.
                check_grouped_gemm(model_moe.grouped_gemm, self.device)
            if self.device.type == "cuda" and cfg.fused_kernels is False:
                raise NotImplementedError(
                    "fused_kernels=False has no CUDA path in the port — the "
                    "LayerNorm and GELU run as its kernels there (ROADMAP: "
                    "not planned)")

        # Precision: fp32 masters (bf16 without masters in the
        # stochastic-rounding mode); compute dtype per config.
        if self.config.bf16_enabled:
            self.compute_dtype = torch.bfloat16
        elif self.config.fp16_enabled:
            self.compute_dtype = torch.float16
        else:
            self.compute_dtype = torch.float32
        self._master_free = bool(self.config.bf16_stochastic_rounding)
        self._use_cast_cache = self.compute_dtype != torch.float32 and \
            not self._master_free
        master_dtype = torch.bfloat16 if self._master_free \
            else torch.float32
        # 1-bit Adam (ops/onebit.py): its own train step at ZeRO stage 0.
        self._onebit = isinstance(optimizer, OnebitAdam) or (
            optimizer is None and
            self.config.optimizer_name == C.ONEBIT_ADAM_OPTIMIZER)
        if self._master_free and (
                offload or self._onebit or
                self.config.sparse_gradients_enabled):
            raise ValueError(
                "bf16.stochastic_rounding (master-free mode) composes with "
                "the main train path only — onebit/offload/sparse_gradients "
                "keep their own master-weight story")
        if self._onebit and self.zero_optimization_stage() >= 1:
            raise ValueError(
                "OnebitAdam composes with ZeRO stage 0 only (reference: "
                "it is an fp16-wrapper-level optimizer, not a ZeRO one)")
        if self.config.zero_config.dcn_compression and \
                self.config.mesh_num_slices <= 1:
            raise ValueError(
                "zero_optimization.dcn_compression requires a multi-"
                "slice mesh (mesh.slices > 1 / build_mesh(slices=...)): "
                "there is no DCN hop to compress on a single slice")

        # LR schedule: a pure function of the step (a device tensor).
        opt_params = dict(self.config.optimizer_params or {})
        base_lr = float(opt_params.get("lr", 1e-3))
        self.lr_scheduler = None
        schedule_fn = None
        if lr_scheduler is not None:
            self.lr_scheduler = lr_scheduler
            schedule_fn = lr_scheduler.as_schedule_fn() \
                if hasattr(lr_scheduler, "as_schedule_fn") else lr_scheduler
        elif self.config.scheduler_name is not None:
            self.lr_scheduler = get_lr_schedule(
                self.config.scheduler_name,
                dict(self.config.scheduler_params))
            schedule_fn = self.lr_scheduler.as_schedule_fn()
        if schedule_fn is None:
            schedule_fn = lambda step: base_lr  # noqa: E731
        self._schedule_fn = schedule_fn
        # (under offload the ZeroOffloadOptimizer, built below)
        self.optimizer = None
        if optimizer is not None:
            self.optimizer = client_optimizer(optimizer, schedule_fn, base_lr)
        elif not offload:
            self.optimizer = build_optimizer(
                self.config.optimizer_name or C.ADAM_OPTIMIZER, opt_params,
                schedule_fn)
        if isinstance(self.optimizer, TorchOptimizer) and self._shard_local:
            raise NotImplementedError(
                f"{self.optimizer.name} holds its state per parameter, so it "
                "runs at dp 1 or at ZeRO stage 0, where every rank holds "
                "whole parameters (ROADMAP queue 1 item 5: torch.optim at "
                "ZeRO stages 1-3)")

        # Flat parameter groups; leaves in tree order view into them.
        # At ZeRO stage >= 1 across ranks each group is also held as this
        # rank's rows of the V-interleaved layout (a ShardGroup: the
        # masters the optimizer updates, the grads it reads); at stage 3
        # only as those rows.
        leaves, self._treedef = tree_flatten(init_params)
        masters = []
        for leaf in leaves:
            t = torch.as_tensor(leaf)
            if not t.is_floating_point():
                raise TypeError("the port's engine trains floating-point "
                                f"parameter trees, got a {t.dtype} leaf")
            masters.append(t.detach().to(
                "cpu" if offload else self.device, master_dtype))
        if self.dp > 1:
            # Every rank starts from rank 0's parameters, as DeepSpeed's
            # engine broadcasts its model (the JAX mesh replicates one).
            for t in masters:
                if t.device == self.device:
                    comm.broadcast(t, 0)
                else:
                    t.copy_(comm.broadcast(t.to(self.device), 0))
        self._leaf_shapes = [tuple(t.shape) for t in masters]
        sc = self._loss_scaler_config()
        if offload:
            self._init_offload(masters, sc)
        cast_dtype = self.compute_dtype if self._use_cast_cache else None
        self._groups: List[FlatGroup] = []
        self._shards: List[ShardGroup] = []
        n = len(leaves)
        param_views: List[Any] = [None] * n
        grad_views: List[Any] = [None] * n
        cast_views: List[Any] = [None] * n
        self._group_leaves: List[List[int]] = []
        plan = row_plan(self.dp, self.dp_rank)
        for dt, idxs in ([] if offload else float_groups(masters)):
            self._group_leaves.append(idxs)
            if self._shard_local:
                sg = ShardGroup([self._leaf_shapes[i] for i in idxs], dt,
                                self.device, plan)
                sg.pack([masters[i] for i in idxs], sg.param)
                self._shards.append(sg)
            if self._zero3:
                for i, pv in zip(idxs, sg.local_views(sg.param)):
                    param_views[i] = pv
                continue
            # (ZeRO-2 reduce-scatters into the ShardGroup's rows: no
            # whole-group grad buffer)
            grp = FlatGroup([masters[i] for i in idxs], dt, self.device,
                            cast_dtype, grad=not self._rs_grads)
            self._groups.append(grp)
            for i, pv in zip(idxs, grp.views(grp.param)):
                param_views[i] = pv
            if grp.grad is not None:
                for i, gv in zip(idxs, grp.views(grp.grad)):
                    grad_views[i] = gv
            if grp.cast is not None:
                for i, cv in zip(idxs, grp.views(grp.cast)):
                    cast_views[i] = cv
        del masters
        if offload:
            param_views, grad_views = self._param_views, self._grad_views
        self._grad_views = grad_views
        self._loss_leaves = [] if self._zero3 else [
            (cv if cv is not None else pv).requires_grad_(True)
            for pv, cv in zip(param_views, cast_views)]
        # The groups the fused step updates, and V-layout scratch
        # buffers (by group and dtype) for packing and gathering.
        self._opt_groups = self._shards or self._groups
        self._scratch: Dict[Tuple[int, torch.dtype], torch.Tensor] = {}

        self._scaler_kw = dict(
            fp16=self.config.fp16_enabled, static_scale=sc["static"],
            scale_window=sc["scale_window"], min_scale=sc["min_scale"],
            hysteresis_init=sc["hysteresis"])
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        if offload:
            # The loss-scale machine and the step count are the host's;
            # the state mirrors them as CPU tensors after each step.
            self.state = EngineState(
                params=tree_unflatten(self._treedef, param_views),
                opt_state=None, **self._offload_scalars())
        else:
            # (1-bit Adam chunks its compression by dp)
            opt_state = self.optimizer.init(self._opt_groups, self.dp) \
                if self._onebit else self.optimizer.init(self._opt_groups)
            self.state = EngineState(
                step=torch.zeros((), **i32),
                params=tree_unflatten(self._treedef, param_views),
                opt_state=opt_state,
                loss_scale=torch.tensor(sc["init_scale"],
                                        dtype=torch.float32, device=dev),
                growth_count=torch.zeros((), **i32),
                hysteresis=torch.tensor(sc["hysteresis"], **i32),
                skipped_steps=torch.zeros((), **i32),
                cast_params=tree_unflatten(self._treedef, cast_views)
                if self._use_cast_cache and not self._zero3 else None)

        # Host-side counters.
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0     # refreshed by a snapshot or a load
        # The forward/backward/step trio's open window and its pending
        # forward (scaled loss, inputs, the returned loss); eval_batch's
        # count of default generators.
        self._trio: Optional[_Window] = None
        self._trio_pending: Optional[Tuple[Any, Any, Any]] = None
        self._eval_count = 0
        # 1-bit Adam's phase on the host: the step count last read off
        # the card, the steps tried since (an upper bound on the count
        # without a read), and whether the count passed freeze_step
        # (for good: it never falls). The last step's comm_bytes.
        self._onebit_known = 0
        self._onebit_pending = 0
        self._onebit_frozen = False
        self.onebit_comm_bytes: Optional[int] = None
        if self._onebit:
            log_dist("OnebitAdam: uncompressed warmup uses standard Adam "
                     f"for {self.optimizer.freeze_step} steps, then the "
                     "error-feedback compressed momentum exchange",
                     ranks=[0])

        # Sparse (CSR) embedding gradients: at dp > 1 the marked leaves'
        # grads travel the CSR exchange instead of the all-reduce.
        self._sparse_idx: List[int] = []
        self._sparse_names: List[str] = []
        self._dense_runs: List[List[Tuple[int, int]]] = []
        self.sparse_comm_stats: Dict[str, int] = {}
        if self.config.sparse_gradients_enabled:
            self._init_sparse_gradients(sparse_grad_filter)

        # The base seed of the per-step random stream (step_generator).
        if isinstance(rng, torch.Generator):
            self._base_seed = int(rng.initial_seed())
        else:
            self._base_seed = 42 if rng is None else int(rng)

        self.collate_fn = collate_fn
        self.training_dataloader = self.deepspeed_io(training_data) \
            if training_data is not None else None
        self._data_iterator = None

        # Progressive layer drop: theta_at(global_steps), a host float,
        # goes to every micro-step's loss on every path (one card, dp and
        # ZeRO 1-3, offload) when the loss_fn takes pld_theta.
        self.progressive_layer_drop = None
        self._accepts_pld = False
        if self.config.pld_config.enabled:
            self.progressive_layer_drop = ProgressiveLayerDrop(
                theta=self.config.pld_config.theta,
                gamma=self.config.pld_config.gamma)
            try:
                self._accepts_pld = "pld_theta" in \
                    inspect.signature(self.loss_fn).parameters
            except (TypeError, ValueError):
                self._accepts_pld = False
            if not self._accepts_pld:
                logger.warning("progressive_layer_drop enabled but the "
                               "model's loss_fn takes no pld_theta kwarg — "
                               "layers will not drop")

        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu(),
            start_step=2, steps_per_output=self.steps_per_print(),
            synchronized=self.wall_clock_breakdown())
        self.last_metrics: Optional[Dict[str, torch.Tensor]] = None

        # The flops profiler: one training step's op walk at
        # flops_profiler.profile_step (_run_flops_profiler).
        self.flops_profiler = None
        if self.config.flops_profiler_config.enabled:
            from ..profiling.flops_profiler import FlopsProfiler
            self.flops_profiler = FlopsProfiler(
                config=self.config.flops_profiler_config)
        self._init_telemetry()

        # Async / preemption-safe checkpointing (runtime/async_ckpt.py):
        # the writer thread, the auto-save cadence and the SIGTERM
        # final-save handler, all inert unless the `checkpoint` block
        # opts in.
        ckcfg = self.config.checkpoint_config
        self._ckpt_dir = ckcfg.save_dir
        self._ckpt_every = int(ckcfg.snapshot_every)
        self._ckpt_max_pending = int(ckcfg.max_pending_snapshots)
        self._ckpt_writer_timeout = float(ckcfg.writer_timeout_s)
        self._ckpt_fsync = bool(ckcfg.fsync)
        self._last_saved_step = -1
        self._async_ckpt = None
        self._preempt_saver = None
        # True while a step changes the state (train_batch's step, the
        # trio's step()): a SIGTERM then waits for the step's end
        # (``_state_changing``), or the preemption save would commit the
        # new params under the old step's tag.
        self._in_step = False
        if ckcfg.async_save:
            self._async_ckpt = AsyncCheckpointer(
                telemetry=self.telemetry,
                writer_timeout_s=self._ckpt_writer_timeout,
                dump_dir=self.config.telemetry_config.output_path
                or "./runs")
        if self._ckpt_dir and ckcfg.preempt_save:
            # Installed AFTER the telemetry's flight recorder: on SIGTERM
            # this handler runs first, commits the final checkpoint, then
            # chains to the recorder's.
            self._preempt_saver = PreemptSaver(self, self._ckpt_dir)
            self._preempt_saver.install()
        if ckcfg.async_save or self._ckpt_every > 0:
            self.telemetry.meta.setdefault("checkpoint", {
                "async": bool(ckcfg.async_save),
                "snapshot_every": self._ckpt_every})
        log_dist(f"DeepSpeedEngine initialized: device={dev}, "
                 f"dtype={self.config.precision_dtype}, "
                 f"zero_stage={self.zero_optimization_stage()}, "
                 f"dp={self.dp}", ranks=[0])
        if self.dp > 1:
            log_dist(describe_sharding(init_params, self.dp,
                                       self.zero_optimization_stage()),
                     ranks=[0])

    # ------------------------------------------------------------------ #
    # Construction helpers
    # ------------------------------------------------------------------ #
    @staticmethod
    def _normalize_model(model, model_params) -> Tuple[Callable, Any]:
        if model is None:
            raise ValueError("deepspeed_tpu_torch requires a model: "
                             "loss_fn(params, batch, rng)")
        if not callable(model):
            raise TypeError(f"Unsupported model type {type(model)}")
        if model_params is None:
            raise ValueError("Pass model_params with a callable loss_fn "
                             "model")
        return model, model_params

    def _loss_scaler_config(self) -> Dict[str, Any]:
        cfg = self.config
        if cfg.fp16_enabled:
            if cfg.fp16_loss_scale and cfg.fp16_loss_scale > 0:
                return dict(static=True,
                            init_scale=float(cfg.fp16_loss_scale),
                            scale_window=cfg.fp16_loss_scale_window,
                            min_scale=float(cfg.fp16_min_loss_scale),
                            hysteresis=cfg.fp16_hysteresis)
            return dict(static=False,
                        init_scale=2.0 ** cfg.fp16_initial_scale_power,
                        scale_window=cfg.fp16_loss_scale_window,
                        min_scale=float(cfg.fp16_min_loss_scale),
                        hysteresis=cfg.fp16_hysteresis)
        return dict(static=True, init_scale=1.0, scale_window=1000,
                    min_scale=1.0, hysteresis=2)

    # ------------------------------------------------------------------ #
    # Config getters (reference API)
    # ------------------------------------------------------------------ #
    def _init_telemetry(self) -> None:
        """The telemetry spine (monitor/): per-step records, spans, the
        recompile sentinel, the memory watermark, the health tap, built
        as the JAX engine builds them. Inert when disabled; enabled, it
        reads the card only at report boundaries."""
        self._grad_sync_mode = self._resolve_grad_sync()
        self._wire_bytes, self._wire_detail = self._grad_wire_bytes()
        self.telemetry = Telemetry(
            self.config.telemetry_config,
            default_report_steps=self.steps_per_print(),
            meta=dict(
                dp=self.dp, ep=1, slices=1,
                zero_stage=self.zero_optimization_stage(),
                precision=self.config.precision_dtype,
                cpu_offload=self._offload is not None,
                grad_sync_mode=self._grad_sync_mode,
                wire_bytes_per_step=self._wire_bytes,
                wire_bytes_ici=self._wire_bytes, wire_bytes_dcn=0,
                dcn_compression=False, wire_terms=self._wire_terms(),
                wire_detail=self._wire_detail,
                train_batch_size=self.train_batch_size(),
                gradient_accumulation_steps=
                self.gradient_accumulation_steps()))
        # A weakref: the Telemetry outlives the engine through its atexit
        # hook, and a closure over the engine would pin its state.
        import weakref
        ref = weakref.ref(self)
        self.telemetry.step_provider = lambda: (
            ref().global_steps if ref() is not None else -1)
        dev = self.device
        self.telemetry.set_analytic_footprint(
            analytic_state_bytes(self._state_tensors()),
            sampler=lambda: device_memory_stats([dev]))
        self._cost_model_built = False
        self._health_taps = False
        hcfg = self.config.telemetry_config.health
        if self.telemetry.enabled and self.telemetry.health is not None \
                and hcfg.grad_taps:
            self.telemetry.set_tap_spec(TapSpec.from_tree(self.state.params))
            self._health_taps = True
        tl = self.telemetry
        # Each step path through the recompile sentinel (identity when
        # telemetry is off): the fused step of the active mode, and the
        # trio's forward, backward and apply. The class's functions, not
        # bound methods: an engine holding its own bound methods is a
        # reference cycle, and a deleted engine would keep the card's
        # memory until the next garbage collection.
        cls = type(self)
        self._step_path = "offload_grad_step" if self._offload is not None \
            else "sparse_grad_step" if self._sparse_idx and self.dp > 1 \
            else "train_step"
        self._step_fn = tl.instrument_step_fn(self._step_path,
                                              cls._train_step)
        self._grad_fwd_fn = tl.instrument_step_fn("grad_step",
                                                  cls._forward_micro)
        self._grad_bwd_fn = tl.instrument_step_fn("grad_step_bwd",
                                                  cls._backward_micro)
        self._apply_grads_fn = tl.instrument_step_fn("apply_grads",
                                                     cls._apply_window)
        self._trio_t0: Optional[float] = None
        self._trio_used = False

    def _state_tensors(self) -> List[torch.Tensor]:
        """The tensors this rank keeps on its device between steps: the
        params (flat masters, or the offload copy), the compute-dtype
        copy, the optimizer state, the loss-scale scalars."""
        st = self.state
        out = list(tree_flatten(st.params)[0])
        if st.cast_params is not None:
            out += tree_flatten(st.cast_params)[0]
        out += tree_flatten(st.opt_state)[0] \
            if st.opt_state is not None else []
        out += [st.step, st.loss_scale, st.growth_count, st.hysteresis,
                st.skipped_steps]
        # (by device type: the engine's device may name no index)
        return [t for t in out if isinstance(t, torch.Tensor) and
                t.device.type == self.device.type]

    def _resolve_grad_sync(self) -> str:
        """The gradient-sync lowering the port runs (the JAX names):
        ``none`` below stage 2 or at dp 1, ``allreduce`` with
        ``reduce_scatter: false``, else ``explicit`` (the port's
        reduce-scatter is an explicit collective)."""
        if self.zero_optimization_stage() < 2 or self.dp <= 1:
            return "none"
        if not self.config.zero_config.reduce_scatter:
            return "allreduce"
        return "explicit"

    def _grad_wire_bytes(self) -> Tuple[int, str]:
        """(analytic wire bytes a step, detail) of the gradient sync the
        engine runs (the JAX engine's ``_grad_wire_bytes`` at one slice
        and ep 1)."""
        self._wire_model = None
        if self.dp <= 1:
            return 0, "single replica (no gradient sync)"
        shapes = list(self._leaf_shapes)
        gas = self.gradient_accumulation_steps()
        if self._sparse_idx:
            sparse = set(self._sparse_idx)
            model = grad_sync_wire_model(
                [s for i, s in enumerate(shapes) if i not in sparse],
                self.dp)
            self._wire_model = model
            return model["all_reduce_wire_bytes"], \
                ("dense all-reduce over non-sparse leaves only (sparse "
                 "embedding grads use the data-dependent CSR exchange; "
                 "see sparse_comm_stats)")
        itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
        if self._zero3:
            model = grad_sync_wire_model(shapes, self.dp, zero3=True,
                                         param_bytes_per_el=itemsize,
                                         gas=gas)
            self._wire_model = model
            name = str(self.compute_dtype).replace("torch.", "")
            return model["zero3_wire_bytes"], \
                (f"{self._grad_sync_mode} ZeRO-3: per micro-step, 2 param "
                 f"gathers ({name} wire) + f32 grad reduce-scatter — "
                 f"{model['param_gather_wire_bytes']:,} gather B/step")
        model = grad_sync_wire_model(shapes, self.dp)
        self._wire_model = model
        if self.zero_optimization_stage() < 2:
            return model["all_reduce_wire_bytes"], \
                "dense all-reduce (grads replicated below ZeRO stage 2)"
        if self._grad_sync_mode == "allreduce":
            return model["all_reduce_wire_bytes"], \
                "dense all-reduce (reduce_scatter: false)"
        return model["reduce_scatter_wire_bytes"], \
            "explicit reduce-scatter (the port's collective)"

    def _wire_terms(self) -> Optional[Dict[str, Dict[str, Any]]]:
        """The per-term split of the wire figure by tier: None on one
        slice, as in JAX (the port runs one)."""
        return None

    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def zero_optimization_stage(self) -> int:
        return self.config.zero_optimization_stage

    def fp16_enabled(self) -> bool:
        return self.config.fp16_enabled

    def bfloat16_enabled(self) -> bool:
        return self.config.bf16_enabled

    def gradient_clipping(self) -> float:
        return self.config.gradient_clipping

    def steps_per_print(self) -> int:
        return self.config.steps_per_print

    def wall_clock_breakdown(self) -> bool:
        return self.config.wall_clock_breakdown

    def deepspeed_io(self, dataset, batch_size: Optional[int] = None):
        return DeepSpeedDataLoader(
            dataset, batch_size or self.train_micro_batch_size_per_gpu(),
            collate_fn=self.collate_fn, data_parallel_world_size=self.dp,
            data_parallel_rank=self.dp_rank)

    # ------------------------------------------------------------------ #
    # State import
    # ------------------------------------------------------------------ #
    def set_train_state(self, params: Any, opt_state: Any,
                        step: int = 0, loss_scale: Optional[float] = None,
                        growth_count: int = 0,
                        hysteresis: Optional[int] = None,
                        skipped_steps: int = 0) -> None:
        """Replace the training state in place: ``params`` a tree like
        the initial one (tensors or numpy), ``opt_state`` the optimizer's
        state with its buffers in this engine's flat-group layout
        (``models/convert.py`` carries a JAX ``FusedAdamState`` there; at
        ZeRO stage >= 1 across ranks, this rank's rows of the V-layout;
        an optax chain's ``FlatState`` likewise). The compute-dtype copy
        is re-derived from the new parameters. ``global_steps`` follows
        from ``step`` and ``skipped_steps`` (``load_checkpoint`` takes the
        counters from the checkpoint's meta instead)."""
        if self._offload is not None:
            raise ValueError(
                "set_train_state takes device optimizer state; an offload "
                "engine's state is its host ZeroOffloadOptimizer "
                "(load_checkpoint, or engine.optimizer.load_state_dict)")
        self._write_params(tree_flatten(params)[0])
        self._write_opt_state(opt_state, step, loss_scale, growth_count,
                              hysteresis, skipped_steps)
        self.global_steps = int(step) + int(skipped_steps)
        self.skipped_steps = int(skipped_steps)

    def _write_params(self, leaves: List[Any]) -> None:
        """Copy new parameter leaves (tree order; None keeps a leaf)
        into the flat masters (and this rank's V-layout rows) and
        re-derive the compute-dtype copy."""
        with torch.no_grad():
            if self._zero3:
                if any(x is None for x in leaves):
                    cur = tree_flatten(self.full_params())[0]
                    leaves = [c if x is None else x
                              for c, x in zip(cur, leaves)]
                for sg, idxs in zip(self._shards, self._group_leaves):
                    sg.pack([_as_tensor(leaves[i]).to(self.device, sg.dtype)
                             for i in idxs], sg.param)
                return
            for pv, new in zip(tree_flatten(self.state.params)[0], leaves):
                if new is not None:
                    pv.copy_(_as_tensor(new).to(self.device, pv.dtype))
            for grp in self._groups:
                if grp.cast is not None:
                    grp.cast.copy_(grp.param)
            for grp, sg in zip(self._groups, self._shards):
                sg.pack(grp.views(grp.param), sg.param)

    def full_params(self) -> Any:
        """The whole parameter tree: ``state.params`` itself, except at
        ZeRO stage 3 across ranks, where each rank holds its rows and
        this gathers the leaves (a collective: call it on every
        rank)."""
        if not self._zero3:
            return self.state.params
        out: List[Any] = [None] * len(self._leaf_shapes)
        with torch.no_grad():
            for sg, idxs in zip(self._shards, self._group_leaves):
                full = comm.all_gather(sg.param)
                leaves = [torch.empty(self._leaf_shapes[i], dtype=sg.dtype,
                                      device=self.device) for i in idxs]
                sg.unpack(full, leaves)
                for i, t in zip(idxs, leaves):
                    out[i] = t
        return tree_unflatten(self._treedef, out)

    def _write_opt_state(self, opt_state: Any, step: int,
                         loss_scale: Optional[float], growth_count: int,
                         hysteresis: Optional[int],
                         skipped_steps: int) -> None:
        dev = self.device
        with torch.no_grad():
            new = state_buffers(opt_state)
            for name, bufs in state_buffers(self.state.opt_state).items():
                for buf, src in zip(bufs, new[name]):
                    buf.copy_(_as_tensor(src))
            sc = self._scaler_kw
            i32 = dict(dtype=torch.int32, device=dev)
            count = torch.tensor(int(opt_state.count), **i32)
            if self._onebit:
                opt = self.state.opt_state._replace(step=count)
                self._onebit_known = int(opt_state.count)
                self._onebit_pending = 0
                self._onebit_frozen = False
            else:
                opt = self.state.opt_state._replace(count=count)
            self.state = self.state.replace(
                step=torch.tensor(int(step), **i32),
                opt_state=opt,
                loss_scale=self.state.loss_scale if loss_scale is None
                else torch.tensor(float(loss_scale), dtype=torch.float32,
                                  device=dev),
                growth_count=torch.tensor(int(growth_count), **i32),
                hysteresis=torch.tensor(
                    sc["hysteresis_init"] if hysteresis is None
                    else int(hysteresis), **i32),
                skipped_steps=torch.tensor(int(skipped_steps), **i32))

    # ------------------------------------------------------------------ #
    # Train / eval
    # ------------------------------------------------------------------ #
    def _to_device(self, batch: Any) -> Any:
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_device(v) for v in batch)
        t = torch.as_tensor(batch)
        if t.device.type == "cpu" and self.device.type == "cuda":
            t = t.pin_memory()        # so the upload does not block the host
        return t.to(self.device, non_blocking=True)

    def _split_micro_batches(self, batch: Any) -> List[Any]:
        gas = self.gradient_accumulation_steps()
        leaves, spec = tree_flatten(batch)
        for x in leaves:
            if x.shape[0] % gas != 0:
                raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                                 f"grad-accum {gas}")
        chunks = [x.chunk(gas, dim=0) for x in leaves]
        return [tree_unflatten(spec, [c[i] for c in chunks])
                for i in range(gas)]

    def train_batch(self, batch: Any = None, data_iter=None
                    ) -> torch.Tensor:
        """One training iteration: all gas micro-batches and one
        optimizer step. ``batch`` has a leading dim of gas * micro (for
        GPT-2, tokens [gas*micro, S+1]); without it, gas micro-batches
        come from ``data_iter`` or the engine's dataloader. Returns the
        mean loss as a 0-dim device tensor."""
        if self._trio is not None:
            raise RuntimeError(
                "train_batch() inside a forward()/backward() accumulation "
                "window: call step() at the window's boundary first")
        tl = self.telemetry
        t_wall0 = time.perf_counter()
        if batch is None:
            it = data_iter
            if it is None:
                if self._data_iterator is None:
                    if self.training_dataloader is None:
                        raise ValueError("train_batch() needs a batch, "
                                         "data_iter, or training_data")
                    self._data_iterator = iter(
                        RepeatingLoader(self.training_dataloader))
                it = self._data_iterator
            # The fetch wait is the goodput ledger's data stall (host
            # clock only).
            t_fetch0 = time.perf_counter()
            micro = [next(it) for _ in range(
                self.gradient_accumulation_steps())]
            if tl.ledger is not None:
                tl.ledger.note("data_stall", time.perf_counter() - t_fetch0)
            leaves = [tree_flatten(m)[0] for m in micro]
            spec = tree_flatten(micro[0])[1]
            batch = tree_unflatten(spec, [
                np.concatenate([np.asarray(x) for x in xs], axis=0)
                for xs in zip(*leaves)])
        micro_batches = self._split_micro_batches(self._to_device(batch))
        if tl.tracer is not None:
            tl.add_span("data_prep", t_wall0, time.perf_counter() - t_wall0)
        self.tput_timer.start()
        t_dispatch = time.perf_counter()
        with self._state_changing():
            if self.flops_profiler is not None and self.global_steps == \
                    self.config.flops_profiler_config.profile_step:
                metrics = self._run_flops_profiler(micro_batches)
            else:
                metrics = self._step_fn(self, micro_batches,
                                        self.global_steps)
            self.micro_steps += self.gradient_accumulation_steps()
            self._finish_step(metrics, t_wall0, t_dispatch)
        return metrics["loss"]

    @contextlib.contextmanager
    def _state_changing(self):
        """A step that changes the state: a SIGTERM arriving inside it is
        held by the preemption saver and handled at its end, once
        ``global_steps`` names the state (after a step that raised: the
        signal without the save)."""
        self._in_step = True
        ok = False
        try:
            yield
            ok = True
        finally:
            self._in_step = False
            if self._preempt_saver is not None:
                self._preempt_saver.fire_held(save=ok)

    def _run_flops_profiler(self, micro_batches: List[Any]
                            ) -> Dict[str, torch.Tensor]:
        """This step, walked by the flops profiler (a real step: its
        update is kept), and the per-module table printed on rank 0 (the
        JAX engine's hook at flops_profiler.profile_step walks its train
        step's jaxpr)."""
        from ..profiling.flops_profiler.profiler import _count_params, walk
        cfg = self.config.flops_profiler_config
        metrics, res = walk(self._step_fn, self, micro_batches,
                            self.global_steps)
        res.total_params = _count_params(self.state.params)
        self.flops_profiler.result = res
        if self.dp_rank == 0:
            self.flops_profiler.print_model_profile(
                module_depth=cfg.module_depth, top_modules=cfg.top_modules,
                detailed=cfg.detailed)
        return metrics

    def _finish_step(self, metrics: Dict[str, Any], t0: float,
                     t_dispatch: float) -> None:
        """After an optimizer step (``train_batch``, or ``step()`` at a
        boundary): the counters, progressive layer drop's schedule, the
        scheduler's iteration, the metrics, the telemetry record, the log
        (and the telemetry drain at its boundary) and the auto-save."""
        self.global_steps += 1
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        self.global_samples += self.train_batch_size()
        if self.lr_scheduler is not None and \
                hasattr(self.lr_scheduler, "last_batch_iteration"):
            self.lr_scheduler.last_batch_iteration = self.global_steps - 1
        self.tput_timer.stop()
        self.last_metrics = metrics
        self._record_telemetry(metrics, t0, t_dispatch)
        self._maybe_log(metrics)
        self._maybe_auto_save()

    def _record_telemetry(self, metrics: Dict[str, Any], t0: float,
                          t_dispatch: float) -> None:
        """Buffer this step's telemetry record — append-only, no device
        read (the metrics' device tensors are copied at the next report
        boundary). ``wall_ms`` is host wall from the step's entry: on the
        card the time to queue the step's kernels (the fenced figure is
        the throughput timer's window average in the report), on the
        offload path, which waits on the host, the step's wall."""
        tl = self.telemetry
        if not tl.enabled:
            return
        # A deferred fail_on_recompile raises here, after the step's
        # state was stored.
        tl.raise_pending()
        t_now = time.perf_counter()
        host: Dict[str, Any] = {
            "wall_ms": (t_now - t0) * 1e3,
            "wire_bytes": self._wire_bytes,
            "samples": self.train_batch_size(),
        }
        if self._offload is not None and self.offload_timings:
            t = self.offload_timings
            off = {k: round(float(t[k]), 3) for k in (
                "device_step_ms", "d2h_ms", "host_norm_ms", "host_step_ms",
                "h2d_dispatch_ms", "h2d_wait_ms", "wall_ms") if k in t}
            off["overlap_fraction"] = round(
                float(t.get("overlap_fraction", 0.0)), 4)
            off["num_buckets"] = int(t.get("num_buckets", 1))
            off["overlapped"] = bool(t.get("overlapped", False))
            host["offload"] = off
            tl.add_offload_trace(t)
        if tl.tracer is not None:
            name = "offload_step" if self._offload is not None \
                else "step_dispatch"
            tl.add_span(name, t_dispatch, t_now - t_dispatch,
                        args={"step": self.global_steps})
            tl.add_span("train_batch", t0, t_now - t0,
                        args={"step": self.global_steps})
        tl.record_step(self.global_steps, metrics, **host)

    def _report_extra(self) -> Dict[str, Any]:
        """The report record's fields, at a drain boundary only (the
        skipped-steps read waits on the card there)."""
        self._maybe_build_cost_model()
        extra: Dict[str, Any] = {
            "global_samples": self.global_samples,
            "samples_per_sec": self.tput_timer.avg_samples_per_sec(),
            "samples_per_sec_valid": self.tput_timer.has_samples(),
        }
        if self._offload is not None:
            extra["skipped_steps"] = self._offload.skipped_steps
        else:
            self.skipped_steps = int(self.state.skipped_steps)
            extra["skipped_steps"] = self.skipped_steps
        return extra

    def profile_window(self, steps: int,
                       start_step: Optional[int] = None) -> Optional[str]:
        """The JAX engine's profiler capture window: None with telemetry
        off; with telemetry on it raises (not ported, ROADMAP queue 1
        item 9)."""
        return self.telemetry.arm_profile_window(
            int(steps), start_step=self.global_steps + 1
            if start_step is None else int(start_step))

    def _maybe_build_cost_model(self) -> None:
        """Build the roofline cost model once, at the first report
        boundary after every path of the step has been walked (each
        path's first call is); a failure is an event, never a dead
        training loop."""
        tl = self.telemetry
        if self._cost_model_built or not tl.enabled or \
                tl.sentinel is None or \
                not self.config.telemetry_config.cost_model:
            return
        step_paths = self._cost_model_step_paths()
        if not all(p in tl.sentinel.registered_paths() for p in step_paths):
            return
        self._cost_model_built = True
        try:
            from ..monitor.cost_model import build_cost_model
            from ..monitor.peaks import chip_peaks
            # Wire bytes are a step's: priced on the path that computes
            # the grads, split over its calls a step.
            comm_bytes: Dict[str, float] = {}
            for p in ("train_step", "offload_grad_step", "sparse_grad_step",
                      "grad_step"):
                if p in step_paths and self._wire_bytes:
                    comm_bytes[p] = float(self._wire_bytes) / step_paths[p]
                    break
            payload = build_cost_model(
                tl.sentinel, comm_bytes_by_path=comm_bytes,
                step_paths=step_paths, n_devices=self.dp,
                peaks=chip_peaks(self.device))
            tl.set_cost_model(payload,
                              samples_per_step=self.train_batch_size())
            step = payload["step"]
            if step.get("bound"):
                log_dist(
                    f"cost model: step is {step['bound']}-bound, analytic "
                    f"floor {step['floor_ms']:.3f} ms/step "
                    f"({payload['chip']['name']} peaks"
                    f"{', ASSUMED' if payload['chip']['assumed'] else ''})",
                    ranks=[0])
        except Exception as e:   # observability must not kill training
            tl.event("cost_model_error",
                     {"error": f"{type(e).__name__}: {e}"[:300]})

    def _cost_model_step_paths(self) -> Dict[str, float]:
        """{path: calls a step} of the paths one optimizer step runs in
        the engine's mode (the trio: a forward and a backward a
        micro-batch, one apply)."""
        if self._trio_used:
            gas = float(self.gradient_accumulation_steps())
            return {"grad_step": gas, "grad_step_bwd": gas,
                    "apply_grads": 1.0}
        return {self._step_path: 1.0}

    def close(self) -> None:
        """End of the engine: the telemetry's terminal drain and
        ``final`` record (atexit runs it too)."""
        self.telemetry.close()

    def _maybe_auto_save(self) -> None:
        """Auto-save (``checkpoint.snapshot_every``): tag global_stepN
        into the configured save_dir."""
        if self._ckpt_every > 0 and \
                self.global_steps % self._ckpt_every == 0:
            self.save_checkpoint(self._ckpt_dir)

    def step_generator(self, step: Optional[int] = None) -> torch.Generator:
        """The generator step ``step`` (default: the next one,
        ``global_steps``) draws its dropout masks from: seeded with the
        base seed folded with the step, as the JAX engine folds the step
        into its base key, and at dp > 1 with the rank. A fresh generator
        a step costs no host sync and makes a resumed run draw what an
        uninterrupted one would."""
        step = self.global_steps if step is None else int(step)
        seed = fold_in(self._base_seed, step)
        if self.dp > 1:
            # Each rank's own dropout stream (JAX: fold_in(key, rank)).
            seed = fold_in(seed, self.dp_rank)
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------ #
    # Micro-steps: one forward and one backward a micro-batch, shared by
    # train_batch and the forward/backward/step trio
    # ------------------------------------------------------------------ #
    def _open_window(self, step: int) -> "_Window":
        """An accumulation window for step ``step``: its generator (the
        micro-batches draw from it in sequence) and PLD's theta."""
        theta = self.progressive_layer_drop.theta_at(step) \
            if self._accepts_pld else None
        return _Window(step, self.step_generator(step), theta,
                       self.gradient_accumulation_steps())

    def _forward_micro(self, win: "_Window", mb: Any, scale: Any
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  List[torch.Tensor]]:
        """One micro-batch's loss (scaled by ``scale`` and divided by
        gas) with its graph; at stage 3 on parameters gathered from
        every rank's rows, saved for the backward pass as re-gathers.
        Adds the raw loss and the MoE stats to the window. Returns
        ``(scaled, raw, inputs)``: the tensors the backward
        differentiates against."""
        scaled_loss = _make_raw_scaled_loss(self.loss_fn, self._accepts_pld,
                                            win.gas)
        if self._zero3:
            inputs, params, regather = self._zero3_gather()
            with regather_saved(regather):
                scaled, (raw, aux) = scaled_loss(params, mb, win.generator,
                                                 scale, win.theta)
            del params, regather
        else:
            inputs = self._loss_leaves
            scaled, (raw, aux) = scaled_loss(
                tree_unflatten(self._treedef, inputs), mb, win.generator,
                scale, win.theta)
        first = win.done == 0
        if self._moe_metrics:
            if not (isinstance(aux, dict) and "moe" in aux):
                raise ValueError(
                    "ds_config has a `moe` block but the model's "
                    "loss_fn returned no moe stats — build the model "
                    "with TransformerConfig.moe (deepspeed_tpu_torch."
                    "moe.MoEConfig) or drop the block")
            for name, v in aux["moe"].items():
                v = v.detach().float()
                win.moe_sum[name] = v if first else win.moe_sum[name] + v
        r = raw.detach().float()
        if win.gas == 1:
            win.mean_loss = r
        else:
            win.mean_loss = (torch.zeros_like(r) if first else
                             win.mean_loss) + r / win.gas
        return scaled, raw, inputs

    def _backward_micro(self, win: "_Window", scaled: torch.Tensor,
                        inputs: List[torch.Tensor]) -> None:
        """The micro-batch's gradients by autograd, added into the fp32
        grads (the first micro-batch of the window writes them): this
        rank's rows at stage 3, reduce-scattered rows at stage 2."""
        first = win.done == 0
        grads = torch.autograd.grad(scaled, inputs, allow_unused=True)
        with torch.no_grad():
            if self._zero3:
                dsts = [dst for sg in self._shards
                        for dst in sg.local_views(sg.grad)]
            elif self._rs_grads:
                self._scatter_grads(grads, first=first)
                dsts = []
            else:
                # fp32 accumulation: each micro-batch's grads (in the
                # compute dtype) are added into the fp32 flat buffers.
                dsts = self._grad_views
            for dst, g in zip(dsts, grads):
                if g is None:
                    if first:
                        dst.zero_()
                elif first:
                    dst.copy_(g)
                else:
                    dst.add_(g)
        win.done += 1

    def _micro_steps(self, micro_batches: List[Any], win: "_Window",
                     scale: Any
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The window's micro-steps, each a forward and a backward.
        Returns the mean loss (a device tensor) and the MoE stats summed
        over the micro-steps."""
        for mb in micro_batches:
            scaled, _, inputs = self._forward_micro(win, mb, scale)
            self._backward_micro(win, scaled, inputs)
            del scaled, inputs
        return win.mean_loss, win.moe_sum

    @staticmethod
    def _moe_means(metrics: Dict[str, Any], moe_sum: Dict[str, Any],
                   gas: int) -> None:
        """The mean over the micro-batches of the MoE stats, as the JAX
        engine's."""
        if moe_sum:
            for name in ("expert_tokens", "drop_fraction", "aux_loss",
                         "z_loss"):
                metrics[f"moe_{name}"] = moe_sum[name] / gas

    def _train_step(self, micro_batches: List[Any], step: int
                    ) -> Dict[str, torch.Tensor]:
        if self._offload is not None:
            return self._train_step_offload(micro_batches, step)
        win = self._open_window(step)
        self._micro_steps(micro_batches, win, self.state.loss_scale)
        if self._onebit:
            return self._apply_onebit(win)
        if self._sparse_idx and self.dp > 1:
            return self._apply_sparse(win)
        return self._apply_window(win)

    def _apply_window(self, win: "_Window") -> Dict[str, torch.Tensor]:
        """The optimizer step closing a window: the grad reduction at
        dp > 1, the optimizer (norm, vote, clip, update, skip, cast
        copy), the overflow bookkeeping and the loss scale."""
        st = self.state
        scale = st.loss_scale
        mean_loss = win.mean_loss
        fp16 = self.config.fp16_enabled
        clip = self.gradient_clipping()
        with torch.no_grad():
            inv_scale = (1.0 / scale) if fp16 else None
            if self.dp > 1:
                self._reduce_grads()
                mean_loss = comm.all_reduce(mean_loss.clone()) / self.dp
                # Each rank's loss is its own micro-batches' mean, so the
                # summed grads are dp x the global mean's: the kernel
                # multiplies by 1/dp with the unscale (exact for
                # power-of-two dp and loss scales, like the JAX
                # explicit path's (g * dp) / dp).
                inv_scale = (torch.ones((), dtype=torch.float32,
                                        device=self.device)
                             if inv_scale is None else inv_scale) / self.dp
            tap = self._grad_tap(inv_scale)
            # (a fill kernel, not a host-to-device copy: no host sync)
            sr_seed = torch.full(
                (), _int32(fold_in(fold_in(self._base_seed, win.step),
                                   _SR_FOLD)),
                dtype=torch.int32, device=self.device) \
                if self._master_free else None
            opt_state, grad_norm, overflow = self.optimizer.step(
                self._opt_groups, st.opt_state, clip=clip,
                inv_scale=inv_scale, fp16=fp16,
                compute_norm=bool(clip and clip > 0) or fp16,
                sr_seed=sr_seed,
                norm_reduce=comm.all_reduce if self._shard_local else None)
            if self._shard_local and not self._zero3:
                self._gather_params()
            lr = self.optimizer.lr_at(st.step)
            self.state = st.replace(
                opt_state=opt_state,
                **_overflow_resolution(st, overflow, **self._scaler_kw))
        metrics = {"loss": mean_loss, "grad_norm": grad_norm, "lr": lr,
                   "loss_scale": scale, "overflow": overflow,
                   "skipped_steps": self.state.skipped_steps}
        if tap is not None:
            metrics[HEALTH_TAP_KEY] = tap
        self._moe_means(metrics, win.moe_sum, win.gas)
        return metrics

    def _grad_tap(self, inv_scale: Any = None) -> Optional[torch.Tensor]:
        """The health tap (monitor/health.py), with telemetry's
        ``health.grad_taps`` on: this step's per-leaf grad sums of
        squares as one ``[num_leaves]`` device tensor in leaf order,
        times ``inv_scale`` squared (the unscale and the 1/dp of the
        summed grads), so it reports true magnitudes; a rank's rows at
        ZeRO stages 1-3, their sums all-reduced. No host read."""
        if not self._health_taps:
            return None
        if self._shard_local:
            views: List[Any] = [None] * len(self._leaf_shapes)
            for sg, idxs in zip(self._shards, self._group_leaves):
                for i, v in zip(idxs, sg.local_views(sg.grad)):
                    views[i] = v
        else:
            views = list(self._grad_views)
        sq = None if inv_scale is None else inv_scale * inv_scale
        tap = leaf_sq_taps(views, sq)
        if self._shard_local:
            tap = comm.all_reduce(tap)
        return tap

    # ------------------------------------------------------------------ #
    # 1-bit Adam (ZeRO stage 0; JAX _build_onebit_train_step)
    # ------------------------------------------------------------------ #
    def _onebit_phase(self) -> bool:
        """Whether this step is in the compression stage. The step count
        lives on the card and an overflow-skipped step does not advance
        it, so the host holds an upper bound (the count last read plus
        the steps tried since): while the bound says warmup, no read;
        once it reaches ``freeze_step`` the count is read (one host
        sync), and past the freeze every later step compresses."""
        if self._onebit_frozen:
            return True
        freeze = self.optimizer.freeze_step
        if self._onebit_known + self._onebit_pending + 1 <= freeze:
            return False
        self._onebit_known = int(self.state.opt_state.step)
        self._onebit_pending = 0
        self._onebit_frozen = self._onebit_known + 1 > freeze
        return self._onebit_frozen

    def _apply_onebit(self, win: "_Window") -> Dict[str, torch.Tensor]:
        """1-bit Adam's step closing a window: the warmup all-reduces the
        grads (mean), the compression stage only the compressed momentum
        (``ops/onebit.OnebitAdam.step``); the loss all-reduced for the
        report; the overflow bookkeeping and the loss scale as on the
        main path. ``onebit_comm_bytes`` is the step's payload a rank in
        the packed wire's accounting (the wire itself stays fp32)."""
        st = self.state
        scale = st.loss_scale
        compressed = self._onebit_phase()
        with torch.no_grad():
            inv = (1.0 / scale) if self.config.fp16_enabled else None
            lr = self.optimizer.lr_at(st.step)
            opt_state, grad_norm, overflow = self.optimizer.step(
                self._groups, st.opt_state, lr=lr, compressed=compressed,
                clip=self.gradient_clipping(), inv_scale=inv,
                all_reduce=comm.all_reduce if self.dp > 1 else None)
            mean_loss = win.mean_loss
            if self.dp > 1:
                mean_loss = comm.all_reduce(mean_loss.clone()) / self.dp
            self.state = st.replace(
                opt_state=opt_state,
                **_overflow_resolution(st, overflow, **self._scaler_kw))
        self._onebit_pending += 1
        self.onebit_comm_bytes = step_comm_bytes(
            [int(np.prod(s, dtype=np.int64)) for s in self._leaf_shapes],
            self.dp, compressed)
        metrics = {"loss": mean_loss, "grad_norm": grad_norm, "lr": lr,
                   "loss_scale": scale, "overflow": overflow,
                   "skipped_steps": self.state.skipped_steps}
        self._moe_means(metrics, win.moe_sum, win.gas)
        return metrics

    # ------------------------------------------------------------------ #
    # Sparse (CSR) embedding gradients (ZeRO stage 0, dp > 1)
    # ------------------------------------------------------------------ #
    def _init_sparse_gradients(self, sparse_grad_filter) -> None:
        """Mark the parameter leaves whose grads travel the CSR exchange:
        by default the 2-D leaves whose path contains "embed" or "wte";
        ``sparse_grad_filter(path_str, leaf) -> bool`` (the path in
        ``jax.tree_util.keystr`` form) overrides it. The exchange runs at
        dp > 1 only; at dp 1 the main path runs, as in JAX."""
        if self.zero_optimization_stage() >= 1:
            raise ValueError(
                "sparse_gradients requires ZeRO stage 0: under ZeRO grads "
                "are born dp-sharded and the dense reduce-scatter already "
                "ships 1/dp of every tensor")
        if self._onebit:
            raise ValueError(
                "sparse_gradients does not compose with OnebitAdam (the "
                "compressed momentum exchange replaces the grad allreduce)")

        def default(path, leaf):
            p = path.lower()
            return getattr(leaf, "ndim", 0) == 2 and \
                ("embed" in p or "wte" in p)

        filt = sparse_grad_filter or default
        leaves = tree_flatten(self.state.params)[0]
        for i, (path, leaf) in enumerate(zip(
                keystr_paths(self.state.params), leaves)):
            if bool(filt(path, leaf)):
                self._sparse_idx.append(i)
                self._sparse_names.append(path)
        if not self._sparse_idx:
            logger.warning("sparse_gradients enabled but no param leaf "
                           "matched the embedding predicate — dense "
                           "allreduce will be used for everything")
            return
        # Each group's runs of dense leaves (contiguous ranges of its
        # grad buffer), all-reduced a run at a time.
        sparse = set(self._sparse_idx)
        for grp, idxs in zip(self._groups, self._group_leaves):
            runs: List[Tuple[int, int]] = []
            for i, off, n in zip(idxs, grp.offsets, grp.sizes):
                if i in sparse:
                    continue
                if runs and runs[-1][0] + runs[-1][1] == off:
                    runs[-1] = (runs[-1][0], runs[-1][1] + n)
                else:
                    runs.append((off, n))
            self._dense_runs.append(runs)
        for n in self._sparse_names:
            log_dist(f"Will convert {n} to sparse (csr) tensor during "
                     "training", ranks=[0])

    def _apply_sparse(self, win: "_Window") -> Dict[str, torch.Tensor]:
        """The step closing a window at dp > 1 with sparse leaves: the
        dense leaves' grads all-reduced (mean) and unscaled, the sparse
        leaves' through the CSR exchange (``_csr_exchange``, unscaled
        there), then the optimizer's step with nothing left to unscale
        (norm, fp16 vote, clip, update, skip), the overflow bookkeeping
        and the loss scale. A non-finite value that the exchange
        gathered makes the norm non-finite: the vote spans both kinds of
        leaves."""
        st = self.state
        scale = st.loss_scale
        fp16 = self.config.fp16_enabled
        clip = self.gradient_clipping()
        with torch.no_grad():
            inv = (1.0 / scale) if fp16 else None
            mult = torch.full((), 1.0 / self.dp, dtype=torch.float32,
                              device=self.device)
            if inv is not None:
                mult = mult * inv
            for grp, runs in zip(self._groups, self._dense_runs):
                for off, n in runs:
                    run = grp.grad.narrow(0, off, n)
                    comm.all_reduce(run)
                    run.mul_(mult)
            with self.telemetry.span("grad_sync", path="csr_exchange"):
                shipped, dense_n = self._csr_exchange(inv)
            mean_loss = comm.all_reduce(win.mean_loss.clone()) / self.dp
            tap = self._grad_tap()
            opt_state, grad_norm, overflow = self.optimizer.step(
                self._opt_groups, st.opt_state, clip=clip, inv_scale=None,
                fp16=fp16, compute_norm=bool(clip and clip > 0) or fp16)
            lr = self.optimizer.lr_at(st.step)
            self.state = st.replace(
                opt_state=opt_state,
                **_overflow_resolution(st, overflow, **self._scaler_kw))
        self.sparse_comm_stats = {"sparse_elements": int(shipped),
                                  "dense_elements": int(dense_n)}
        metrics = {"loss": mean_loss, "grad_norm": grad_norm, "lr": lr,
                   "loss_scale": scale, "overflow": overflow,
                   "skipped_steps": self.state.skipped_steps}
        if tap is not None:
            metrics[HEALTH_TAP_KEY] = tap
        self._moe_means(metrics, win.moe_sum, win.gas)
        return metrics

    def _csr_exchange(self, inv: Optional[torch.Tensor]) -> Tuple[int, int]:
        """Replace each sparse leaf's local grads with the dp mean of
        every rank's, through CSR: this rank's nonzero rows, an all-gather
        of the row counts, then of the rows' indices and values padded to
        the largest count, the ranks' rows coalesced in rank order,
        unscaled (fp16), densified and divided by dp (the JAX
        ``_csr_exchange``). The counts are read on the host: the path's
        host syncs. Returns ``(elements shipped, dense elements)``, the
        elements over every rank."""
        shipped = dense_n = 0
        dev = self.device
        for i in self._sparse_idx:
            g = self._grad_views[i]
            local = CSRTensor.from_dense(g)
            n_local = local.row_indices.numel()
            counts = comm.all_gather(torch.full((1,), n_local,
                                                dtype=torch.int64,
                                                device=dev)).tolist()
            width = max(counts)
            dense_n += g.numel()
            if width == 0:
                g.zero_()
                continue
            idx = torch.zeros(width, dtype=torch.int64, device=dev)
            val = torch.zeros((width, g.shape[1]), dtype=g.dtype,
                              device=dev)
            idx[:n_local] = local.row_indices
            val[:n_local] = local.values
            idx_all = comm.all_gather(idx).view(self.dp, width)
            val_all = comm.all_gather(val).view(self.dp, width, g.shape[1])
            shards = [CSRTensor(idx_all[r, :c], val_all[r, :c],
                                tuple(g.shape)) for r, c in enumerate(counts)]
            shipped += sum(s.sparse_size() for s in shards)
            merged = all_gather_csr(shards)
            vals = merged.values if inv is None else merged.values * inv
            g.copy_(CSRTensor(merged.row_indices, vals,
                              merged.dense_shape).to_dense() / self.dp)
        return shipped, dense_n

    # ------------------------------------------------------------------ #
    # The reference's forward/backward/step trio, and eval
    # ------------------------------------------------------------------ #
    def forward(self, batch: Any) -> torch.Tensor:
        """One micro-batch's loss, with its graph kept for ``backward``
        (the JAX trio's ``forward``: a rank's micro-batch of ``micro``
        rows). The first ``forward`` of an accumulation window opens it:
        the step's generator, from which the window's micro-batches draw
        in sequence, as ``train_batch``'s do, so a window of gas trio
        calls updates the parameters bit for bit as ``train_batch`` on
        the same rows. Returns the raw loss, detached."""
        self._refuse_trio_onebit()
        if self._offload is not None:
            raise _unported(
                "the forward/backward/step trio under zero_optimization."
                "cpu_offload (the JAX trio's apply reads a device optimizer "
                "state that offload does not keep, and runs no host step)",
                "queue 1 item 5: the trio under offload")
        if self._trio_pending is not None:
            raise RuntimeError(
                "forward() twice without backward(): the first graph would "
                "be held beside the second; call backward() after each "
                "forward()")
        if self._trio is None:
            self._trio = self._open_window(self.global_steps)
            self.tput_timer.start()
            # step()'s telemetry wall_ms covers the whole window.
            self._trio_t0 = time.perf_counter()
        self._trio_used = True
        with self.telemetry.span("grad_compute"):
            scaled, raw, inputs = self._grad_fwd_fn(
                self, self._trio, self._to_device(batch),
                self.state.loss_scale)
        loss = raw.detach()
        self._trio_pending = (scaled, inputs, loss)
        return loss

    __call__ = forward

    def backward(self, loss: Optional[torch.Tensor] = None,
                 allreduce_gradients: bool = True) -> Optional[torch.Tensor]:
        """Add the gradients of the last ``forward``'s loss into the
        window's accumulators and count a micro-step. ``loss`` is None
        or the tensor ``forward`` returned: the trio differentiates the
        forward's loss only, as the JAX trio does. The gradient
        reduction across ranks runs at the boundary (``step``);
        ``allreduce_gradients`` is accepted for the reference's
        signature."""
        self._refuse_trio_onebit()
        if self._trio_pending is None:
            raise AssertionError("call forward() before backward()")
        scaled, inputs, returned = self._trio_pending
        if loss is not None and loss is not returned:
            raise ValueError(
                "backward() takes None or the loss forward() returned: the "
                "trio differentiates the forward's own loss, so a loss "
                "computed from it is not supported")
        self._trio_pending = None
        with self.telemetry.span("grad_compute"):
            self._grad_bwd_fn(self, self._trio, scaled, inputs)
        self.micro_steps += 1
        return loss

    def step(self) -> None:
        """At a gradient-accumulation boundary, the optimizer step over
        the window's gradients (the tail of ``train_batch``); elsewhere a
        no-op, as the reference gates it."""
        self._refuse_trio_onebit()
        if self.micro_steps % self.gradient_accumulation_steps() != 0:
            return
        if self._trio is None or self._trio.done == 0:
            raise AssertionError("no gradients accumulated")
        if self._trio_pending is not None:
            raise RuntimeError("step() after a forward() whose backward() "
                               "has not run")
        win, self._trio = self._trio, None
        t_apply = time.perf_counter()
        t0 = self._trio_t0 if self._trio_t0 is not None else t_apply
        self._trio_t0 = None
        with self._state_changing():
            with self.telemetry.span("optimizer_apply"):
                metrics = self._apply_grads_fn(self, win)
            self._finish_step(metrics, t0, t_apply)

    def _refuse_trio_onebit(self) -> None:
        if self._onebit:
            raise NotImplementedError(
                "OnebitAdam supports train_batch() only: the compressed "
                "allreduce lives inside the fused step, which the "
                "forward/backward/step split cannot drive")

    def is_gradient_accumulation_boundary(self) -> bool:
        return (self.micro_steps + 1) % \
            self.gradient_accumulation_steps() == 0

    def zero_optimization(self) -> bool:
        return self.config.zero_enabled

    def get_lr(self) -> List[float]:
        return [float(self._schedule_fn(self.global_steps))]

    def eval_batch(self, batch: Any,
                   rng: Union[int, torch.Generator, None] = None
                   ) -> torch.Tensor:
        """The loss of ``batch`` (a rank's rows) on the compute-dtype
        parameters, without gradients and without touching the training
        state: the cast copy, the parameters themselves (fp32, master-
        free), the stage-3 leaves gathered without autograd, or the
        offload engine's device copy. ``rng``: an int seed or a
        generator; by default one derived from the base seed and a count
        of eval calls. At dp > 1 the mean over the ranks (a collective)."""
        if isinstance(rng, torch.Generator):
            gen = rng
        else:
            seed = fold_in(fold_in(self._base_seed, _EVAL_FOLD),
                           self._eval_count) if rng is None else int(rng)
            self._eval_count += 1
            gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            if self._offload is not None:
                params = tree_unflatten(self._treedef, self._param_views)
            elif self._zero3:
                params = self.full_params()
            elif self.state.cast_params is not None:
                params = self.state.cast_params
            else:
                params = self.state.params
            params = tree_unflatten(self._treedef, [
                t.to(self.compute_dtype) if t.is_floating_point() else t
                for t in tree_flatten(params)[0]])
            out = self.loss_fn(params, self._to_device(batch), gen)
            loss = (out[0] if isinstance(out, tuple) else out).detach()
            if self.dp > 1:
                loss = comm.all_reduce(loss.float().clone()) / self.dp
        return loss

    # ------------------------------------------------------------------ #
    # Data parallelism and ZeRO (dp > 1)
    # ------------------------------------------------------------------ #
    def _scratch_buffer(self, gi: int, dtype: torch.dtype) -> torch.Tensor:
        """A reusable ``[V * Lpad]`` buffer of group ``gi`` in ``dtype``
        (packing and gathering the whole V-layout)."""
        key = (gi, dtype)
        buf = self._scratch.get(key)
        if buf is None:
            buf = torch.zeros(self._shards[gi].full_numel, dtype=dtype,
                              device=self.device)
            self._scratch[key] = buf
        return buf

    def _scatter_grads(self, grads, first: bool) -> None:
        """ZeRO-2: pack one micro-step's grads into the V-layout in fp32
        and reduce-scatter them; each rank adds its rows to its grads."""
        for gi, (sg, idxs) in enumerate(zip(self._shards,
                                            self._group_leaves)):
            full = self._scratch_buffer(gi, torch.float32)
            sg.pack([grads[i] for i in idxs], full, rows=(0, sg.shards))
            if first:
                comm.reduce_scatter(full, out=sg.grad)
            else:
                sg.grad.add_(comm.reduce_scatter(full))

    def _reduce_grads(self) -> None:
        """After the micro-steps: stage 0 all-reduces the natural grads;
        stage 1 (and stage 2 with ``reduce_scatter: false``) all-reduces
        them and keeps this rank's rows; stages 2-3 already hold their
        reduced rows."""
        if self._rs_grads:
            return
        for gi, grp in enumerate(self._groups):
            comm.all_reduce(grp.grad)
            if self._shard_local:
                self._shards[gi].pack(grp.views(grp.grad),
                                      self._shards[gi].grad)

    def _gather_params(self) -> None:
        """Stages 1-2: every rank's updated rows → the natural buffers
        the model views, and the compute-dtype copy re-cast from them
        (bit-equal to the kernel's cast of the same fp32 values)."""
        for gi, (grp, sg) in enumerate(zip(self._groups, self._shards)):
            full = comm.all_gather(sg.param,
                                   out=self._scratch_buffer(gi, sg.dtype))
            sg.unpack(full, grp.views(grp.param))
            if grp.cast is not None:
                grp.cast.copy_(grp.param)

    def _zero3_gather(self) -> Tuple[List[torch.Tensor], Any,
                                     Dict[int, Any]]:
        """Stage 3: the parameter tree gathered from every rank's rows in
        the compute dtype (``gather_cast``); returns the local rows the
        gradient comes back to (``inputs``), the tree, and each leaf's
        re-gather for ``regather_saved``."""
        inputs: List[torch.Tensor] = []
        leaves: List[Any] = [None] * len(self._leaf_shapes)
        regather: Dict[int, Any] = {}
        dtype = self.compute_dtype
        for sg, idxs in zip(self._shards, self._group_leaves):
            parts = [v.detach().requires_grad_(True)
                     for v in sg.local_views(sg.param)]
            shapes = [self._leaf_shapes[i] for i in idxs]
            for i, x, shape, leaf in zip(idxs, parts, shapes,
                                         gather_tree(parts, shapes, dtype)):
                leaves[i] = leaf
                regather[i] = ((lambda x=x, shape=shape:
                                _gather(x.detach(), shape, dtype)), leaf)
            inputs += parts
        return inputs, tree_unflatten(self._treedef, leaves), regather

    # ------------------------------------------------------------------ #
    # ZeRO-Offload (runtime/zero/offload.py)
    # ------------------------------------------------------------------ #
    def _init_offload(self, masters: List[torch.Tensor],
                      scaler_cfg: Dict[str, Any]) -> None:
        """The offload state (the JAX engine's construction,
        ``engine.py:400-470``): the fp32 masters (CPU, full leaves, rank
        0's at dp > 1) go to a host ``ZeroOffloadOptimizer``; the card
        keeps the compute-dtype params and the fp32 grads, each one flat
        buffer in leaf order, and no optimizer state. At dp > 1 each rank
        holds its partition (``partition_rank`` = rank, ``partition_num``
        = ``axis_divisor`` = dp) and the partitioned squared norm is
        all-reduced."""
        zc = self.config.zero_config
        dev = self.device
        cuda = dev.type == "cuda"
        part: Dict[str, Any] = {}
        if self.dp > 1:
            part = dict(partition_rank=self.dp_rank, partition_num=self.dp,
                        axis_divisor=self.dp,
                        sumsq_allreduce=self._all_reduce_float)
        off = ZeroOffloadOptimizer(
            tree_unflatten(self._treedef, masters),
            self.config.optimizer_name, dict(self.config.optimizer_params
                                             or {}),
            self._schedule_fn, self.compute_dtype,
            gradient_clipping=self.gradient_clipping(),
            fp16=self.config.fp16_enabled, scaler_cfg=scaler_cfg,
            bucket_bytes=zc.offload_bucket_size,
            host_threads=zc.offload_host_threads, pin_memory=cuda, **part)
        self._offload = self.optimizer = off
        # overlap_comm selects the overlapped pipeline (one process only,
        # as in JAX).
        self._offload_overlap = bool(zc.overlap_comm)
        if self._offload_overlap and self.dp > 1:
            log_dist("zero_optimization.overlap_comm: overlapped offload is "
                     "single-process only for now; falling back to the "
                     "serial offload step", ranks=[0])
            self._offload_overlap = False
        n = sum(int(np.prod(s, dtype=np.int64)) for s in self._leaf_shapes)
        self._dev_params = torch.empty(n, dtype=self.compute_dtype,
                                       device=dev)
        self._param_views = _flat_views(self._dev_params, self._leaf_shapes)
        grads = torch.empty(n, dtype=torch.float32, device=dev)
        self._grad_views = _flat_views(grads, self._leaf_shapes)
        with torch.no_grad():
            for pv, m in zip(self._param_views, masters):
                pv.copy_(m)
        # This rank's partition of the grads (at dp 1 the grads
        # themselves), and the pinned host buffer they cross into: bf16
        # in bf16 runs, else fp32, as in JAX.
        self._local_grads = torch.empty(off.offsets[-1], dtype=torch.float32,
                                        device=dev) if self.dp > 1 else grads
        self._local_grad_views = _flat_views(self._local_grads, off.shapes)
        wire = torch.bfloat16 if self.compute_dtype == torch.bfloat16 \
            else torch.float32
        self._host_wire = torch.empty(off.offsets[-1], dtype=wire,
                                      pin_memory=cuda)
        self._host_wire_views = _flat_views(self._host_wire, off.shapes)
        self._copy_stream = torch.cuda.Stream(dev) \
            if self._offload_overlap and cuda else None

    def _offload_scalars(self) -> Dict[str, torch.Tensor]:
        """The host machine's counters as the state's (CPU) tensors."""
        off = self._offload
        i32 = dict(dtype=torch.int32)
        return dict(step=torch.tensor(off.step_count, **i32),
                    loss_scale=torch.tensor(off.loss_scale,
                                            dtype=torch.float32),
                    growth_count=torch.tensor(off.growth_count, **i32),
                    hysteresis=torch.tensor(off.hysteresis, **i32),
                    skipped_steps=torch.tensor(off.skipped_steps, **i32))

    def _all_reduce_float(self, x: float) -> float:
        t = torch.tensor([x], dtype=torch.float64, device=self.device)
        return float(comm.all_reduce(t))

    def _mark(self, stream=None, blocking: bool = False):
        """A point on the device's timeline: a recorded CUDA event (on
        ``stream``, default the current one), or the host clock on the
        CPU. ``blocking``: a host thread that waits on it sleeps instead
        of spinning."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True, blocking=blocking)
        ev.record(stream)
        return ev

    def _wait(self, mark) -> None:
        if self.device.type == "cuda":
            mark.synchronize()

    def _elapsed_ms(self, a, b) -> float:
        if self.device.type == "cuda":
            return float(a.elapsed_time(b))
        return (b - a) * 1e3

    def _offload_grads(self, micro_batches: List[Any], step: int
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The grad pass: the micro-steps at the host's loss scale into
        the fp32 grads; at dp > 1 each rank's partition of their sum over
        the ranks into ``_local_grads`` (times 1/dp, exact for dp a power
        of two: each rank's loss is its own rows' mean) and the mean loss
        over the ranks."""
        mean_loss, moe_sum = self._micro_steps(
            micro_batches, self._open_window(step), self._offload.loss_scale)
        if self.dp > 1:
            with torch.no_grad():
                self._offload_reduce_grads()
                mean_loss = comm.all_reduce(mean_loss.clone()) / self.dp
        return mean_loss, moe_sum

    def _offload_reduce_grads(self) -> None:
        """dp > 1: each leaf's grads reduce-scattered along its partition
        axis (all-reduced where it has none) into this rank's partition."""
        off = self._offload
        for g, dst, ax in zip(self._grad_views, self._local_grad_views,
                              off._axes):
            if ax is None:
                dst.copy_(comm.all_reduce(g))
                continue
            part = comm.reduce_scatter(g.movedim(ax, 0).contiguous()
                                       .view(-1))
            dst.copy_(part.view(dst.movedim(ax, 0).shape).movedim(0, ax))
        self._local_grads.mul_(1.0 / self.dp)

    def _offload_upload(self, b: int, leaves=None) -> None:
        """Bucket ``b``'s compute-dtype copy to the card (one range of the
        pinned staging buffer, asynchronous)."""
        a, e = self._offload.bucket_range(b)
        self._dev_params[a:e].copy_(self._offload.staging_flat[a:e],
                                    non_blocking=True)

    def _offload_put_params(self) -> None:
        """The device params from the host staging copy: at dp 1 one
        copy; at dp > 1 every rank's partition all-gathered along each
        leaf's axis."""
        off = self._offload
        with torch.no_grad():
            if self.dp == 1:
                self._dev_params.copy_(off.staging_flat, non_blocking=True)
                return
            local = off.staging_flat.to(self.device)
            for pv, loc, ax in zip(self._param_views,
                                   _flat_views(local, off.shapes),
                                   off._axes):
                if ax is None:
                    pv.copy_(loc)
                    continue
                full = comm.all_gather(loc.movedim(ax, 0).contiguous())
                pv.copy_(full.view(pv.movedim(ax, 0).shape).movedim(0, ax))

    def _train_step_offload(self, micro_batches: List[Any], step: int
                            ) -> Dict[str, Any]:
        """One offload step (the JAX ``_train_batch_offload`` and
        ``_offload_step_overlapped``): the grad pass on the card, the
        grads to the host bucket by bucket, the host's two-phase step,
        and each bucket's compute-dtype params back to the card.

        Serial: each bucket's copy to the host is fenced on its own; the
        uploads go on the current stream, so the next forward follows
        them. Overlapped: every bucket's copy is enqueued on a copy
        stream after the grad pass, an event each; this thread waits
        bucket by bucket while the pool runs the norms, then Adam; each
        finished bucket goes up on the copy stream, and the current
        stream waits on the uploads' event (on the device: the host does
        not wait). ``offload_timings`` holds the JAX keys;
        ``device_step_ms`` is the grad pass by CUDA events."""
        off = self._offload
        t_pre = time.perf_counter()
        m0 = self._mark()
        scale = off.loss_scale
        mean_loss, moe_sum = self._offload_grads(micro_batches, step)
        with torch.no_grad():
            metrics, timings, h2d_wait_ms, m1 = self._offload_host_step()
        timings["device_step_ms"] = self._elapsed_ms(m0, m1)
        timings["h2d_wait_ms"] = h2d_wait_ms
        timings["wall_ms"] = (time.perf_counter() - t_pre) * 1e3
        self.offload_timings = timings
        self.skipped_steps = off.skipped_steps
        self.state = self.state.replace(**self._offload_scalars())
        out = {"loss": mean_loss, "grad_norm": metrics["grad_norm"],
               "lr": metrics["lr"], "loss_scale": scale,
               "overflow": metrics["overflow"],
               "skipped_steps": off.skipped_steps,
               "clip_coeff": metrics["clip_coeff"]}
        self._moe_means(out, moe_sum, len(micro_batches))
        return out

    def _offload_host_step(self):
        """The grads to the host, the bucketed host step, the params back
        (serial or overlapped); returns the step's metrics and timings,
        the host's ms in the uploads' fence and the grad pass's end
        mark."""
        off = self._offload
        wire = self._local_grads.to(self._host_wire.dtype)
        m1 = self._mark()
        views = self._host_wire_views
        cs = self._copy_stream
        h2d_wait_ms = 0.0

        def copy_down(b: int) -> None:
            a, e = off.bucket_range(b)
            self._host_wire[a:e].copy_(wire[a:e], non_blocking=True)

        if not self._offload_overlap:
            self._wait(m1)

            def fetch(b):
                copy_down(b)
                self._wait(self._mark())
                return [views[i] for i in off.buckets[b]]

            metrics, timings = run_bucketed_step(
                off, fetch, self._offload_upload if self.dp == 1 else None,
                overlap=False)
            if self.dp > 1 and not metrics["overflow"]:
                self._offload_put_params()
        else:
            events: List[Any] = []
            if cs is not None:
                cs.wait_event(m1)
                if wire is not self._local_grads:
                    wire.record_stream(cs)
                with torch.cuda.stream(cs):
                    for b in range(off.num_buckets()):
                        copy_down(b)
                        # (blocking: the waiting thread would spin on a
                        # core the pool's OpenMP team is using)
                        events.append(self._mark(cs, blocking=True))

            def fetch(b):
                if cs is None:
                    copy_down(b)
                else:
                    events[b].synchronize()
                return [views[i] for i in off.buckets[b]]

            def upload(b, leaves):
                with torch.cuda.stream(cs) if cs is not None else \
                        contextlib.nullcontext():
                    self._offload_upload(b)

            metrics, timings = run_bucketed_step(off, fetch, upload,
                                                 overlap=True)
            if cs is not None:
                done = self._mark(cs)
                t = time.perf_counter()
                torch.cuda.current_stream(self.device).wait_event(done)
                h2d_wait_ms = (time.perf_counter() - t) * 1e3
        return metrics, timings, h2d_wait_ms, m1

    def loss_scale(self) -> float:
        """The current loss scale (the host machine's under offload)."""
        if self._offload is not None:
            return float(self._offload.loss_scale)
        return float(self.state.loss_scale)

    def _maybe_log(self, metrics: Dict[str, torch.Tensor]) -> None:
        spp = self.steps_per_print()
        if spp and self.global_steps % spp == 0:
            log_dist(f"step={self.global_steps} "
                     f"loss={float(metrics['loss']):.4f} "
                     f"grad_norm={float(metrics['grad_norm']):.4f} "
                     f"lr={float(metrics['lr']):.3e} "
                     f"loss_scale={float(metrics['loss_scale'])} "
                     f"skipped={int(metrics['skipped_steps'])}", ranks=[0])
        self.telemetry.maybe_drain(self.global_steps,
                                   extra_fn=self._report_extra)

    # ------------------------------------------------------------------ #
    # Checkpointing (the JAX engine's files, runtime/async_ckpt.py)
    # ------------------------------------------------------------------ #
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict[str, Any]] = None,
                        save_latest: bool = True) -> bool:
        """Save a checkpoint. With ``checkpoint.async`` the call returns
        after the snapshot (the state copied whole to host memory, one
        wait on the card) and a background thread serializes and
        commits; otherwise the whole save runs inline. Both routes share
        the snapshot and the two-phase commit, so the files are byte for
        byte the same either way."""
        if self._async_ckpt is not None:
            return self._save_checkpoint_async(save_dir, tag, client_state,
                                               save_latest)
        with self.telemetry.span("checkpoint_save",
                                 tag=str(tag) if tag is not None else "auto"):
            return self._save_checkpoint(save_dir, tag, client_state,
                                         save_latest)

    def _save_checkpoint_async(self, save_dir: str, tag: Optional[str],
                               client_state: Optional[Dict[str, Any]],
                               save_latest: bool) -> bool:
        err = self._async_ckpt.last_error
        if err is not None:
            # Surface a failed background write on the NEXT save, where
            # a caller can react — not silently in a daemon thread.
            self._async_ckpt.last_error = None
            raise RuntimeError(
                "a previous background checkpoint write failed "
                f"({type(err).__name__}: {err}); the checkpoint it was "
                "writing is lost (latest still names the prior one)") \
                from err
        # The exposed cost of an async save: the snapshot and any wait
        # for room in the writer's queue (the goodput ledger's
        # checkpoint bucket); the write itself is the writer thread's.
        with self.telemetry.span(
                "checkpoint_snapshot",
                tag=str(tag) if tag is not None else "auto"):
            # Bound host memory: each pending snapshot is a full host
            # copy of the state. A writer still wedged after
            # writer_timeout_s fails the save loudly rather than
            # queueing another copy.
            if not self._async_ckpt.wait_below(
                    self._ckpt_max_pending,
                    timeout=self._ckpt_writer_timeout):
                raise RuntimeError(
                    "checkpoint writer still busy after "
                    f"{self._ckpt_writer_timeout:.0f}s — refusing to queue "
                    "another full-state host snapshot past "
                    f"max_pending_snapshots={self._ckpt_max_pending} (see "
                    "the writer watchdog's stack dump)")
            snap = self._snapshot_checkpoint(save_dir, tag, client_state,
                                             save_latest)
        crash_point("after_snapshot")
        self._async_ckpt.submit(snap)
        self._note_saved(save_dir, save_latest)
        log_dist(f"checkpoint snapshot {snap.path} taken (background "
                 "write queued)", ranks=[0])
        return True

    def _save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                         client_state: Optional[Dict[str, Any]] = None,
                         save_latest: bool = True) -> bool:
        """Synchronous save: snapshot + inline commit."""
        snap = self._snapshot_checkpoint(save_dir, tag, client_state,
                                         save_latest)
        path = commit_snapshot(snap)
        if self.dp > 1:
            comm.barrier()       # the other ranks wait for rank 0's commit
        self._note_saved(save_dir, save_latest)
        log_dist(f"saved checkpoint {path}", ranks=[0])
        return True

    def _note_saved(self, save_dir: str, save_latest: bool) -> None:
        """The last step whose state reached the auto-save dir's
        ``latest`` — the preemption save's dedup key."""
        if save_latest and self._ckpt_dir and \
                os.path.abspath(save_dir) == os.path.abspath(self._ckpt_dir):
            self._last_saved_step = self.global_steps

    def _snapshot_checkpoint(self, save_dir: str, tag: Optional[str],
                             client_state: Optional[Dict[str, Any]],
                             save_latest: bool) -> CheckpointSnapshot:
        """Capture the state into a host-side ``CheckpointSnapshot`` in
        the JAX engine's layout at mp 1: the model file, one optimizer
        file per dp rank (``zero_pp_rank_{d}``), and the meta. Each flat
        buffer (params, m, v) is copied whole to host memory with the six
        scalars stacked into one int32 tensor, behind one wait on the
        card; the moments' conversion to the JAX layout and the msgpack
        encoding run in the lazy blob builders, so the async writer pays
        for them.

        Across dp ranks every rank calls this (it is collective): at
        ZeRO stage >= 1 each rank's moment rows (and, at stage 3, its
        parameter rows) are gathered to rank 0 here, on the calling
        thread — never on the writer thread, where a collective would
        interleave with the step's — and rank 0 alone writes. A rank's
        rows of a moment buffer are the JAX engine's shard of it (the
        flat axis split in dp parts), so they are written as they are."""
        if tag is None:
            tag = f"global_step{self.global_steps}"
        self._checkpoint_tag_validation(tag)
        dp = self.dp
        meta: Dict[str, Any] = {
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "skipped_steps": self.skipped_steps,
            "dp_world_size": dp,
            "ds_config_precision": self.config.precision_dtype,
            "client_state": client_state or {},
            "fused_moment_layout": FUSED_MOMENT_LAYOUT,
        }
        if self.lr_scheduler is not None and \
                hasattr(self.lr_scheduler, "state_dict"):
            meta["lr_scheduler"] = self.lr_scheduler.state_dict()
        if self._offload is not None:
            del meta["fused_moment_layout"]
            return self._snapshot_offload(save_dir, str(tag), save_latest,
                                          meta)
        if self._onebit:
            del meta["fused_moment_layout"]
            return self._snapshot_onebit(save_dir, str(tag), save_latest,
                                         meta)

        if not isinstance(self.optimizer, FusedAdam):
            # (a torch.optim optimizer raises here: no JAX layout)
            layout = self.optimizer.jax_layout()
            del meta["fused_moment_layout"]
        st = self.state
        opt = st.opt_state
        scalars = torch.stack([
            opt.count.to(torch.int32), st.step.to(torch.int32),
            st.loss_scale.to(torch.float32).view(torch.int32),
            st.growth_count.to(torch.int32), st.hysteresis.to(torch.int32),
            st.skipped_steps.to(torch.int32)])
        G = len(self._opt_groups)
        # The state's buffers, name by name and group by group (the fused
        # Adam's m then v; an optax chain's in its state's order).
        names = list(state_buffers(opt))
        flat_bufs = [b for n in names for b in state_buffers(opt)[n]]
        K = len(flat_bufs)
        if self._shard_local:
            # Every rank's rows on rank 0, rank order (collective).
            rows = [comm.gather(b) for b in flat_bufs]
            if self._zero3:
                rows += [comm.gather(sg.param) for sg in self._shards]
            is_writer = self.dp_rank == 0
            if not is_writer:
                self.skipped_steps = int(st.skipped_steps)
                return CheckpointSnapshot(
                    save_dir=save_dir, tag=str(tag),
                    save_latest=save_latest, meta=meta, blobs=[],
                    is_writer=False, fsync=self._ckpt_fsync)
            flat_rows = [t for per in rows for t in per]
            natural = [] if self._zero3 else [g.param for g in self._groups]
            host = _host_copies(natural + flat_rows + [scalars])
            host_rows = [host[len(natural) + k * dp:
                              len(natural) + (k + 1) * dp]
                         for k in range(len(rows))]
        else:
            is_writer = self.dp_rank == 0
            host = _host_copies([g.param for g in self._groups] +
                                flat_bufs + [scalars])
        sc = host[-1].numpy()
        count, step_v, growth_v, hyst_v, skipped_v = (
            np.array(sc[i]) for i in (0, 1, 3, 4, 5))
        scale_v = np.array(sc[2:3].view(np.float32)[0])
        self.skipped_steps = int(skipped_v)
        meta["skipped_steps"] = self.skipped_steps
        scalars_blob = {"step": step_v, "loss_scale": scale_v,
                        "growth_count": growth_v, "hysteresis": hyst_v,
                        "skipped": skipped_v}

        n_leaves = len(self._leaf_shapes)
        if self._zero3:
            def host_params_fn(prow=host_rows[K:]) -> Any:
                out: List[Any] = [None] * n_leaves
                for sg, idxs, per in zip(self._shards, self._group_leaves,
                                         prow):
                    lv = [torch.empty(self._leaf_shapes[i], dtype=sg.dtype)
                          for i in idxs]
                    sg.unpack(torch.cat(per), lv)
                    for i, t in zip(idxs, lv):
                        out[i] = t
                return tree_unflatten(self._treedef, out)
        else:
            leaves: List[Any] = [None] * n_leaves
            for grp, idxs, hp in zip(self._groups, self._group_leaves, host):
                for i, view in zip(idxs, grp.views(hp)):
                    leaves[i] = view
            host_params = tree_unflatten(self._treedef, leaves)

            def host_params_fn(hp=host_params) -> Any:
                return hp

        def model_blob() -> bytes:
            return msgpack_serialize({"module": host_params_fn()})

        blobs: List[Any] = [(MODEL_FILE, model_blob)]
        meta["optim_shards"] = dp
        if not isinstance(self.optimizer, FusedAdam):
            # An optax chain: its state's leaves whole (rank 0 writes one
            # file at any dp, as offload does; JAX's load re-partitions).
            host_bufs = [torch.cat(per) for per in host_rows[:K]] \
                if self._shard_local else host[G:G + K]
            meta["optim_shards"] = 1
            leaf_list = self._optax_leaves(layout, names, host_bufs, count)
            meta["optim_shard_axes"] = [None] * len(leaf_list)

            def optax_blob(leaf_list=leaf_list) -> bytes:
                blob: Dict[str, Any] = {str(i): x
                                        for i, x in enumerate(leaf_list)}
                blob["__scalars__"] = scalars_blob
                return msgpack_serialize(blob)
            blobs.append((OPTIM_SHARD_FMT.format(0), optax_blob))
            return CheckpointSnapshot(
                save_dir=save_dir, tag=str(tag), save_latest=save_latest,
                meta=meta, blobs=blobs, is_writer=is_writer,
                fsync=self._ckpt_fsync)
        if self._shard_local:
            # The moments split along their flat axis, one file a rank.
            meta["optim_shard_axes"] = [None] + [0] * (2 * G)

            def optim_blob(r: int, hr=host_rows) -> bytes:
                blob: Dict[str, Any] = {}
                if r == 0:
                    blob["0"] = np.asarray(count)
                for k in range(2 * G):
                    blob[str(k + 1)] = hr[k][r].numpy()
                if r == 0:
                    blob["__scalars__"] = scalars_blob
                return msgpack_serialize(blob)
        else:
            # Whole (replicated) moments in shard 0, as the JAX engine
            # writes an unsharded optimizer state at any dp.
            meta["optim_shard_axes"] = [None] * (1 + 2 * G)
            host_m, host_v = host[G:2 * G], host[2 * G:3 * G]

            def optim_blob(r: int, hm=host_m, hv=host_v) -> bytes:
                if r:
                    return msgpack_serialize({})
                jcount, jm, jv = convert.to_jax_fused_adam_state(
                    FusedAdamState(count=count, m=hm, v=hv),
                    host_params_fn())
                blob: Dict[str, Any] = {"0": np.asarray(jcount)}
                for i, buf in enumerate(list(jm) + list(jv)):
                    blob[str(i + 1)] = buf
                blob["__scalars__"] = scalars_blob
                return msgpack_serialize(blob)
        blobs += [(OPTIM_SHARD_FMT.format(r), lambda r=r: optim_blob(r))
                  for r in range(dp)]
        return CheckpointSnapshot(
            save_dir=save_dir, tag=str(tag), save_latest=save_latest,
            meta=meta, blobs=blobs, is_writer=is_writer,
            fsync=self._ckpt_fsync)

    def _optax_leaves(self, layout: List[str], names: List[str],
                      host_bufs: List[torch.Tensor], count: Any
                      ) -> List[Any]:
        """An optax chain's state as the JAX optimizer file's leaf list
        (``tree_leaves`` of the optax state): each count entry the
        int32 count, each buffer entry its per-parameter leaves in tree
        order, taken from the whole host buffers (``host_bufs``, name by
        name and group by group; V-layout rows joined at shard-local
        ZeRO)."""
        G = len(self._opt_groups)
        per_name: Dict[str, List[Any]] = {}
        for k, name in enumerate(names):
            leaves: List[Any] = [None] * len(self._leaf_shapes)
            for gi, idxs in enumerate(self._group_leaves):
                buf = host_bufs[k * G + gi]
                if self._shard_local:
                    sg = self._shards[gi]
                    lv = [torch.empty(self._leaf_shapes[i],
                                      dtype=torch.float32) for i in idxs]
                    sg.unpack(buf, lv)
                else:
                    lv = self._groups[gi].views(buf)
                for i, t in zip(idxs, lv):
                    leaves[i] = t
            per_name[name] = leaves
        out: List[Any] = []
        for entry in layout:
            if entry == COUNT:
                out.append(np.asarray(count, np.int32))
            else:
                out += per_name[entry]
        return out

    def preempt_save(self, reason: str = "SIGTERM") -> bool:
        """Final snapshot+commit for a dying run — the PreemptSaver's
        SIGTERM entry (callable directly). A background write in flight
        is waited for instead (that commit is the final checkpoint); a
        step already saved is not saved again. True when ``latest``
        names a checkpoint of the current step on return."""
        if not self._ckpt_dir:
            return False
        ck = self._async_ckpt
        awaited_ok = True
        if ck is not None and ck.in_flight:
            awaited_ok = bool(ck.wait(timeout=self._ckpt_writer_timeout))
            self.telemetry.event("preempt_save", {
                "reason": reason, "mode": "awaited_inflight",
                "ok": awaited_ok})
        # _last_saved_step is stamped at SUBMIT time; trust it only when
        # the writer committed.
        write_failed = ck is not None and ck.last_error is not None
        if awaited_ok and not write_failed and \
                self._last_saved_step == self.global_steps:
            return True
        # Inline even under async: a queued write would die with the
        # process.
        with self.telemetry.span("checkpoint_save", tag="preempt"):
            snap = self._snapshot_checkpoint(self._ckpt_dir, None, None,
                                             True)
            commit_snapshot(snap)
        if write_failed:
            # The inline commit superseded the lost write.
            ck.last_error = None
        self._last_saved_step = self.global_steps
        self.telemetry.event("preempt_save", {
            "reason": reason, "mode": "saved", "tag": snap.tag,
            "step": self.global_steps})
        log_dist(f"preemption save ({reason}): committed {snap.path}",
                 ranks=[0])
        return True

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_module_strict: bool = True,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True
                        ) -> Tuple[Optional[str], Dict[str, Any]]:
        """Load a checkpoint of the port or of the JAX engine (``tag``,
        else the one ``latest`` names). Returns ``(path, client_state)``,
        or ``(None, {})`` with the engine untouched when there is no
        complete checkpoint to load (no ``latest``, a missing tag, a
        torn tag without its ``engine_meta.json`` seal). Every file is
        read and checked before any state changes. A save from several
        dp ranks loads by joining its optimizer shards along the axes
        its meta records. ``load_module_strict=False`` loads the saved
        leaves whose path and shape match and keeps the others."""
        with self.telemetry.span("checkpoint_load", dir=str(load_dir)):
            return self._load_checkpoint(
                load_dir, tag, load_module_strict=load_module_strict,
                load_optimizer_states=load_optimizer_states,
                load_lr_scheduler_states=load_lr_scheduler_states)

    def _load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                         load_module_strict: bool = True,
                         load_optimizer_states: bool = True,
                         load_lr_scheduler_states: bool = True
                         ) -> Tuple[Optional[str], Dict[str, Any]]:
        if tag is None:
            latest = os.path.join(load_dir, LATEST_FILE)
            if not os.path.isfile(latest):
                logger.warning(f"no 'latest' file at {load_dir}; nothing "
                               "loaded")
                return None, {}
            with open(latest) as f:
                tag = f.read().strip()
        path = os.path.join(load_dir, str(tag))
        if not os.path.isdir(path):
            logger.warning(f"checkpoint {path} not found; nothing loaded")
            return None, {}
        if not is_complete(path):
            logger.warning(
                f"checkpoint {path} is INCOMPLETE (no engine_meta.json "
                "completeness seal) — a torn/interrupted save; refusing "
                "to load it")
            return None, {}
        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)

        if meta.get("pipeline_layer_files"):
            raise _unported("a checkpoint with pipeline per-layer files",
                            "slice 6: parallel axes and comm extras")
        if meta.get("mp_shards"):
            raise _unported(f"a tensor-parallel checkpoint "
                            f"({meta['mp_shards']} mp_rank model files)",
                            "slice 6: parallel axes and comm extras")
        if self._offload is not None:
            return self._load_offload(path, meta, load_module_strict,
                                      load_optimizer_states,
                                      load_lr_scheduler_states)
        optim_file = os.path.join(path, OPTIM_FILE_FMT)
        legacy_optim = None
        if load_optimizer_states and not meta.get("optim_shards") and \
                os.path.isfile(optim_file):
            with open(optim_file, "rb") as f:
                legacy_optim = msgpack_restore(f.read())
            if isinstance(legacy_optim, dict) and "offload" in legacy_optim:
                raise ValueError(
                    f"{optim_file} holds ZeRO-Offload host optimizer state: "
                    "load it into an engine with zero_optimization."
                    "cpu_offload, or with load_optimizer_states=False")
        fused = isinstance(self.optimizer, FusedAdam)
        if load_optimizer_states and isinstance(self.optimizer,
                                                TorchOptimizer):
            raise ValueError(
                f"{self.optimizer.name}'s state is torch.optim's "
                "state_dict, which the JAX checkpoint layout does not hold: "
                "load with load_optimizer_states=False and restore it with "
                "engine.optimizer.load_state_dict")
        if load_optimizer_states and fused and \
                int(meta.get("fused_moment_layout", 1)) != \
                FUSED_MOMENT_LAYOUT:
            # Refused before any state changes: the pre-layout-2 flat
            # buffers can have the same size and would scramble moments
            # across leaves.
            raise ValueError(
                f"checkpoint {path} stores fused optimizer moments in the "
                "pre-V-interleaved flat layout (no fused_moment_layout=2 "
                "in engine_meta.json); load with load_optimizer_states="
                "False (params restore, moments re-initialize)")
        if legacy_optim is not None:
            raise ValueError(
                f"{optim_file} has no shard map in engine_meta.json "
                "(optim_shards) — restore the sidecar, or load with "
                "load_optimizer_states=False")

        model_file = os.path.join(path, MODEL_FILE)
        if not os.path.isfile(model_file):
            logger.warning(f"checkpoint {model_file} not found")
            return None, {}
        with open(model_file, "rb") as f:
            probe = msgpack_restore(f.read())
        if not (isinstance(probe, dict) and "module" in probe):
            raise ValueError(
                f"{model_file} is a SHARDED (mp_rank) model checkpoint but "
                "engine_meta.json does not say so — restore the sidecar")
        new_leaves = self._checkpoint_param_leaves(probe["module"],
                                                   load_module_strict)

        opt_update = None
        if load_optimizer_states and meta.get("optim_shards"):
            n = int(meta["optim_shards"])
            blobs = self._read_shard_blobs(path, OPTIM_SHARD_FMT, n)
            if blobs is None:
                return None, {}
            G = len(self._opt_groups)
            if self._onebit:
                opt_state = self._onebit_state(path, meta, blobs)
            elif not fused:
                opt_state = self._optax_state(path, self._assemble_shards(
                    blobs, meta["optim_shard_axes"],
                    self._optax_leaf_count()))
            else:
                opt_state = self._fused_state(path, meta, blobs)
            sc = blobs[0]["__scalars__"]
            opt_update = (opt_state, int(sc["step"]),
                          float(sc["loss_scale"]), int(sc["growth_count"]),
                          int(sc["hysteresis"]), int(sc["skipped"]))

        # Every file read and checked: now the state changes.
        self._trio = self._trio_pending = None
        self._write_params(new_leaves)
        if opt_update is not None:
            self._write_opt_state(*opt_update)
        self.global_steps = int(meta.get("global_steps", 0))
        self.global_samples = int(meta.get("global_samples", 0))
        self.skipped_steps = int(meta.get("skipped_steps", 0))
        self.micro_steps = self.global_steps * \
            self.gradient_accumulation_steps()
        if load_lr_scheduler_states and self.lr_scheduler is not None and \
                "lr_scheduler" in meta and \
                hasattr(self.lr_scheduler, "load_state_dict"):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        log_dist(f"loaded checkpoint {path} at global_step="
                 f"{self.global_steps}", ranks=[0])
        return path, meta.get("client_state", {})

    def _fused_state(self, path: str, meta: Dict[str, Any],
                     blobs: List[Any]) -> FusedAdamState:
        """The fused Adam's state from the joined optimizer shards (the
        JAX fused-moment layout), as this engine's groups hold it."""
        G = len(self._opt_groups)
        leaves = self._assemble_shards(blobs, meta["optim_shard_axes"],
                                       1 + 2 * G)
        shards = max(convert.JAX_VIRTUAL_SHARDS,
                     int(meta.get("dp_world_size", 1)))
        try:
            if self._shard_local:
                # This rank's rows of the joined V-layout buffers.
                bufs = [convert.jax_local_rows(
                    convert.relayout_jax_buffer(b, sg.sizes, shards,
                                                sg.shards),
                    sg.sizes, sg.shards, self.dp, self.dp_rank)
                    for b, sg in zip(leaves[1:],
                                     self._shards + self._shards)]
                opt_state = FusedAdamState(
                    count=np.int32(np.asarray(leaves[0])),
                    m=tuple(bufs[:G]), v=tuple(bufs[G:]))
            else:
                opt_state = convert.from_jax_fused_adam_state(
                    leaves[0], leaves[1:1 + G], leaves[1 + G:],
                    self.state.params, shards=shards)
        except ValueError as e:
            raise ValueError(
                f"checkpoint {path}: the saved moment buffers do not "
                "fit this engine's parameter groups — the model or "
                f"its precision changed since the save ({e})") from e
        return opt_state

    # ------------------------------------------------------------------ #
    # 1-bit Adam checkpoints (the JAX engine's OnebitState layout)
    # ------------------------------------------------------------------ #
    def _group_bufs_to_leaves(self, bufs: List[torch.Tensor]
                              ) -> List[torch.Tensor]:
        """Per-group flat buffers → their leaves in tree order (views)."""
        out: List[Any] = [None] * len(self._leaf_shapes)
        for grp, idxs, buf in zip(self._groups, self._group_leaves, bufs):
            for i, view in zip(idxs, grp.views(buf)):
                out[i] = view
        return out

    def _leaves_to_group_bufs(self, leaves: List[Any]
                              ) -> Tuple[torch.Tensor, ...]:
        """Leaves in tree order → fp32 per-group flat buffers (host)."""
        out = []
        for grp, idxs in zip(self._groups, self._group_leaves):
            buf = torch.zeros(grp.numel, dtype=torch.float32)
            for view, i in zip(grp.views(buf), idxs):
                view.copy_(_as_tensor(leaves[i]).to(torch.float32))
            out.append(buf)
        return tuple(out)

    def _snapshot_onebit(self, save_dir: str, tag: str, save_latest: bool,
                         meta: Dict[str, Any]) -> CheckpointSnapshot:
        """1-bit Adam's checkpoint in the JAX layout: the optimizer files
        hold ``tree_leaves`` of the ``OnebitState`` — the step, then the
        m, v, worker-error and server-error leaves in tree order — with
        the worker error's leading [dp] axis split over the files (file
        r holds rank r's ``[1, *shape]`` leaves) and the rest whole in
        file 0. Every rank's worker error is gathered to rank 0 here
        (collective), which writes alone."""
        st = self.state
        opt = st.opt_state
        dp = self.dp
        scalars = torch.stack([
            opt.step.to(torch.int32), st.step.to(torch.int32),
            st.loss_scale.to(torch.float32).view(torch.int32),
            st.growth_count.to(torch.int32), st.hysteresis.to(torch.int32),
            st.skipped_steps.to(torch.int32)])
        G = len(self._groups)
        werr = [comm.gather(b) for b in opt.worker_error] if dp > 1 \
            else [[b] for b in opt.worker_error]
        is_writer = self.dp_rank == 0
        if not is_writer:
            self.skipped_steps = int(st.skipped_steps)
            return CheckpointSnapshot(
                save_dir=save_dir, tag=tag, save_latest=save_latest,
                meta=meta, blobs=[], is_writer=False,
                fsync=self._ckpt_fsync)
        whole = [g.param for g in self._groups] + list(opt.m) + \
            list(opt.v) + list(opt.server_error)
        host = _host_copies(whole + [t for per in werr for t in per] +
                            [scalars])
        sc = host[-1].numpy()
        count, step_v, growth_v, hyst_v, skipped_v = (
            np.array(sc[i]) for i in (0, 1, 3, 4, 5))
        self.skipped_steps = int(skipped_v)
        meta["skipped_steps"] = self.skipped_steps
        scalars_blob = {"step": step_v,
                        "loss_scale": np.array(sc[2:3].view(np.float32)[0]),
                        "growth_count": growth_v, "hysteresis": hyst_v,
                        "skipped": skipped_v}
        params = tree_unflatten(self._treedef,
                                self._group_bufs_to_leaves(host[:G]))
        m, v, serr = (self._group_bufs_to_leaves(host[k * G:(k + 1) * G])
                      for k in (1, 2, 3))
        rows = host[4 * G:-1]
        # (rank r's worker-error leaves, as [1, *shape])
        werr_by_rank = [[t.unsqueeze(0) for t in self._group_bufs_to_leaves(
            [rows[gi * dp + r] for gi in range(G)])] for r in range(dp)]
        L = len(self._leaf_shapes)
        meta["optim_shards"] = dp
        meta["optim_shard_axes"] = [None] * (1 + 2 * L) + [0] * L + \
            [None] * L

        def model_blob() -> bytes:
            return msgpack_serialize({"module": params})

        def optim_blob(r: int) -> bytes:
            blob: Dict[str, Any] = {}
            for j, t in enumerate(werr_by_rank[r]):
                blob[str(1 + 2 * L + j)] = t
            if r == 0:
                blob["0"] = np.asarray(count, np.int32)
                for k, leaves in ((1, m), (1 + L, v), (1 + 3 * L, serr)):
                    for j, t in enumerate(leaves):
                        blob[str(k + j)] = t
                blob["__scalars__"] = scalars_blob
            return msgpack_serialize(blob)

        blobs: List[Any] = [(MODEL_FILE, model_blob)]
        blobs += [(OPTIM_SHARD_FMT.format(r), lambda r=r: optim_blob(r))
                  for r in range(dp)]
        return CheckpointSnapshot(
            save_dir=save_dir, tag=tag, save_latest=save_latest, meta=meta,
            blobs=blobs, is_writer=True, fsync=self._ckpt_fsync)

    def _onebit_state(self, path: str, meta: Dict[str, Any],
                      blobs: List[Any]) -> OnebitState:
        """1-bit Adam's state from the joined optimizer files: this
        rank's row of the joined worker error when the save's dp is this
        engine's; under another dp the current (fresh) worker error is
        kept with a warning, as the JAX engine keeps a leaf whose saved
        shape differs."""
        L = len(self._leaf_shapes)
        leaves = self._assemble_shards(blobs, meta["optim_shard_axes"],
                                       1 + 4 * L)
        paths = _leaf_paths(self.state.params)
        for k, name in enumerate(("m", "v")):
            for j, (x, shape) in enumerate(zip(
                    leaves[1 + k * L:1 + (k + 1) * L], self._leaf_shapes)):
                if tuple(np.shape(x)) != tuple(shape):
                    raise ValueError(
                        f"checkpoint {path}: the saved {name} leaf "
                        f"{paths[j]} is {tuple(np.shape(x))}, this model's "
                        f"{tuple(shape)} — the model changed since the save")
        werr_saved = leaves[1 + 2 * L:1 + 3 * L]
        werr_leaves: List[Any] = []
        cur = self._group_bufs_to_leaves(list(
            self.state.opt_state.worker_error))
        for j, (x, shape) in enumerate(zip(werr_saved, self._leaf_shapes)):
            if tuple(np.shape(x)) == (self.dp,) + tuple(shape):
                werr_leaves.append(np.asarray(x)[self.dp_rank])
            else:
                logger.warning(
                    f"checkpoint leaf {1 + 2 * L + j}: saved shape "
                    f"{tuple(np.shape(x))} != current "
                    f"{(self.dp,) + tuple(shape)}; keeping current value")
                werr_leaves.append(cur[j].detach().cpu())
        return OnebitState(
            step=np.int32(np.asarray(leaves[0])),
            m=self._leaves_to_group_bufs(leaves[1:1 + L]),
            v=self._leaves_to_group_bufs(leaves[1 + L:1 + 2 * L]),
            worker_error=self._leaves_to_group_bufs(werr_leaves),
            server_error=self._leaves_to_group_bufs(leaves[1 + 3 * L:]))

    def _optax_leaf_count(self) -> int:
        layout = self.optimizer.jax_layout()
        return sum(1 if e == COUNT else len(self._leaf_shapes)
                   for e in layout)

    def _optax_state(self, path: str, leaves: List[Any]) -> FlatState:
        """An optax chain's state from the JAX file's leaf list: the
        count (the last count entry, the schedule's), and each buffer's
        per-parameter leaves packed into this engine's groups (this
        rank's rows of the V-layout at shard-local ZeRO)."""
        it = iter(leaves)
        count, per_name = None, {}
        for entry in self.optimizer.jax_layout():
            if entry == COUNT:
                count = np.int32(np.asarray(next(it)))
                continue
            got = [_as_tensor(next(it)) for _ in self._leaf_shapes]
            for p, x, shape in zip(_leaf_paths(self.state.params), got,
                                   self._leaf_shapes):
                if tuple(x.shape) != tuple(shape):
                    raise ValueError(
                        f"checkpoint {path}: the saved {entry} leaf {p} is "
                        f"{tuple(x.shape)}, this model's {tuple(shape)} — "
                        "the model changed since the save")
            per_name[entry] = got
        bufs = {}
        for name, got in per_name.items():
            per_group = []
            for gi, idxs in enumerate(self._group_leaves):
                dst = torch.zeros(self._opt_groups[gi].numel,
                                  dtype=torch.float32)
                lv = [got[i].to(torch.float32) for i in idxs]
                if self._shard_local:
                    self._shards[gi].pack(lv, dst)
                else:
                    for view, x in zip(self._groups[gi].views(dst), lv):
                        view.copy_(x)
                per_group.append(dst)
            bufs[name] = tuple(per_group)
        return FlatState(count=count, bufs=bufs)

    # ------------------------------------------------------------------ #
    # ZeRO-Offload checkpoints (the JAX engine's offload layout)
    # ------------------------------------------------------------------ #
    def _offload_full(self, leaves: List[torch.Tensor]
                      ) -> Optional[List[torch.Tensor]]:
        """Whole host copies of local leaves: at dp > 1 every rank's
        partition gathered to rank 0 along the leaf's axis (collective;
        None on the other ranks)."""
        if self.dp == 1:
            return [t.clone() for t in leaves]
        out = []
        for t, ax in zip(leaves, self._offload._axes):
            if ax is None:
                out.append(t.clone())
                continue
            parts = comm.gather(t.to(self.device).movedim(ax, 0)
                                .contiguous())
            if parts is not None:
                out.append(torch.cat(parts).movedim(0, ax).to("cpu")
                           .contiguous())
        return out if self.dp_rank == 0 else None

    def _snapshot_offload(self, save_dir: str, tag: str, save_latest: bool,
                          meta: Dict[str, Any]) -> CheckpointSnapshot:
        """The JAX offload layout: the fp32 masters as the module file's
        ``{"module": tree}`` and ``{"offload": ZeroOffloadOptimizer
        .state_dict()}`` as the optimizer file (lists as ``"0"``, ``"1"``,
        ... maps, as flax writes them), whole leaves (what JAX's one
        process writes and reads). Copies, so the writer serializes this
        instant's values."""
        off = self._offload
        masters = self._offload_full(off.masters)
        m = self._offload_full(off.opt.exp_avg)
        v = self._offload_full(off.opt.exp_avg_sq)
        self.skipped_steps = off.skipped_steps
        meta["skipped_steps"] = self.skipped_steps
        if self.dp_rank != 0:
            return CheckpointSnapshot(
                save_dir=save_dir, tag=tag, save_latest=save_latest,
                meta=meta, blobs=[], is_writer=False, fsync=self._ckpt_fsync)

        def indexed(xs):
            return {str(i): x for i, x in enumerate(xs)}
        state = {"optimizer": {"step": off.opt.step_count,
                               "exp_avg": indexed(m),
                               "exp_avg_sq": indexed(v)},
                 "masters": indexed(masters),
                 "loss_scale": off.loss_scale,
                 "growth_count": off.growth_count,
                 "hysteresis": off.hysteresis,
                 "step_count": off.step_count,
                 "skipped_steps": off.skipped_steps}
        module = tree_unflatten(self._treedef, masters)
        blobs = [(MODEL_FILE, lambda: msgpack_serialize({"module": module})),
                 (OPTIM_FILE_FMT,
                  lambda: msgpack_serialize({"offload": state}))]
        return CheckpointSnapshot(
            save_dir=save_dir, tag=tag, save_latest=save_latest, meta=meta,
            blobs=blobs, is_writer=True, fsync=self._ckpt_fsync)

    def _offload_state(self, path: str, blob: Any) -> Dict[str, Any]:
        """A decoded optimizer file → the ``ZeroOffloadOptimizer
        .load_state_dict`` form, checked against this model's leaves."""
        if not (isinstance(blob, dict) and "offload" in blob):
            raise ValueError(
                f"checkpoint {path} has no ZeRO-Offload optimizer state "
                "(it was saved without zero_optimization.cpu_offload); "
                "load it with load_optimizer_states=False")
        st = blob["offload"]
        n = len(self._leaf_shapes)

        def leaves(d, what):
            got = [d.get(str(i)) for i in range(n)] \
                if isinstance(d, dict) and len(d) == n else None
            if got is None or any(
                    x is None or tuple(x.shape) != s
                    for x, s in zip(got, self._leaf_shapes)):
                raise ValueError(
                    f"checkpoint {path}: the offload {what} do not fit "
                    "this model's leaves — the model changed since the "
                    "save")
            return got
        o = st["optimizer"]
        return {"optimizer": {"step": int(o["step"]),
                              "exp_avg": leaves(o["exp_avg"], "moments"),
                              "exp_avg_sq": leaves(o["exp_avg_sq"],
                                                   "moments")},
                "masters": leaves(st["masters"], "masters"),
                **{k: st[k] for k in ("loss_scale", "growth_count",
                                      "hysteresis", "step_count",
                                      "skipped_steps") if k in st}}

    def _load_offload(self, path: str, meta: Dict[str, Any], strict: bool,
                      load_optimizer_states: bool,
                      load_lr_scheduler_states: bool
                      ) -> Tuple[Optional[str], Dict[str, Any]]:
        """Load an offload checkpoint (the port's or the JAX engine's):
        the masters from the module file through ``set_masters`` (so the
        staging copy is re-derived, also without the optimizer state),
        the host optimizer state, the counters and the lr schedule; then
        the device params from the staging copy."""
        model_file = os.path.join(path, MODEL_FILE)
        if not os.path.isfile(model_file):
            logger.warning(f"checkpoint {model_file} not found")
            return None, {}
        with open(model_file, "rb") as f:
            probe = msgpack_restore(f.read())
        if not (isinstance(probe, dict) and "module" in probe):
            raise ValueError(
                f"{model_file} is a SHARDED (mp_rank) model checkpoint but "
                "engine_meta.json does not say so — restore the sidecar")
        new_leaves = self._checkpoint_param_leaves(probe["module"], strict)
        state = None
        optim_file = os.path.join(path, OPTIM_FILE_FMT)
        if load_optimizer_states and os.path.isfile(optim_file):
            with open(optim_file, "rb") as f:
                state = self._offload_state(path, msgpack_restore(f.read()))

        # Every file read and checked: now the state changes.
        off = self._offload
        if self.device.type == "cuda":
            # (no upload still reads the staging copy)
            torch.cuda.synchronize(self.device)
        off.set_masters([m if x is None else x
                         for m, x in zip(off.masters, new_leaves)])
        if state is not None:
            off.load_state_dict(state)
        self.global_steps = int(meta.get("global_steps", 0))
        self.global_samples = int(meta.get("global_samples", 0))
        self.skipped_steps = off.skipped_steps if state is not None \
            else int(meta.get("skipped_steps", 0))
        self.micro_steps = self.global_steps * \
            self.gradient_accumulation_steps()
        if load_lr_scheduler_states and self.lr_scheduler is not None and \
                "lr_scheduler" in meta and \
                hasattr(self.lr_scheduler, "load_state_dict"):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        self._offload_put_params()
        self.state = self.state.replace(**self._offload_scalars())
        log_dist(f"loaded offload checkpoint {path} at global_step="
                 f"{self.global_steps}", ranks=[0])
        return path, meta.get("client_state", {})

    def _checkpoint_param_leaves(self, saved: Any,
                                 strict: bool) -> List[Any]:
        """The saved module tree as this engine's leaves in tree order.
        Strict: the paths and shapes must match exactly. Not strict: a
        leaf whose path is missing or whose shape differs is None (the
        current value stays)."""
        cur_paths = _leaf_paths(self.state.params)
        saved_by_path = dict(zip(_leaf_paths(saved),
                                 tree_flatten(saved)[0]))
        out: List[Any] = []
        problems = []
        for p, shape in zip(cur_paths, self._leaf_shapes):
            val = saved_by_path.get(p)
            if val is None:
                problems.append(f"{p}: missing")
            elif tuple(val.shape) != tuple(shape):
                problems.append(f"{p}: saved {tuple(val.shape)} != "
                                f"current {tuple(shape)}")
                val = None
            out.append(val)
        extra = sorted(set(saved_by_path) - set(cur_paths))
        problems += [f"{p}: not in this model" for p in extra]
        if problems:
            msg = "checkpoint module tree differs: " + "; ".join(problems)
            if strict:
                raise ValueError(msg + " (load_module_strict=False keeps "
                                 "the current value of those leaves)")
            logger.warning(msg + " — keeping the current values")
        return out

    @staticmethod
    def _read_shard_blobs(path: str, fmt: str, n: int):
        """Decode all ``n`` shard files once; None if any is missing."""
        blobs = []
        for r in range(n):
            fp = os.path.join(path, fmt.format(r))
            if not os.path.isfile(fp):
                logger.warning(f"checkpoint shard {fp} not found")
                return None
            with open(fp, "rb") as f:
                blobs.append(msgpack_restore(f.read()))
        return blobs

    @staticmethod
    def _assemble_shards(blobs, axes, n_leaves: int) -> List[Any]:
        """Join each leaf's shards along its recorded axis (a replicated
        leaf comes from shard 0), as the JAX ``_assemble_shards``."""
        if len(axes) != n_leaves:
            raise ValueError(
                f"checkpoint shard layout has {len(axes)} optimizer leaves "
                f"but this engine has {n_leaves} — the optimizer/model "
                "structure changed since this checkpoint was saved")
        out = []
        for i, ax in enumerate(axes):
            if ax is None:
                out.append(blobs[0][str(i)])
            else:
                out.append(np.concatenate([b[str(i)] for b in blobs],
                                          axis=int(ax)))
        return out

    def _checkpoint_tag_validation(self, tag: str) -> None:
        """The JAX engine's cross-host tag vote: not ported (every rank
        passes the same tag, or none, to ``save_checkpoint``)."""


__all__ = ["DeepSpeedEngine", "EngineState"]
