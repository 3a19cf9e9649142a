"""The training engine on one card (port of
``deepspeed_tpu/runtime/engine.py::DeepSpeedEngine``, its main path).

``train_batch`` runs one iteration: for each of the gas micro-batches
the loss (scaled by the fp16 loss scale and divided by gas), its
gradients by autograd, and their sum into the fp32 flat gradient
buffers; then the fused one-pass optimizer step
(``ops/fused_update.FusedAdam.step``: grad norm, fp16 overflow vote,
clip coefficient, Adam, overflow skip and the cast-copy refresh); then
the overflow bookkeeping and the dynamic loss scale. Every quantity of
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

What the port does not run yet raises ``NotImplementedError`` at
construction, naming the ROADMAP slice that brings it: more than one
card, ZeRO stage 3, ZeRO-Offload, the pipeline and the other parallel
axes, OnebitAdam and sparse gradients, MoE expert parallelism (ep > 1),
remat and progressive layer drop, checkpoint saving and loading, the
``forward/backward/step`` trio, client optimizer objects, optimizers
other than Adam/AdamW, and the unfused paths
(``optimizer.params.fused: false``, and ``fused_kernels=False`` on
CUDA).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .config import DeepSpeedConfig
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .fp16.loss_scaler import LossScaleState, update_loss_scale
from .lr_schedules import get_lr_schedule
from .. import constants as C
from ..models.transformer import check_trainable
from ..ops.grouped_gemm import check_grouped_gemm
from ..ops.fused_update import (FlatGroup, FusedAdamState, float_groups,
                                tree_flatten, tree_unflatten)
from ..ops.optimizers import build_optimizer
from ..utils.device import resolve_device
from ..utils.logging import log_dist
from ..utils.timer import ThroughputTimer


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


def _make_raw_scaled_loss(loss_fn: Callable, gas: int) -> Callable:
    """``(params, mb, rng, scale) -> (scaled_loss, (raw_loss, aux))``:
    the loss scaled for the fp16 backward and divided by gas, so the
    accumulated gradients average over the micro-batches."""
    def raw_scaled_loss(params, mb, rng, scale):
        out = loss_fn(params, mb, rng)
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
    """Config-driven training engine on one card."""

    def __init__(self, args=None, model=None, optimizer=None,
                 model_params=None, training_data=None, lr_scheduler=None,
                 mpu=None, dist_init_required=None, collate_fn=None,
                 config: Union[str, Dict[str, Any], DeepSpeedConfig,
                               None] = None,
                 rng: Union[int, torch.Generator, None] = None,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if mpu is not None:
            world = max(world, int(mpu.get_data_parallel_world_size()))
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized():
            world = max(world, torch.distributed.get_world_size())
        if world > 1:
            raise _unported(f"a world size of {world} (more than one card)",
                            "slice 6: dp and ZeRO-1/2/3")
        if config is None:
            raise ValueError("DeepSpeed requires a config")
        self.config = config if isinstance(config, DeepSpeedConfig) \
            else DeepSpeedConfig(config, world_size=1)
        for feature, where in self.config.unported_features():
            raise _unported(feature, where)
        # The `moe` block promises the moe_* metrics. The model is built
        # apart (TransformerConfig.moe); a block with no MoE stats from
        # the loss_fn behind it raises at the first step.
        self._moe_metrics = self.config.moe_config.num_experts > 0
        if optimizer is not None:
            raise _unported("a client optimizer object (the port builds its "
                            "fused Adam from the ds_config)",
                            "slice 6: the other optimizers")

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
        self.optimizer = build_optimizer(
            self.config.optimizer_name or C.ADAM_OPTIMIZER, opt_params,
            schedule_fn)

        # Flat parameter groups; leaves in tree order view into them.
        leaves, self._treedef = tree_flatten(init_params)
        masters = []
        for leaf in leaves:
            t = torch.as_tensor(leaf)
            if not t.is_floating_point():
                raise TypeError("the port's engine trains floating-point "
                                f"parameter trees, got a {t.dtype} leaf")
            masters.append(t.detach().to(self.device, master_dtype))
        cast_dtype = self.compute_dtype if self._use_cast_cache else None
        self._groups: List[FlatGroup] = []
        n = len(leaves)
        param_views: List[Any] = [None] * n
        grad_views: List[Any] = [None] * n
        cast_views: List[Any] = [None] * n
        for dt, idxs in float_groups(masters):
            grp = FlatGroup([masters[i] for i in idxs], dt, self.device,
                            cast_dtype)
            self._groups.append(grp)
            for i, pv, gv in zip(idxs, grp.views(grp.param),
                                 grp.views(grp.grad)):
                param_views[i], grad_views[i] = pv, gv
            if grp.cast is not None:
                for i, cv in zip(idxs, grp.views(grp.cast)):
                    cast_views[i] = cv
        del masters
        self._grad_views = grad_views
        self._loss_leaves = [
            (cv if cv is not None else pv).requires_grad_(True)
            for pv, cv in zip(param_views, cast_views)]

        sc = self._loss_scaler_config()
        self._scaler_kw = dict(
            fp16=self.config.fp16_enabled, static_scale=sc["static"],
            scale_window=sc["scale_window"], min_scale=sc["min_scale"],
            hysteresis_init=sc["hysteresis"])
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self.state = EngineState(
            step=torch.zeros((), **i32),
            params=tree_unflatten(self._treedef, param_views),
            opt_state=self.optimizer.init(self._groups),
            loss_scale=torch.tensor(sc["init_scale"], dtype=torch.float32,
                                    device=dev),
            growth_count=torch.zeros((), **i32),
            hysteresis=torch.tensor(sc["hysteresis"], **i32),
            skipped_steps=torch.zeros((), **i32),
            cast_params=tree_unflatten(self._treedef, cast_views)
            if self._use_cast_cache else None)

        # Host-side counters.
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0

        if isinstance(rng, torch.Generator):
            self.generator = rng
        else:
            self.generator = torch.Generator(device=dev).manual_seed(
                42 if rng is None else int(rng))

        self.collate_fn = collate_fn
        self.training_dataloader = self.deepspeed_io(training_data) \
            if training_data is not None else None
        self._data_iterator = None

        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu(),
            start_step=2, steps_per_output=self.steps_per_print(),
            synchronized=self.wall_clock_breakdown())
        self.last_metrics: Optional[Dict[str, torch.Tensor]] = None
        log_dist(f"DeepSpeedEngine initialized: device={dev}, "
                 f"dtype={self.config.precision_dtype}, "
                 f"zero_stage={self.zero_optimization_stage()}", ranks=[0])

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
            collate_fn=self.collate_fn)

    # ------------------------------------------------------------------ #
    # State import
    # ------------------------------------------------------------------ #
    def set_train_state(self, params: Any, opt_state: FusedAdamState,
                        step: int = 0, loss_scale: Optional[float] = None,
                        growth_count: int = 0,
                        hysteresis: Optional[int] = None,
                        skipped_steps: int = 0) -> None:
        """Replace the training state in place: ``params`` a tree like
        the initial one (tensors or numpy), ``opt_state`` moments in this
        engine's flat-group layout (``models/convert.py`` carries a JAX
        ``FusedAdamState`` there). The compute-dtype copy is re-derived
        from the new parameters."""
        leaves, _ = tree_flatten(params)
        dev = self.device

        def tensor(x):
            return x if isinstance(x, torch.Tensor) else \
                torch.from_numpy(np.array(x, copy=True))
        with torch.no_grad():
            for pv, new in zip(tree_flatten(self.state.params)[0], leaves):
                pv.copy_(tensor(new).to(dev, pv.dtype))
            for gi, grp in enumerate(self._groups):
                if grp.cast is not None:
                    grp.cast.copy_(grp.param)
                self.state.opt_state.m[gi].copy_(tensor(opt_state.m[gi]))
                self.state.opt_state.v[gi].copy_(tensor(opt_state.v[gi]))
            sc = self._scaler_kw
            i32 = dict(dtype=torch.int32, device=dev)
            self.state = self.state.replace(
                step=torch.tensor(int(step), **i32),
                opt_state=self.state.opt_state._replace(
                    count=torch.tensor(int(opt_state.count), **i32)),
                loss_scale=self.state.loss_scale if loss_scale is None
                else torch.tensor(float(loss_scale), dtype=torch.float32,
                                  device=dev),
                growth_count=torch.tensor(int(growth_count), **i32),
                hysteresis=torch.tensor(
                    sc["hysteresis_init"] if hysteresis is None
                    else int(hysteresis), **i32),
                skipped_steps=torch.tensor(int(skipped_steps), **i32))
        self.global_steps = int(step) + int(skipped_steps)

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
            micro = [next(it) for _ in range(
                self.gradient_accumulation_steps())]
            leaves = [tree_flatten(m)[0] for m in micro]
            spec = tree_flatten(micro[0])[1]
            batch = tree_unflatten(spec, [
                np.concatenate([np.asarray(x) for x in xs], axis=0)
                for xs in zip(*leaves)])
        micro_batches = self._split_micro_batches(self._to_device(batch))
        self.tput_timer.start()
        metrics = self._train_step(micro_batches)
        self.global_steps += 1
        self.micro_steps += self.gradient_accumulation_steps()
        self.global_samples += self.train_batch_size()
        if self.lr_scheduler is not None and \
                hasattr(self.lr_scheduler, "last_batch_iteration"):
            self.lr_scheduler.last_batch_iteration = self.global_steps - 1
        self.tput_timer.stop()
        self.last_metrics = metrics
        self._maybe_log(metrics)
        return metrics["loss"]

    def _train_step(self, micro_batches: List[Any]
                    ) -> Dict[str, torch.Tensor]:
        st = self.state
        gas = len(micro_batches)
        scale = st.loss_scale
        leaves = self._loss_leaves
        params = tree_unflatten(self._treedef, leaves)
        scaled_loss = _make_raw_scaled_loss(self.loss_fn, gas)
        mean_loss = None
        moe_sum: Dict[str, torch.Tensor] = {}
        for i, mb in enumerate(micro_batches):
            scaled, (raw, aux) = scaled_loss(params, mb, self.generator,
                                             scale)
            if self._moe_metrics:
                if not (isinstance(aux, dict) and "moe" in aux):
                    raise ValueError(
                        "ds_config has a `moe` block but the model's "
                        "loss_fn returned no moe stats — build the model "
                        "with TransformerConfig.moe (deepspeed_tpu_torch."
                        "moe.MoEConfig) or drop the block")
                for name, v in aux["moe"].items():
                    v = v.detach().float()
                    moe_sum[name] = v if i == 0 else moe_sum[name] + v
            grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
            with torch.no_grad():
                # fp32 accumulation: each micro-batch's grads (in the
                # compute dtype) are added into the fp32 flat buffers.
                for gv, g in zip(self._grad_views, grads):
                    if g is None:
                        if i == 0:
                            gv.zero_()
                    elif i == 0:
                        gv.copy_(g)
                    else:
                        gv.add_(g)
            raw = raw.detach().float()
            if gas == 1:
                mean_loss = raw
            else:
                mean_loss = (torch.zeros_like(raw) if i == 0 else
                             mean_loss) + raw / gas
        fp16 = self.config.fp16_enabled
        clip = self.gradient_clipping()
        with torch.no_grad():
            sr_seed = torch.randint(
                -2 ** 31, 2 ** 31 - 1, (), generator=self.generator,
                device=self.device, dtype=torch.int32) \
                if self._master_free else None
            opt_state, grad_norm, overflow = self.optimizer.step(
                self._groups, st.opt_state, clip=clip,
                inv_scale=(1.0 / scale) if fp16 else None, fp16=fp16,
                compute_norm=bool(clip and clip > 0) or fp16,
                sr_seed=sr_seed)
            lr = self.optimizer.lr_at(st.step)
            self.state = st.replace(
                opt_state=opt_state,
                **_overflow_resolution(st, overflow, **self._scaler_kw))
        metrics = {"loss": mean_loss, "grad_norm": grad_norm, "lr": lr,
                   "loss_scale": scale, "overflow": overflow,
                   "skipped_steps": self.state.skipped_steps}
        if moe_sum:
            # The mean over the micro-batches, as the JAX engine's.
            for name in ("expert_tokens", "drop_fraction", "aux_loss",
                         "z_loss"):
                metrics[f"moe_{name}"] = moe_sum[name] / gas
        return metrics

    def _maybe_log(self, metrics: Dict[str, torch.Tensor]) -> None:
        spp = self.steps_per_print()
        if spp and self.global_steps % spp == 0:
            log_dist(f"step={self.global_steps} "
                     f"loss={float(metrics['loss']):.4f} "
                     f"grad_norm={float(metrics['grad_norm']):.4f} "
                     f"lr={float(metrics['lr']):.3e} "
                     f"loss_scale={float(metrics['loss_scale'])} "
                     f"skipped={int(metrics['skipped_steps'])}", ranks=[0])

    # ------------------------------------------------------------------ #
    # Not ported yet
    # ------------------------------------------------------------------ #
    def forward(self, *args, **kwargs):
        raise _unported("the forward/backward/step API",
                        "slice 6: the engine's forward/backward/step trio")

    backward = step = forward

    def save_checkpoint(self, *args, **kwargs):
        raise _unported("checkpoint save/load", "slice 6: checkpointing")

    load_checkpoint = save_checkpoint


__all__ = ["DeepSpeedEngine", "EngineState"]
