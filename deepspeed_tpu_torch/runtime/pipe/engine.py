"""The pipeline-parallel engine (port of
``deepspeed_tpu/runtime/pipe/engine.py``).

Two model forms, as in the JAX package:

- a ``PipeSpec`` (``models/gpt2_pipe.py``, ``hetero.hetero_pipe_spec``,
  ``PipelineModule.to_pipe_spec``): uniform stages over a
  ``{shared, blocks}`` tree, pipelined over ``pp`` stage processes;
- a ``PipelineModule`` (a layer list): composed into one loss and
  trained as the one-stage engine (pp 1), its checkpoint one file a
  layer (``layer_{:02d}-model_states.msgpack``, tied parameters written
  once, by their first owner). At pp > 1 it raises, as in JAX.

The JAX package compiles the whole schedule into one SPMD program. The
port runs one process a rank, as the reference does: the ranks form a
``pipe`` × ``data`` topology (``parallel/topology.PipelineParallelGrid``:
rank = stage * dp + d), each process holds its stage's slice of the
blocks (and ``shared`` on the first and the last stage) and is a
``DeepSpeedEngine`` over that slice whose data-parallel group
(``_dp_group``, which every collective of the engine names) is its
stage's dp ranks: ZeRO 0-2, the fused optimizer (K5, K6) and its
collectives run per stage unchanged.
A step (``train_batch``) consumes all M = gas micro-batches:

- ``gpipe``: every micro-batch's forward, then every backward. A stage
  keeps its M boundary inputs (the O(M) profile JAX's docstring gives);
- ``1f1b``: ``TrainSchedule``'s program (``schedule.py``), interpreted
  instruction by instruction; at most ``num_pipe_buffers()`` stage
  inputs are live on a stage (``pipe_stats["max_live_buffers"]``),
  whatever M is. ``pipe_stats["record_bytes"]``: the card memory one
  micro-batch's record holds from its forward to its backward.

Under ``pipeline.activation_checkpoint_interval`` >= 1 (and when the key
is absent) the stage forward is a ``models/remat.Recompute`` region
holding only its input: the backward re-runs the stage. An explicit 0
keeps the stage's graph. Activations go to the next stage and grads to
the previous one point to point (``comm.isend``/``comm.recv``; sends
never block, so the schedule's order cannot deadlock; over gloo a card's
tensor is staged through host memory). The last stage's loss is the
mean over the micro-batches of its head's, divided by M into the
backward and scaled by the fp16 loss scale, as the one-stage engine's.

Then the step closes as the one-stage engine's (``_apply_window``), with
what crosses stages added: the tied leaves' grads (``shared``, which
both ends hold) summed over each column's first and last stage (the
reference's ``ReduceTiedGrads``: the embedding path's plus the head's,
so the two copies stay bit-equal), the loss sent from the last stage to
every stage, and the grad norm's square summed over the stages with the
tied leaves counted once (the first stage's), so the clip coefficient
and the fp16 overflow vote are global.

Checkpoints of a ``PipeSpec`` engine are the JAX pipeline engine's
files: the model file holds the whole ``{shared, blocks}`` tree and the
optimizer file the optax state of the whole tree (the JAX pipeline runs
the optax chain), in one file of whole leaves, gathered to global rank 0,
which writes and commits alone. Each framework resumes the other's.

Not ported: the pipeline at ZeRO stage 3 or under ZeRO-Offload (JAX
refuses both with ``1f1b``; GPipe there is left to ROADMAP queue 1
item 7), bf16 stochastic rounding (its noise index is an element's place
in the whole tree's layout), 1-bit Adam, sparse gradients, the
preemption save, and the forward/backward/step trio (the reference's
pipeline engine runs ``train_batch`` only).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..async_ckpt import (CheckpointSnapshot, LATEST_FILE, META_FILE,
                          is_complete)
from ..config import (DeepSpeedConfig, PipelineConfig, pipe_parallel_size)
from ..config_utils import load_config_json
from ..engine import (DeepSpeedEngine, MODEL_FILE, OPTIM_SHARD_FMT,
                      _EVAL_FOLD, _Window, fold_in)
from ..flax_msgpack import msgpack_restore, msgpack_serialize
from ... import constants as C
from ...models.gpt2_pipe import PipeSpec
from ...models.remat import GeneratorReplay, Op, Recompute
from ...ops.fused_update import float_groups, tree_flatten, tree_unflatten
from ...ops.optimizers import COUNT, AdamChain, FusedAdam, state_buffers
from ...parallel import comm
from ...parallel.topology import (PipeDataParallelTopology,
                                  PipelineParallelGrid)
from ...utils.logging import log_dist, logger
from .module import PipelineModule
from .schedule import (BackwardPass, ForwardPass, InferenceSchedule,
                       LoadMicroBatch, OptimizerStep, RecvActivation,
                       RecvGrad, ReduceGrads, ReduceTiedGrads,
                       SendActivation, SendGrad, TrainSchedule, interpret)

# The dtypes an activation header names.
_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32]
_HEADER = 8
SCHEDULES = ("gpipe", "1f1b")


def _param_dict(config: Any) -> Dict[str, Any]:
    if isinstance(config, str):
        return load_config_json(config)
    if isinstance(config, DeepSpeedConfig):
        return config._param_dict
    return config if isinstance(config, dict) else {}


def _split_batch(mb: Any) -> Tuple[Any, Any]:
    """A micro-batch's inputs and targets (JAX ``_split_batch``): a pair,
    or one token array ``[B, S+1]`` with the next-token objective."""
    if isinstance(mb, (tuple, list)):
        return mb[0], mb[1]
    return mb[:, :-1], mb[:, 1:]


def _stage_loss(spec: PipeSpec):
    """The whole pipeline's loss on one process: the stage engine's
    ``loss_fn`` (the pipeline drives the stages itself; a closure over
    the spec, not a bound method, so a deleted engine is freed at once
    rather than at the next garbage collection)."""
    def loss_fn(params, batch, rng=None):
        tokens, targets = _split_batch(batch)
        x = spec.embed_fn(params["shared"], tokens, rng)
        x = spec.stage_fn(params["blocks"], x, rng, 0)
        return spec.head_fn(params["shared"], x, targets, rng)
    return loss_fn


class _PipeRecord:
    """One micro-batch on a stage between its forward and its backward:
    the stage input (None on the first stage), the output to
    differentiate (the scaled loss on the last stage), and the grad to
    send back."""
    __slots__ = ("micro", "x", "out", "dx")

    def __init__(self, micro: int, x, out):
        self.micro, self.x, self.out, self.dx = micro, x, out, None


class PipelineEngine(DeepSpeedEngine):
    """Engine for pipelined models (module docstring)."""

    LAYER_FILE_FMT = "layer_{:02d}-model_states.msgpack"

    def __init__(self, args=None, model=None, optimizer=None,
                 model_params=None, training_data=None, lr_scheduler=None,
                 mpu=None, dist_init_required=None, collate_fn=None,
                 config=None, rng=None, device=None):
        if config is None:
            raise ValueError("DeepSpeed requires a config")
        pd = _param_dict(config)
        pcfg = PipelineConfig(pd)
        sched = str(pcfg.schedule).lower()
        pp = pipe_parallel_size(pd)
        self.pipeline_module: Optional[PipelineModule] = None
        self._pipe_spec: Optional[PipeSpec] = None
        self.num_stages, self.stage_id = 1, 0
        self.grid: Optional[PipelineParallelGrid] = None
        self._n_block_leaves = 0
        self.pipe_stats: Dict[str, int] = {}
        if isinstance(model, PipelineModule):
            if sched == "1f1b":
                raise NotImplementedError(
                    "pipeline.schedule='1f1b' requires a PipeSpec model "
                    "(models/gpt2_pipe.py); PipelineModule layer lists run "
                    "composed (pp=1) and have no interleaved schedule")
            if pp > 1:
                raise NotImplementedError(
                    "pp>1 needs an SPMD-expressible model: express uniform "
                    "stages as a PipeSpec (models/gpt2_pipe.py), or stages "
                    "with DIFFERENT programs (e.g. conv stem + transformer "
                    "body) via hetero_pipe_spec (runtime/pipe/hetero.py)")
            self.pipeline_module = model
            if model_params is None:
                model_params = model.init_params()
            # (a topology, as JAX passes the module's, is no mpu here)
            super().__init__(args=args, model=model.loss, optimizer=optimizer,
                             model_params=model_params,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler,
                             mpu=mpu if hasattr(
                                 mpu, "get_data_parallel_world_size")
                             else None,
                             dist_init_required=dist_init_required,
                             collate_fn=collate_fn, config=config, rng=rng,
                             device=device)
            log_dist(model.describe(), ranks=[0])
            return
        if not isinstance(model, PipeSpec):
            raise TypeError(f"PipelineEngine takes a PipeSpec or a "
                            f"PipelineModule, got {type(model).__name__}")
        if sched not in SCHEDULES:
            raise ValueError(f"pipeline.schedule must be 'gpipe' or "
                             f"'1f1b', got '{sched}'")
        world = comm.global_world_size()
        if world % pp:
            raise ValueError(f"{world} ranks do not split into {pp} "
                             "pipeline stages")
        dp = world // pp
        model.check_stages(pp)
        self._pipe_spec = model
        self._schedule = sched
        self.num_stages = pp
        ds = DeepSpeedConfig(pd, world_size=dp)
        self._refuse(ds, sched, optimizer)
        interval = pcfg.activation_checkpoint_interval
        # (the key absent: remat on, the JAX engine's default)
        self._remat = interval is None or int(interval) != 0
        if pp > 1 or comm.is_initialized():
            grid = mpu if isinstance(mpu, PipelineParallelGrid) else \
                PipelineParallelGrid(PipeDataParallelTopology(pp, dp))
            self.grid = grid
            self.stage_id = grid.stage_id
            self._dp_group = grid.dp_group
        self.is_first_stage = self.stage_id == 0
        self.is_last_stage = self.stage_id == pp - 1
        stage_tree = model.stage_params(self.stage_id, pp)
        self._n_block_leaves = len(tree_flatten(stage_tree["blocks"])[0])
        self._num_micro = int(ds.gradient_accumulation_steps)
        super().__init__(args=args, model=_stage_loss(model),
                         optimizer=optimizer, model_params=stage_tree,
                         training_data=training_data,
                         lr_scheduler=lr_scheduler, mpu=None,
                         dist_init_required=dist_init_required,
                         collate_fn=collate_fn, config=ds, rng=rng,
                         device=device)
        self._shared_groups = [
            all(i >= self._n_block_leaves for i in idxs)
            for idxs in self._group_leaves]
        # The tied leaves count in the norm on the first stage only (and
        # a replicated group on dp rank 0 only: the base's mask).
        base = self._norm_mask or [True] * len(self._shared_groups)
        self._norm_mask = [ok and (self.is_first_stage or not shared)
                           for ok, shared in zip(base,
                                                 self._shared_groups)]
        self.telemetry.meta.update(pipeline={
            "schedule": sched, "stages": pp,
            "micro_batches": self._num_micro, "layers": model.num_layers,
            "stage": self.stage_id, "remat": self._remat})
        log_dist(f"PipelineEngine: pp={pp} stage processes x dp={dp}, "
                 f"micro_batches={self._num_micro}, "
                 f"layers={model.num_layers}, schedule={sched}, "
                 f"stage remat={self._remat}", ranks=[0])

    @staticmethod
    def _refuse(ds: DeepSpeedConfig, sched: str, optimizer: Any) -> None:
        """The compositions the pipeline does not run (module
        docstring), with JAX's messages where JAX refuses them too."""
        stage = ds.zero_optimization_stage if ds.zero_enabled else 0
        offload = bool(ds.zero_config.cpu_offload) and stage >= 1
        if sched == "1f1b" and offload:
            raise ValueError(
                "pipeline.schedule='1f1b' does not compose with "
                "zero_optimization.cpu_offload: the offload path "
                "computes grads via its own autodiff pass (use the "
                "gpipe schedule)")
        if sched == "1f1b" and stage >= 3:
            raise ValueError(
                "ZeRO stage 3 does not compose with pipeline grads_fn "
                "(1F1B computes grads inside its own primal scan); use "
                "stage <= 2 with the pipeline engine")
        where = "ROADMAP queue 1 item 7, the pipeline's leftovers"
        if stage >= 3 or offload:
            raise NotImplementedError(
                "the gpipe pipeline at ZeRO stage 3 or under zero_"
                f"optimization.cpu_offload is not ported yet ({where})")
        blocked = [
            (ds.bf16_stochastic_rounding, "bf16.stochastic_rounding"),
            (ds.optimizer_name == C.ONEBIT_ADAM_OPTIMIZER or
             type(optimizer).__name__ == "OnebitAdam", "OneBitAdam"),
            (ds.sparse_gradients_enabled, "sparse_gradients"),
            (bool(ds.checkpoint_config.save_dir and
                  ds.checkpoint_config.preempt_save),
             "checkpoint.preempt_save"),
            (ds.moe_config.num_experts > 0, "a moe block"),
        ]
        for on, name in blocked:
            if on:
                raise NotImplementedError(
                    f"{name} does not compose with the pipeline engine yet "
                    f"({where})")

    # ------------------------------------------------------------------ #
    # The stage's groups and what crosses stages
    # ------------------------------------------------------------------ #
    def _leaf_groups(self, masters):
        """A dtype group a part: the stage's blocks, then the tied
        ``shared`` leaves (which the tied reduction and the norm treat
        apart)."""
        if self._pipe_spec is None:
            return super()._leaf_groups(masters)
        out = []
        for dt, idxs in float_groups(masters):
            for part in ([i for i in idxs if i < self._n_block_leaves],
                         [i for i in idxs if i >= self._n_block_leaves]):
                if part:
                    out.append((dt, part))
        return out

    def _cross_stage(self, mean_loss: torch.Tensor) -> torch.Tensor:
        if self.grid is None or self.num_stages == 1:
            return mean_loss
        if len(self.grid.tied_ranks) > 1:
            for gi, shared in enumerate(self._shared_groups):
                if shared:
                    comm.all_reduce(self._opt_groups[gi].grad,
                                    group=self.grid.tied_group)
        out = mean_loss.clone() if self.is_last_stage else \
            torch.zeros_like(mean_loss)
        return comm.all_reduce(out, group=self.grid.pp_group)

    def _cost_model_extras(self, payload):
        """The stage's attribution (JAX ``_cost_model_extras``): JAX splits
        its one SPMD program's walked flops evenly over the stages; here
        each stage process walks its own program, so its section holds
        its own step's flops (the embedding on the first stage, the head
        on the last)."""
        if self._pipe_spec is None:
            return {}
        train = (payload.get("paths") or {}).get("train_step") or {}
        flops = train.get("analytic_flops")
        if not flops:
            return {}
        section = {"stages": self.num_stages, "stage": self.stage_id,
                   "micro_batches": self._num_micro,
                   "layers": self._pipe_spec.num_layers,
                   "schedule": self._schedule, "flops_this_stage":
                   float(flops),
                   "attribution": "the op walk of this stage process's "
                                  "own train step"}
        if train.get("top_modules"):
            section["top_modules"] = train["top_modules"]
        return {"pipeline": section}

    def _norm_cross(self):
        if self.grid is None or self.num_stages == 1:
            return None
        group = self.grid.pp_group
        return lambda nsq: comm.all_reduce(nsq, group=group)

    # ------------------------------------------------------------------ #
    # A step
    # ------------------------------------------------------------------ #
    def _micro_generator(self, win, m: int) -> torch.Generator:
        """Micro-batch ``m``'s generator on this stage (its dropout; the
        recompute replays it)."""
        seed = fold_in(fold_in(win.generator.initial_seed(),
                               self.stage_id), m)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _run_stage(self, blocks: Any, x: torch.Tensor,
                   gen: torch.Generator) -> torch.Tensor:
        spec, stage = self._pipe_spec, self.stage_id
        if not self._remat:
            return spec.stage_fn(blocks, x, gen, stage)
        leaves, tspec = tree_flatten(blocks)
        names = [str(i) for i in range(len(leaves))]

        def fn(params, g, xx):
            tree = tree_unflatten(tspec, [params[n] for n in names])
            return (spec.stage_fn(tree, xx, g, stage),)
        region = Recompute([Op("stage", ("x",), ("y",), fn, None, True)],
                           frozenset(), GeneratorReplay(gen))
        return region.forward(dict(zip(names, leaves)), {"x": x})["y"]

    def _stage_forward(self, win, m: int, mb: Any,
                       x_in: Optional[torch.Tensor], scale: Any,
                       grad: bool = True) -> _PipeRecord:
        """Micro-batch ``m``'s forward on this stage: the embedding on the
        first, the stage's blocks, the head on the last (whose raw loss
        joins the window's mean)."""
        spec = self._pipe_spec
        params = tree_unflatten(self._treedef, self._loss_leaves)
        gen = self._micro_generator(win, m)
        tokens, targets = _split_batch(mb)
        with torch.set_grad_enabled(grad):
            if self.is_first_stage:
                x = None
                h = spec.embed_fn(params["shared"], tokens, gen)
            else:
                x = x_in.requires_grad_(grad)
                h = x
            y = self._run_stage(params["blocks"], h, gen) if grad else \
                spec.stage_fn(params["blocks"], h, gen, self.stage_id)
            if not self.is_last_stage:
                return _PipeRecord(m, x, y)
            raw = spec.head_fn(params["shared"], y, targets, gen)
        M = win.gas
        r = raw.detach().float()
        win.mean_loss = win.mean_loss + r / M
        return _PipeRecord(m, x, (raw.float() * scale) / M)

    def _forward_held(self, win, m: int, mb: Any,
                      x_in: Optional[torch.Tensor], scale: Any
                      ) -> _PipeRecord:
        """``_stage_forward`` with the card memory its record holds until
        the backward (``pipe_stats["record_bytes"]``: the most over the
        window; the allocator's host-side count, no sync)."""
        cuda = self.device.type == "cuda"
        before = torch.cuda.memory_allocated(self.device) if cuda else 0
        rec = self._stage_forward(win, m, mb, x_in, scale)
        if cuda:
            self.pipe_stats["record_bytes"] = max(
                self.pipe_stats["record_bytes"],
                torch.cuda.memory_allocated(self.device) - before)
        return rec

    def _stage_backward(self, win, rec: _PipeRecord,
                        dy: Optional[torch.Tensor]) -> None:
        extra = () if rec.x is None else (rec.x,)
        grads = self._backward_micro(
            win, rec.out, self._loss_leaves,
            grad_output=None if self.is_last_stage else dy, extra=extra)
        rec.dx = grads[0] if extra else None
        rec.out = rec.x = None

    # --- point to point ------------------------------------------------ #
    def _send_act(self, y: torch.Tensor) -> None:
        dst = self.grid.stage_to_global_rank(self.stage_id + 1)
        head = torch.zeros(_HEADER, dtype=torch.int64)
        head[0], head[1] = y.dim(), _DTYPES.index(y.dtype)
        head[2:2 + y.dim()] = torch.tensor(y.shape)
        self._works.append(comm.isend(head, dst))
        self._works.append(comm.isend(y.detach(), dst))
        self.pipe_stats["p2p_bytes"] += y.numel() * y.element_size()

    def _recv_act(self) -> torch.Tensor:
        src = self.grid.stage_to_global_rank(self.stage_id - 1)
        head = comm.recv((_HEADER,), torch.int64, torch.device("cpu"), src)
        nd = int(head[0])
        shape = tuple(int(v) for v in head[2:2 + nd])
        return comm.recv(shape, _DTYPES[int(head[1])], self.device, src)

    def _send_grad(self, dx: torch.Tensor) -> None:
        dst = self.grid.stage_to_global_rank(self.stage_id - 1)
        self._works.append(comm.isend(dx.detach(), dst))
        self.pipe_stats["p2p_bytes"] += dx.numel() * dx.element_size()

    def _recv_grad(self, like: torch.Tensor) -> torch.Tensor:
        src = self.grid.stage_to_global_rank(self.stage_id + 1)
        return comm.recv(tuple(like.shape), like.dtype, self.device, src)

    def _finish_sends(self) -> None:
        for w in self._works:
            w.wait()
        self._works = []

    # --- the schedules -------------------------------------------------- #
    def _pipe_window(self, micro_batches: List[Any], win, scale) -> None:
        """The window's forwards and backwards under the configured
        schedule; the grads end in the stage engine's accumulators."""
        M = len(micro_batches)
        win.mean_loss = torch.zeros((), dtype=torch.float32,
                                    device=self.device)
        self._works = []
        self.pipe_stats = {"p2p_bytes": 0, "max_live_buffers": 0,
                           "record_bytes": 0}
        if self._schedule == "gpipe":
            recs = []
            for m in range(M):
                x = None if self.is_first_stage else self._recv_act()
                rec = self._forward_held(win, m, micro_batches[m], x, scale)
                if not self.is_last_stage:
                    self._send_act(rec.out)
                recs.append(rec)
            self.pipe_stats["max_live_buffers"] = M
            for rec in recs:
                dy = None if self.is_last_stage else \
                    self._recv_grad(rec.out)
                self._stage_backward(win, rec, dy)
                if not self.is_first_stage:
                    self._send_grad(rec.dx)
                rec.dx = None
        else:
            self._interpret_1f1b(micro_batches, win, scale)
        self._finish_sends()

    def _interpret_1f1b(self, micro_batches: List[Any], win,
                        scale) -> None:
        sched = TrainSchedule(micro_batches=len(micro_batches),
                              stages=self.num_stages,
                              stage_id=self.stage_id)
        bufs: Dict[int, Any] = {}
        count = {"fwd": 0, "bwd": 0}

        def live() -> int:
            return sum(1 for b in bufs.values()
                       if isinstance(b, _PipeRecord) and b.dx is None
                       and b.out is not None)

        def load(cmd):
            bufs[cmd.buffer_id] = None

        def recv_act(cmd):
            bufs[cmd.buffer_id] = self._recv_act()

        def forward(cmd):
            m = count["fwd"]
            count["fwd"] += 1
            x = bufs.get(cmd.buffer_id)
            bufs[cmd.buffer_id] = self._forward_held(
                win, m, micro_batches[m], x, scale)
            self.pipe_stats["max_live_buffers"] = max(
                self.pipe_stats["max_live_buffers"], live())

        def send_act(cmd):
            self._send_act(bufs[cmd.buffer_id].out)

        def recv_grad(cmd):
            rec = bufs[cmd.buffer_id]
            rec.dx = self._recv_grad(rec.out)   # (held until backward)

        def backward(cmd):
            rec = bufs[cmd.buffer_id]
            dy, rec.dx = rec.dx, None
            assert rec.micro == count["bwd"], (rec.micro, count)
            count["bwd"] += 1
            self._stage_backward(win, rec, dy)

        def send_grad(cmd):
            self._send_grad(bufs[cmd.buffer_id].dx)
            bufs[cmd.buffer_id].dx = None

        def nothing(cmd):
            return None       # (the step closes in _apply_window)

        interpret(sched, {
            LoadMicroBatch: load, RecvActivation: recv_act,
            ForwardPass: forward, SendActivation: send_act,
            RecvGrad: recv_grad, BackwardPass: backward,
            SendGrad: send_grad, ReduceTiedGrads: nothing,
            ReduceGrads: nothing, OptimizerStep: nothing})
        assert count["fwd"] == count["bwd"] == len(micro_batches), count

    def _train_step(self, micro_batches: List[Any], step: int
                    ) -> Dict[str, torch.Tensor]:
        if self._pipe_spec is None:
            return super()._train_step(micro_batches, step)
        win = self._open_window(step)
        self._pipe_window(micro_batches, win, self.state.loss_scale)
        return self._apply_window(win)

    def eval_batch(self, batch: Any, rng=None) -> torch.Tensor:
        """The mean loss of ``batch`` (this rank's rows of gas micro-
        batches) through ``InferenceSchedule``, without gradients; the
        same value on every rank (a collective)."""
        if self._pipe_spec is None:
            return super().eval_batch(batch, rng)
        micro_batches = self._split_micro_batches(self._to_device(batch))
        M = len(micro_batches)
        seed = fold_in(fold_in(self._base_seed, _EVAL_FOLD),
                       self._eval_count) if rng is None else int(rng)
        self._eval_count += 1
        win = _Window(self.global_steps, torch.Generator().manual_seed(seed),
                      None, M)
        win.mean_loss = torch.zeros((), dtype=torch.float32,
                                    device=self.device)
        self._works = []
        self.pipe_stats = {"p2p_bytes": 0, "max_live_buffers": 0}
        sched = InferenceSchedule(micro_batches=M, stages=self.num_stages,
                                  stage_id=self.stage_id)
        bufs: Dict[int, Any] = {}
        count = [0]

        def forward(cmd):
            m = count[0]
            count[0] += 1
            bufs[cmd.buffer_id] = self._stage_forward(
                win, m, micro_batches[m], bufs.get(cmd.buffer_id), 1.0,
                grad=False)

        with torch.no_grad():
            interpret(sched, {
                LoadMicroBatch: lambda cmd: bufs.__setitem__(
                    cmd.buffer_id, None),
                RecvActivation: lambda cmd: bufs.__setitem__(
                    cmd.buffer_id, self._recv_act()),
                ForwardPass: forward,
                SendActivation: lambda cmd: self._send_act(
                    bufs[cmd.buffer_id].out)})
            self._finish_sends()
            loss = win.mean_loss
            if self.dp > 1:
                loss = comm.all_reduce(loss.clone(),
                                       group=self._dp_group) / self.dp
            loss = self._cross_stage_loss(loss)
        return loss

    def _cross_stage_loss(self, loss: torch.Tensor) -> torch.Tensor:
        if self.grid is None or self.num_stages == 1:
            return loss
        out = loss.clone() if self.is_last_stage else torch.zeros_like(loss)
        return comm.all_reduce(out, group=self.grid.pp_group)

    def forward(self, batch: Any) -> torch.Tensor:
        if self._pipe_spec is not None:
            raise RuntimeError(
                "Only train_batch() is accessible in pipeline mode (the "
                "reference's PipelineEngine refuses forward/backward/step)")
        return super().forward(batch)

    def backward(self, loss=None, allreduce_gradients: bool = True):
        if self._pipe_spec is not None:
            raise RuntimeError("Only train_batch() is accessible in "
                               "pipeline mode")
        return super().backward(loss, allreduce_gradients)

    def step(self) -> None:
        if self._pipe_spec is not None:
            raise RuntimeError("Only train_batch() is accessible in "
                               "pipeline mode")
        return super().step()

    # ------------------------------------------------------------------ #
    # The whole tree (a collective over every rank)
    # ------------------------------------------------------------------ #
    def _stage_host_state(self, with_bufs: bool) -> Dict[str, Any]:
        """This stage's whole leaves on the host: the fp32 parameters
        and, ``with_bufs``, each optimizer buffer by name (a collective
        of the stage's dp group)."""
        params = [t.detach().float().cpu() for t in
                  tree_flatten(self.full_params())[0]]
        bufs = state_buffers(self.state.opt_state) if with_bufs else {}
        per_name: Dict[str, List[Any]] = {}
        for name, groups in bufs.items():
            leaves: List[Any] = [None] * len(self._leaf_shapes)
            for gi, idxs in enumerate(self._group_leaves):
                buf = groups[gi]
                if self._shard_local:
                    sg = self._shards[gi]
                    full = self._whole(sg, buf).cpu()
                    lv = [torch.empty(self._leaf_shapes[i],
                                      dtype=torch.float32) for i in idxs]
                    sg.unpack(full, lv)
                else:
                    lv = [v.cpu().clone()
                          for v in self._groups[gi].views(buf)]
                for i, t in zip(idxs, lv):
                    leaves[i] = t
            per_name[name] = leaves
        return {"params": params, "bufs": per_name}

    def _gather_whole(self, with_bufs: bool = True
                      ) -> Optional[Dict[str, Any]]:
        """Every stage's leaves joined into the whole ``{shared,
        blocks}`` tree on global rank 0 (None elsewhere): ``shared`` from
        the first stage, each block leaf the stages' slices in order."""
        mine = self._stage_host_state(with_bufs)
        if self.grid is None or self.num_stages == 1:
            parts = [mine]
        else:
            # Each stage's dp rank 0 sends its leaves to global rank 0
            # over the first column's pipe group.
            if self.dp_rank != 0:
                return None
            obj = {"params": [t.numpy() for t in mine["params"]],
                   "bufs": {n: [t.numpy() for t in ts]
                            for n, ts in mine["bufs"].items()}}
            root = comm.global_rank() == 0
            got: Optional[List[Any]] = [None] * self.num_stages \
                if root else None
            torch.distributed.gather_object(obj, got, dst=0,
                                            group=self.grid.pp_group)
            if not root:
                return None
            parts = [{"params": [torch.from_numpy(np.asarray(t))
                                 for t in p["params"]],
                      "bufs": {n: [torch.from_numpy(np.asarray(t))
                                   for t in ts]
                               for n, ts in p["bufs"].items()}}
                     for p in got]
        nb = self._n_block_leaves
        whole_spec = tree_flatten(self._pipe_spec.params)[1]

        def join(lists: List[List[torch.Tensor]]) -> List[torch.Tensor]:
            blocks = [torch.cat([lv[j] for lv in lists]) for j in range(nb)]
            return blocks + list(lists[0][nb:])
        names = list(parts[0]["bufs"])
        return {"spec": whole_spec,
                "params": join([p["params"] for p in parts]),
                "bufs": {n: join([p["bufs"][n] for p in parts])
                         for n in names}}

    def whole_params(self) -> Optional[Any]:
        """The whole ``{shared, blocks}`` parameter tree (fp32, host) on
        global rank 0, None on the other ranks (a collective)."""
        whole = self._gather_whole(with_bufs=False)
        if whole is None:
            return None
        return tree_unflatten(whole["spec"], whole["params"])

    # ------------------------------------------------------------------ #
    # Checkpoints
    # ------------------------------------------------------------------ #
    def _optax_layout(self) -> List[str]:
        """The JAX pipeline's optimizer file (its optax chain's leaves):
        a fused Adam's state written as the optax Adam chain's."""
        if isinstance(self.optimizer, FusedAdam):
            o = self.optimizer
            return AdamChain(o.learning_rate, b1=o.b1, b2=o.b2, eps=o.eps,
                             weight_decay=o.weight_decay,
                             adam_w_mode=o.adam_w_mode).jax_layout()
        return self.optimizer.jax_layout()

    @staticmethod
    def _name_map(opt: Any) -> Dict[str, str]:
        """The optax name of each of the port's buffers."""
        return {"m": "mu", "v": "nu"} if isinstance(opt, FusedAdam) \
            else {n: n for n in opt.buffers()}

    def _snapshot_checkpoint(self, save_dir, tag, client_state,
                             save_latest):
        if self.pipeline_module is not None:
            return self._snapshot_layer_files(save_dir, tag, client_state,
                                              save_latest)
        if self._pipe_spec is None:
            return super()._snapshot_checkpoint(save_dir, tag,
                                                client_state, save_latest)
        if tag is None:
            tag = f"global_step{self.global_steps}"
        self._checkpoint_tag_validation(tag)
        st = self.state
        layout = self._optax_layout()      # (a torch.optim one raises)
        scal = [int(st.opt_state.count), int(st.step),
                float(st.loss_scale), int(st.growth_count),
                int(st.hysteresis), int(st.skipped_steps)]
        whole = self._gather_whole()
        self.skipped_steps = scal[5]
        meta: Dict[str, Any] = {
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "skipped_steps": self.skipped_steps,
            "dp_world_size": self.dp,
            "ds_config_precision": self.config.precision_dtype,
            "client_state": client_state or {},
        }
        if self.lr_scheduler is not None and \
                hasattr(self.lr_scheduler, "state_dict"):
            meta["lr_scheduler"] = self.lr_scheduler.state_dict()
        blobs: List[Any] = []
        if whole is not None:
            names = self._name_map(self.optimizer)
            per_name = {names[n]: ts for n, ts in whole["bufs"].items()}
            leaves: List[Any] = []
            for entry in layout:
                if entry == COUNT:
                    leaves.append(np.asarray(scal[0], np.int32))
                else:
                    leaves += [t.numpy() for t in per_name[entry]]
            meta["optim_shards"] = 1
            meta["optim_shard_axes"] = [None] * len(leaves)
            params = tree_unflatten(whole["spec"],
                                    [t.numpy() for t in whole["params"]])
            scalars = {"step": np.asarray(scal[1], np.int32),
                       "loss_scale": np.asarray(scal[2], np.float32),
                       "growth_count": np.asarray(scal[3], np.int32),
                       "hysteresis": np.asarray(scal[4], np.int32),
                       "skipped": np.asarray(scal[5], np.int32)}

            def optim_blob() -> bytes:
                blob: Dict[str, Any] = {str(i): x
                                        for i, x in enumerate(leaves)}
                blob["__scalars__"] = scalars
                return msgpack_serialize(blob)
            blobs = [(MODEL_FILE, lambda: msgpack_serialize(
                {"module": params})),
                     (OPTIM_SHARD_FMT.format(0), optim_blob)]
        return CheckpointSnapshot(
            save_dir=save_dir, tag=str(tag), save_latest=save_latest,
            meta=meta, blobs=blobs, is_writer=comm.global_rank() == 0,
            fsync=self._ckpt_fsync)

    def _load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                         load_optimizer_states=True,
                         load_lr_scheduler_states=True):
        if self._pipe_spec is None:
            return super()._load_checkpoint(
                load_dir, tag, load_module_strict, load_optimizer_states,
                load_lr_scheduler_states)
        if tag is None:
            latest = os.path.join(load_dir, LATEST_FILE)
            if not os.path.isfile(latest):
                logger.warning(f"no 'latest' file at {load_dir}; nothing "
                               "loaded")
                return None, {}
            with open(latest) as f:
                tag = f.read().strip()
        path = os.path.join(load_dir, str(tag))
        if not os.path.isdir(path) or not is_complete(path):
            logger.warning(f"checkpoint {path} not found or incomplete; "
                           "nothing loaded")
            return None, {}
        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)
        with open(os.path.join(path, MODEL_FILE), "rb") as f:
            module = msgpack_restore(f.read())["module"]
        whole_leaves, _ = tree_flatten(module)
        mine = self._stage_slice([torch.as_tensor(np.asarray(x))
                                  for x in whole_leaves])
        self._write_params(mine)
        if load_optimizer_states:
            n = int(meta.get("optim_shards", 1))
            blobs = self._read_shard_blobs(path, OPTIM_SHARD_FMT, n)
            layout = self._optax_layout()
            L = len(whole_leaves)
            n_leaves = sum(1 if e == COUNT else L for e in layout)
            leaves = self._assemble_shards(
                blobs, meta.get("optim_shard_axes") or [None] * n_leaves,
                n_leaves)
            sc = blobs[0].get("__scalars__", {})
            per_name: Dict[str, List[Any]] = {}
            pos = 0
            count = 0
            for entry in layout:
                if entry == COUNT:
                    count = int(np.asarray(leaves[pos]))
                    pos += 1
                else:
                    per_name[entry] = leaves[pos:pos + L]
                    pos += L
            names = self._name_map(self.optimizer)
            bufs = state_buffers(self.state.opt_state)
            with torch.no_grad():
                for name, groups in bufs.items():
                    src = self._stage_slice([
                        torch.as_tensor(np.asarray(x, np.float32))
                        for x in per_name[names[name]]])
                    for gi, idxs in enumerate(self._group_leaves):
                        part = [src[i].to(self.device) for i in idxs]
                        if self._shard_local:
                            self._shards[gi].pack(part, groups[gi])
                        else:
                            for v, t in zip(self._groups[gi].views(
                                    groups[gi]), part):
                                v.copy_(t)
            self._write_opt_state(
                self.state.opt_state._replace(
                    count=torch.tensor(count, dtype=torch.int32)),
                int(np.asarray(sc.get("step", count))),
                float(np.asarray(sc["loss_scale"])) if "loss_scale" in sc
                else None,
                int(np.asarray(sc.get("growth_count", 0))),
                int(np.asarray(sc["hysteresis"])) if "hysteresis" in sc
                else None,
                int(np.asarray(sc.get("skipped", 0))))
        self.global_steps = int(meta.get("global_steps", 0))
        self.global_samples = int(meta.get("global_samples", 0))
        self.skipped_steps = int(meta.get("skipped_steps", 0))
        if load_lr_scheduler_states and self.lr_scheduler is not None \
                and "lr_scheduler" in meta and \
                hasattr(self.lr_scheduler, "load_state_dict"):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        return path, meta.get("client_state", {})

    def _stage_slice(self, whole: List[torch.Tensor]) -> List[torch.Tensor]:
        """The whole tree's leaves (tree order) → this stage's."""
        spec = self._pipe_spec
        tree = tree_unflatten(tree_flatten(spec.params)[1], whole)
        per = spec.num_layers // self.num_stages
        s = self.stage_id
        blocks = [t[s * per:(s + 1) * per]
                  for t in tree_flatten(tree["blocks"])[0]]
        ends = self.is_first_stage or self.is_last_stage
        shared = tree_flatten(tree.get("shared", {}))[0] if ends else []
        return blocks + shared

    # --- PipelineModule: one file a layer -------------------------------- #
    def _snapshot_layer_files(self, save_dir, tag, client_state,
                              save_latest):
        snap = super()._snapshot_checkpoint(save_dir, tag, client_state,
                                            save_latest)
        mod = self.pipeline_module
        host = {k: v for k, v in _host_tree(self.full_params()).items()}
        layer_files: Dict[str, str] = {}
        blobs = []
        for i in range(len(mod.layers)):
            key = mod.param_key(i)
            if key in layer_files:
                continue
            fname = self.LAYER_FILE_FMT.format(i)
            layer_files[key] = fname
            tree = host.get(key, {})
            blobs.append((fname, lambda t=tree: msgpack_serialize(t)))
        snap.meta["pipeline_layer_files"] = layer_files
        snap.blobs = [b for b in snap.blobs if b[0] != MODEL_FILE] + blobs
        return snap


def _host_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


__all__ = ["PipelineEngine", "SCHEDULES"]
