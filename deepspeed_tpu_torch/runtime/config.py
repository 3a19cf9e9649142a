"""The ds_config (port of ``deepspeed_tpu/runtime/config.py``):
``DeepSpeedConfig`` for training and the ``inference`` block.

Same keys, defaults and validation errors as the JAX package, so one
ds_config dict drives either engine. The port parses the keys of its
one-card training path (the batch triple, precision, optimizer,
scheduler, clipping, ZeRO, the ``sparse_attention`` section, the
``moe`` block) and, for
the blocks of features it does not
run yet, just enough to tell whether they are enabled:
``DeepSpeedConfig.unported_features()`` names them, and the engine
raises ``NotImplementedError`` for each. The ``inference.slo`` block
parses and validates but the port does not act on it yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

from . import config_utils
from .zero.config import ZeroConfig
from .. import constants as C
from ..utils.logging import logger


class DeepSpeedConfigError(Exception):
    pass


class InferenceSloConfig:
    """The ``inference.slo`` block: TTFT/TPOT targets, availability
    target, and the trailing attainment window."""

    def __init__(self, d: Optional[Dict[str, Any]] = None):
        d = d or {}
        get = config_utils.get_scalar_param
        self.ttft_ms = get(d, C.INFERENCE_SLO_TTFT_MS,
                           C.INFERENCE_SLO_TTFT_MS_DEFAULT)
        self.tpot_ms = get(d, C.INFERENCE_SLO_TPOT_MS,
                           C.INFERENCE_SLO_TPOT_MS_DEFAULT)
        self.availability = get(d, C.INFERENCE_SLO_AVAILABILITY,
                                C.INFERENCE_SLO_AVAILABILITY_DEFAULT)
        self.window_s = get(d, C.INFERENCE_SLO_WINDOW_S,
                            C.INFERENCE_SLO_WINDOW_S_DEFAULT)
        self._validate()

    @property
    def enabled(self) -> bool:
        return self.ttft_ms > 0 or self.tpot_ms > 0

    def _validate(self) -> None:
        blk = f"{C.INFERENCE}.{C.INFERENCE_SLO}"
        for name, v in ((C.INFERENCE_SLO_TTFT_MS, self.ttft_ms),
                        (C.INFERENCE_SLO_TPOT_MS, self.tpot_ms)):
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v < 0:
                raise DeepSpeedConfigError(
                    f"{blk}.{name} must be a non-negative number "
                    f"(0 = target unset), got {v!r}")
        if not isinstance(self.availability, (int, float)) \
                or isinstance(self.availability, bool) \
                or not (0.0 < self.availability < 1.0):
            raise DeepSpeedConfigError(
                f"{blk}.{C.INFERENCE_SLO_AVAILABILITY} must be a number "
                f"in (0, 1), got {self.availability!r}")
        if not isinstance(self.window_s, (int, float)) \
                or isinstance(self.window_s, bool) or self.window_s <= 0:
            raise DeepSpeedConfigError(
                f"{blk}.{C.INFERENCE_SLO_WINDOW_S} must be a positive "
                f"number of seconds, got {self.window_s!r}")


class InferenceConfig:
    """The ``inference`` block: slot count, cache capacity, page size,
    prefill chunk, speculative depth, KV dtype and the kernel knob."""

    def __init__(self, param_dict: Optional[Dict[str, Any]] = None):
        d = (param_dict or {}).get(C.INFERENCE, {})
        get = config_utils.get_scalar_param
        self.max_slots = get(d, C.INFERENCE_MAX_SLOTS,
                             C.INFERENCE_MAX_SLOTS_DEFAULT)
        self.max_seq_len = get(d, C.INFERENCE_MAX_SEQ_LEN,
                               C.INFERENCE_MAX_SEQ_LEN_DEFAULT)
        self.quantize = get(d, C.INFERENCE_QUANTIZE,
                            C.INFERENCE_QUANTIZE_DEFAULT)
        self.prefill_chunk = get(d, C.INFERENCE_PREFILL_CHUNK,
                                 C.INFERENCE_PREFILL_CHUNK_DEFAULT)
        self.block_size = get(d, C.INFERENCE_BLOCK_SIZE,
                              C.INFERENCE_BLOCK_SIZE_DEFAULT)
        self.num_blocks = get(d, C.INFERENCE_NUM_BLOCKS,
                              C.INFERENCE_NUM_BLOCKS_DEFAULT)
        self.spec_k = get(d, C.INFERENCE_SPEC_K, C.INFERENCE_SPEC_K_DEFAULT)
        self.spec_ngram = get(d, C.INFERENCE_SPEC_NGRAM,
                              C.INFERENCE_SPEC_NGRAM_DEFAULT)
        self.kv_cache_dtype = get(d, C.INFERENCE_KV_DTYPE,
                                  C.INFERENCE_KV_DTYPE_DEFAULT)
        self.replica = get(d, C.INFERENCE_REPLICA,
                           C.INFERENCE_REPLICA_DEFAULT)
        self.paged_kernel = get(d, C.INFERENCE_PAGED_KERNEL,
                                C.INFERENCE_PAGED_KERNEL_DEFAULT)
        slo_d = d.get(C.INFERENCE_SLO)
        if slo_d is not None and not isinstance(slo_d, dict):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_SLO} must be a dict block, "
                f"got {slo_d!r}")
        self.slo = InferenceSloConfig(slo_d)
        self._validate()

    def _validate(self) -> None:
        if not isinstance(self.max_slots, int) or self.max_slots <= 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_MAX_SLOTS} must be a positive "
                f"int, got {self.max_slots!r}")
        if not isinstance(self.max_seq_len, int) or self.max_seq_len < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_MAX_SEQ_LEN} must be a "
                f"non-negative int (0 = model max), got "
                f"{self.max_seq_len!r}")
        if self.quantize not in C.INFERENCE_QUANTIZE_MODES:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_QUANTIZE} must be one of "
                f"{C.INFERENCE_QUANTIZE_MODES}, got {self.quantize!r}")
        if not isinstance(self.prefill_chunk, int) or self.prefill_chunk < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_PREFILL_CHUNK} must be a "
                f"non-negative int (0 = whole-prompt prefill), got "
                f"{self.prefill_chunk!r}")
        if not isinstance(self.block_size, int) or self.block_size < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_BLOCK_SIZE} must be a "
                f"non-negative int (0 = slot-major layout), got "
                f"{self.block_size!r}")
        if not isinstance(self.num_blocks, int) or self.num_blocks < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_NUM_BLOCKS} must be a "
                f"non-negative int (0 = full provisioning), got "
                f"{self.num_blocks!r}")
        if not isinstance(self.spec_k, int) or self.spec_k < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_SPEC_K} must be a "
                f"non-negative int (0 = speculative decoding off), got "
                f"{self.spec_k!r}")
        if self.spec_k > 0 and self.block_size == 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_SPEC_K} requires the paged "
                f"cache ({C.INFERENCE_BLOCK_SIZE} > 0) — the verify step "
                "writes draft K/V through the block table")
        if not isinstance(self.spec_ngram, int) or self.spec_ngram < 1:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_SPEC_NGRAM} must be a "
                f"positive int, got {self.spec_ngram!r}")
        if self.kv_cache_dtype not in C.INFERENCE_KV_DTYPE_MODES:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_KV_DTYPE} must be one of "
                f"{C.INFERENCE_KV_DTYPE_MODES}, got "
                f"{self.kv_cache_dtype!r}")
        if not isinstance(self.replica, str):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_REPLICA} must be a string "
                f"label, got {self.replica!r}")
        if self.paged_kernel not in (True, False, "auto"):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_PAGED_KERNEL} must be true, "
                f"false, or \"auto\", got {self.paged_kernel!r}")


class MoeConfig:
    """The ``moe`` block. ``num_experts == 0`` (the default) leaves it
    inert. The engine reads it for the MoE metrics; build the model's
    ``TransformerConfig.moe`` from it with ``MoEConfig.from_ds_config``.
    Same validation and messages as the JAX package's ``MoeConfig``."""

    def __init__(self, param_dict: Optional[Dict[str, Any]] = None):
        d = (param_dict or {}).get(C.MOE, {})
        get = config_utils.get_scalar_param
        self.num_experts = get(d, C.MOE_NUM_EXPERTS,
                               C.MOE_NUM_EXPERTS_DEFAULT)
        self.top_k = get(d, C.MOE_TOP_K, C.MOE_TOP_K_DEFAULT)
        self.capacity_factor = get(d, C.MOE_CAPACITY_FACTOR,
                                   C.MOE_CAPACITY_FACTOR_DEFAULT)
        self.aux_loss_weight = get(d, C.MOE_AUX_LOSS_WEIGHT,
                                   C.MOE_AUX_LOSS_WEIGHT_DEFAULT)
        self.z_loss_weight = get(d, C.MOE_Z_LOSS_WEIGHT,
                                 C.MOE_Z_LOSS_WEIGHT_DEFAULT)
        self.expert_parallel_size = get(d, C.MOE_EXPERT_PARALLEL_SIZE,
                                        C.MOE_EXPERT_PARALLEL_SIZE_DEFAULT)
        self.grouped_gemm = get(d, C.MOE_GROUPED_GEMM,
                                C.MOE_GROUPED_GEMM_DEFAULT)
        self._validate()

    def _validate(self) -> None:
        blk = C.MOE
        if not isinstance(self.num_experts, int) or self.num_experts < 0:
            raise DeepSpeedConfigError(
                f"{blk}.{C.MOE_NUM_EXPERTS} must be a non-negative int "
                f"(0 = disabled), got {self.num_experts!r}")
        if not isinstance(self.expert_parallel_size, int) or \
                self.expert_parallel_size < 1:
            raise DeepSpeedConfigError(
                f"{blk}.{C.MOE_EXPERT_PARALLEL_SIZE} must be a positive "
                f"int, got {self.expert_parallel_size!r}")
        if self.grouped_gemm not in (True, False, "auto"):
            raise DeepSpeedConfigError(
                f"{blk}.{C.MOE_GROUPED_GEMM} must be true/false/"
                f"\"auto\", got {self.grouped_gemm!r}")
        if self.num_experts == 0:
            if self.expert_parallel_size > 1:
                raise DeepSpeedConfigError(
                    f"{blk}.{C.MOE_EXPERT_PARALLEL_SIZE} > 1 needs "
                    f"{C.MOE_NUM_EXPERTS} > 0")
            return
        if self.top_k not in (1, 2):
            raise DeepSpeedConfigError(
                f"{blk}.{C.MOE_TOP_K} must be 1 or 2, got {self.top_k!r}")
        if self.top_k > self.num_experts:
            raise DeepSpeedConfigError(
                f"{blk}.{C.MOE_TOP_K}={self.top_k} exceeds "
                f"{C.MOE_NUM_EXPERTS}={self.num_experts}")
        cf = self.capacity_factor
        if isinstance(cf, bool) or not isinstance(cf, (int, float)) or \
                not cf > 0:
            raise DeepSpeedConfigError(
                f"{blk}.{C.MOE_CAPACITY_FACTOR} must be a positive "
                f"number (inf = never drop), got {cf!r}")
        for name, v in ((C.MOE_AUX_LOSS_WEIGHT, self.aux_loss_weight),
                        (C.MOE_Z_LOSS_WEIGHT, self.z_loss_weight)):
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or v < 0:
                raise DeepSpeedConfigError(
                    f"{blk}.{name} must be a non-negative number, "
                    f"got {v!r}")
        if self.num_experts % self.expert_parallel_size != 0:
            raise DeepSpeedConfigError(
                f"{blk}.{C.MOE_NUM_EXPERTS}={self.num_experts} not "
                f"divisible by {C.MOE_EXPERT_PARALLEL_SIZE}="
                f"{self.expert_parallel_size}")


class DeepSpeedConfig:
    """The training ds_config: a JSON path or a parsed dict.

    ``world_size`` is the number of data-parallel replicas the batch
    triple is solved for (default 1: the port runs on one card)."""

    def __init__(self, config: Union[str, Dict[str, Any]],
                 world_size: Optional[int] = None):
        if isinstance(config, dict):
            self._param_dict = config
        else:
            self._param_dict = config_utils.load_config_json(config)
        self.world_size = 1 if world_size is None else world_size
        d = self._param_dict
        if d.get(C.ELASTICITY, {}).get(C.ENABLED, C.ENABLED_DEFAULT):
            raise NotImplementedError(
                "elasticity is not ported yet (ROADMAP slice 6: observability "
                "and tooling): it "
                "rewrites the batch triple before the solver runs")
        self._initialize_params(d)
        self._configure_train_batch_size()
        self._do_sanity_check()

    def _initialize_params(self, d: Dict[str, Any]) -> None:
        get = config_utils.get_scalar_param
        self.train_batch_size = get(d, C.TRAIN_BATCH_SIZE,
                                    C.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = get(
            d, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = get(
            d, C.GRADIENT_ACCUMULATION_STEPS,
            C.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = get(d, C.STEPS_PER_PRINT,
                                   C.STEPS_PER_PRINT_DEFAULT)
        self.prescale_gradients = get(d, C.PRESCALE_GRADIENTS,
                                      C.PRESCALE_GRADIENTS_DEFAULT)
        self.gradient_predivide_factor = get(
            d, C.GRADIENT_PREDIVIDE_FACTOR,
            C.GRADIENT_PREDIVIDE_FACTOR_DEFAULT)
        self.sparse_gradients_enabled = get(d, C.SPARSE_GRADIENTS,
                                            C.SPARSE_GRADIENTS_DEFAULT)

        self.zero_config = ZeroConfig(d)
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_optimization_stage > 0

        fp16 = d.get(C.FP16, {})
        self.fp16_enabled = get(fp16, C.FP16_ENABLED, C.FP16_ENABLED_DEFAULT)
        self.fp16_loss_scale = get(fp16, C.FP16_LOSS_SCALE,
                                   C.FP16_LOSS_SCALE_DEFAULT)
        self.fp16_initial_scale_power = get(
            fp16, C.FP16_INITIAL_SCALE_POWER,
            C.FP16_INITIAL_SCALE_POWER_DEFAULT)
        self.fp16_loss_scale_window = get(fp16, C.FP16_LOSS_SCALE_WINDOW,
                                          C.FP16_LOSS_SCALE_WINDOW_DEFAULT)
        self.fp16_hysteresis = get(fp16, C.FP16_HYSTERESIS,
                                   C.FP16_HYSTERESIS_DEFAULT)
        self.fp16_min_loss_scale = get(fp16, C.FP16_MIN_LOSS_SCALE,
                                       C.FP16_MIN_LOSS_SCALE_DEFAULT)

        bf16 = d.get(C.BF16, {})
        self.bf16_enabled = get(bf16, C.BF16_ENABLED, C.BF16_ENABLED_DEFAULT)
        self.bf16_stochastic_rounding = get(
            bf16, C.BF16_STOCHASTIC_ROUNDING,
            C.BF16_STOCHASTIC_ROUNDING_DEFAULT)

        amp = d.get(C.AMP, {})
        self.amp_enabled = get(amp, C.AMP_ENABLED, C.AMP_ENABLED_DEFAULT)
        self.amp_params = {k: v for k, v in amp.items()
                           if k != C.AMP_ENABLED}
        # amp maps onto the bf16 mixed-precision path, as in the JAX
        # package; with fp16 it raises instead of guessing.
        if self.amp_enabled:
            if self.fp16_enabled:
                raise DeepSpeedConfigError(
                    "amp and fp16 cannot both be enabled: on TPU amp maps "
                    "to the bf16 mixed-precision path — pick `bf16` (or "
                    "`amp` alone) or `fp16`")
            if not self.bf16_enabled:
                self.bf16_enabled = True
                logger.info("amp: enabled -> mapped to the bf16 "
                            "mixed-precision path")

        self.gradient_clipping = get(d, C.GRADIENT_CLIPPING,
                                     C.GRADIENT_CLIPPING_DEFAULT)

        optimizer = d.get(C.OPTIMIZER)
        if optimizer is not None:
            self.optimizer_name = optimizer.get(C.TYPE,
                                                C.OPTIMIZER_TYPE_DEFAULT)
            if self.optimizer_name is not None:
                self.optimizer_name = self.optimizer_name.lower()
            self.optimizer_params = optimizer.get(C.OPTIMIZER_PARAMS, {})
            self.optimizer_legacy_fusion = optimizer.get(
                C.LEGACY_FUSION, C.LEGACY_FUSION_DEFAULT)
        else:
            self.optimizer_name = None
            self.optimizer_params = {}
            self.optimizer_legacy_fusion = False
        self.optimizer_fused = bool((self.optimizer_params or {}).get(
            C.OPTIMIZER_FUSED, C.OPTIMIZER_FUSED_DEFAULT))

        scheduler = d.get(C.SCHEDULER)
        if scheduler is not None:
            self.scheduler_name = scheduler.get(C.TYPE,
                                                C.SCHEDULER_TYPE_DEFAULT)
            self.scheduler_params = scheduler.get(C.SCHEDULER_PARAMS, {})
        else:
            self.scheduler_name = None
            self.scheduler_params = {}

        self.wall_clock_breakdown = get(d, C.WALL_CLOCK_BREAKDOWN,
                                        C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.memory_breakdown = get(d, C.MEMORY_BREAKDOWN,
                                    C.MEMORY_BREAKDOWN_DEFAULT)
        # Mode-specific defaults filled, unknown modes and keys rejected at
        # config time, as in the JAX package; sparsity_config_from_dict()
        # turns the dict into the layout object the attention consumes.
        from ..ops.sparse_attention.config_factory import \
            normalize_sparse_attention
        self.sparse_attention = normalize_sparse_attention(
            d.get(C.SPARSE_ATTENTION))
        self.inference_config = InferenceConfig(d)
        self.moe_config = MoeConfig(d)

    def _configure_train_batch_size(self) -> None:
        """Solve train_batch = micro_batch * grad_accum * world."""
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        world = self.world_size

        if train_batch is not None and micro_batch is not None and \
                grad_acc is not None:
            pass  # all set; verified in sanity check
        elif train_batch is not None and micro_batch is not None:
            grad_acc = train_batch // micro_batch
            grad_acc //= world
            self.gradient_accumulation_steps = grad_acc
        elif train_batch is not None and grad_acc is not None:
            micro_batch = train_batch // world
            micro_batch //= grad_acc
            self.train_micro_batch_size_per_gpu = micro_batch
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * world
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = train_batch // world
        elif micro_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_batch_size = micro_batch * world
        # else: all None → sanity check raises

    def _batch_assertion(self) -> None:
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        assert train_batch > 0, \
            f"Train batch size: {train_batch} has to be greater than 0"
        assert micro_batch > 0, (f"Micro batch size per device: "
                                 f"{micro_batch} has to be greater than 0")
        assert grad_acc > 0, (f"Gradient accumulation steps: {grad_acc} "
                              "has to be greater than 0")
        assert train_batch == micro_batch * grad_acc * self.world_size, (
            f"Check batch related parameters. train_batch_size is not "
            f"equal to micro_batch_per_gpu * gradient_acc_step * "
            f"world_size {train_batch} != {micro_batch} * {grad_acc} * "
            f"{self.world_size}")

    def _do_sanity_check(self) -> None:
        if self.train_batch_size is None and \
                self.train_micro_batch_size_per_gpu is None:
            raise DeepSpeedConfigError(
                f"Either {C.TRAIN_BATCH_SIZE} or "
                f"{C.TRAIN_MICRO_BATCH_SIZE_PER_GPU} must be set in the "
                "DeepSpeed config")
        self._batch_assertion()
        if self.fp16_enabled and self.bf16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        if self.bf16_stochastic_rounding and not self.bf16_enabled:
            raise DeepSpeedConfigError(
                "bf16.stochastic_rounding requires bf16.enabled (it is the "
                "master-free bf16 update mode)")
        if self.zero_enabled and \
                self.zero_optimization_stage > C.MAX_STAGE_ZERO_OPTIMIZATION:
            raise DeepSpeedConfigError(
                f"ZeRO stage {self.zero_optimization_stage} > max "
                f"{C.MAX_STAGE_ZERO_OPTIMIZATION}")

    def unported_features(self) -> List[Tuple[str, str]]:
        """``(feature, the ROADMAP slice that brings it)`` for every
        enabled block the port does not run yet."""
        d = self._param_dict
        mesh = d.get(C.MESH, {})
        ckpt = d.get(C.CHECKPOINT, {})
        checks = [
            (self.zero_optimization_stage >= 3, "zero_optimization.stage 3",
             "slice 6: dp and ZeRO-1/2/3"),
            (bool(self.zero_config.cpu_offload),
             "zero_optimization.cpu_offload", "slice 6: ZeRO-Offload"),
            (bool(self.sparse_gradients_enabled), "sparse_gradients",
             "slice 6: parallel axes and comm extras"),
            (self.optimizer_name == C.ONEBIT_ADAM_OPTIMIZER,
             "OnebitAdam", "slice 6: parallel axes and comm extras"),
            (bool(d.get(C.PROGRESSIVE_LAYER_DROP, {}).get(
                C.PLD_ENABLED, C.PLD_ENABLED_DEFAULT)),
             "progressive_layer_drop", "slice 6: remat and progressive layer drop"),
            ((d.get(C.PIPELINE, {}).get(C.PIPELINE_STAGES) or 1) > 1 or
             (mesh.get(C.MESH_PIPE_PARALLEL_SIZE) or 1) > 1,
             "pipeline parallelism", "slice 6: parallel axes and comm extras"),
            ((mesh.get(C.MESH_MODEL_PARALLEL_SIZE) or 1) > 1 or
             (mesh.get(C.MESH_SEQUENCE_PARALLEL_SIZE) or 1) > 1,
             "tensor/sequence parallelism",
             "slice 6: parallel axes and comm extras"),
            (self.moe_config.expert_parallel_size > 1,
             "moe.expert_parallel_size > 1",
             "slice 6: parallel axes and comm extras"),
            (bool(ckpt.get(C.CHECKPOINT_ASYNC, C.CHECKPOINT_ASYNC_DEFAULT))
             or (ckpt.get(C.CHECKPOINT_SNAPSHOT_EVERY) or 0) > 0,
             "checkpoint (async / snapshot_every)", "slice 6: checkpointing"),
            (bool(d.get(C.FLOPS_PROFILER, {}).get(
                C.FLOPS_PROFILER_ENABLED, C.FLOPS_PROFILER_ENABLED_DEFAULT)),
             "flops_profiler", "slice 6: observability and tooling"),
            (bool(d.get(C.TELEMETRY, {}).get(
                C.TELEMETRY_ENABLED, C.TELEMETRY_ENABLED_DEFAULT)),
             "telemetry", "slice 6: observability and tooling"),
        ]
        return [(name, where) for on, name, where in checks if on]

    @property
    def precision_dtype(self) -> str:
        if self.bf16_enabled:
            return "bfloat16"
        if self.fp16_enabled:
            return "float16"
        return "float32"
