"""ds_config keys and defaults used by the port: the training keys of the
one-card main path and the ``inference`` block.

Copied from ``deepspeed_tpu/constants.py`` so that the same ds_config
dicts parse to the same values in both packages; see that file for the
long-form description of each knob.
"""

#############################################
# Batch size
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer and LR scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = None
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
LEGACY_FUSION_DEFAULT = False
# optimizer.params.fused: the one-pass multi-tensor Adam apply (the
# port's fused_update kernels). The port has no other Adam path.
OPTIMIZER_FUSED = "fused"
OPTIMIZER_FUSED_DEFAULT = True
SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"
RMSPROP_OPTIMIZER = "rmsprop"
LION_OPTIMIZER = "lion"
DEEPSPEED_OPTIMIZERS = [ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER,
                        ONEBIT_ADAM_OPTIMIZER, SGD_OPTIMIZER,
                        ADAGRAD_OPTIMIZER, RMSPROP_OPTIMIZER, LION_OPTIMIZER]

#############################################
# Precision
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1

BF16 = "bf16"
BF16_ENABLED = "enabled"
BF16_ENABLED_DEFAULT = False
# Master-free bf16: params live in bf16 and the optimizer apply rounds
# stochastically.
BF16_STOCHASTIC_ROUNDING = "stochastic_rounding"
BF16_STOCHASTIC_ROUNDING_DEFAULT = False

AMP = "amp"
AMP_ENABLED = "enabled"
AMP_ENABLED_DEFAULT = False

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0
PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0
SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False

#############################################
# Sparse attention
#############################################
SPARSE_ATTENTION = "sparse_attention"
SPARSE_MODE = "mode"
SPARSE_MODE_DEFAULT = "fixed"
SPARSE_DENSE_MODE = "dense"
SPARSE_FIXED_MODE = "fixed"
SPARSE_VARIABLE_MODE = "variable"
SPARSE_BIGBIRD_MODE = "bigbird"
SPARSE_BSLONGFORMER_MODE = "bslongformer"
SPARSE_BLOCK = "block"
SPARSE_BLOCK_DEFAULT = 16
SPARSE_DIFFERENT_LAYOUT_PER_HEAD = "different_layout_per_head"
SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT = False
SPARSE_NUM_LOCAL_BLOCKS = "num_local_blocks"
SPARSE_NUM_LOCAL_BLOCKS_DEFAULT = 4
SPARSE_NUM_GLOBAL_BLOCKS = "num_global_blocks"
SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT = 1
SPARSE_ATTENTION_TYPE = "attention"
SPARSE_ATTENTION_TYPE_DEFAULT = "bidirectional"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION = "horizontal_global_attention"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT = False
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS = "num_different_global_patterns"
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT = 1
SPARSE_NUM_RANDOM_BLOCKS = "num_random_blocks"
SPARSE_NUM_RANDOM_BLOCKS_DEFAULT = 0
SPARSE_LOCAL_WINDOW_BLOCKS = "local_window_blocks"
SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT = [4]
SPARSE_GLOBAL_BLOCK_INDICES = "global_block_indices"
SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT = [0]
SPARSE_GLOBAL_BLOCK_END_INDICES = "global_block_end_indices"
SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT = None
SPARSE_NUM_SLIDING_WINDOW_BLOCKS = "num_sliding_window_blocks"
SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT = 3

#############################################
# Steps / logging
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False
MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False

#############################################
# ZeRO
#############################################
ZERO_OPTIMIZATION = "zero_optimization"
MAX_STAGE_ZERO_OPTIMIZATION = 3
ZERO_STAGE = "stage"
ZERO_STAGE_DEFAULT = 0
ZERO_CONTIGUOUS_GRADIENTS = "contiguous_gradients"
ZERO_CONTIGUOUS_GRADIENTS_DEFAULT = False
ZERO_REDUCE_BUCKET_SIZE = "reduce_bucket_size"
ZERO_REDUCE_BUCKET_SIZE_DEFAULT = 500_000_000
ZERO_REDUCE_SCATTER = "reduce_scatter"
ZERO_REDUCE_SCATTER_DEFAULT = True
ZERO_GRAD_SYNC = "grad_sync"
ZERO_GRAD_SYNC_DEFAULT = "auto"
ZERO_GRAD_SYNC_MODES = ("auto", "declarative", "explicit")
ZERO_PREFETCH_DEPTH = "prefetch_depth"
ZERO_PREFETCH_DEPTH_DEFAULT = 1
ZERO_DCN_COMPRESSION = "dcn_compression"
ZERO_DCN_COMPRESSION_DEFAULT = False
ZERO_OVERLAP_COMM = "overlap_comm"
ZERO_OVERLAP_COMM_DEFAULT = False
ZERO_ALLGATHER_PARTITIONS = "allgather_partitions"
ZERO_ALLGATHER_PARTITIONS_DEFAULT = True
ZERO_ALLGATHER_BUCKET_SIZE = "allgather_bucket_size"
ZERO_ALLGATHER_BUCKET_SIZE_DEFAULT = 500_000_000
ZERO_LOAD_FROM_FP32_WEIGHTS = "load_from_fp32_weights"
ZERO_LOAD_FROM_FP32_WEIGHTS_DEFAULT = True
ZERO_CPU_OFFLOAD = "cpu_offload"
ZERO_CPU_OFFLOAD_DEFAULT = False
ZERO_OFFLOAD_BUCKET_SIZE = "offload_bucket_size"
ZERO_OFFLOAD_BUCKET_SIZE_DEFAULT = 64 * 2 ** 20
ZERO_OFFLOAD_HOST_THREADS = "offload_host_threads"
ZERO_OFFLOAD_HOST_THREADS_DEFAULT = 0
ZERO_ELASTIC_CHECKPOINT = "elastic_checkpoint"
ZERO_ELASTIC_CHECKPOINT_DEFAULT = True
ZERO_MAX_ELEMENTS_PER_COMM = "max_elements_per_comm"
ZERO_MAX_ELEMENTS_PER_COMM_DEFAULT = 500_000_000

#############################################
# MoE (moe/): the ``moe`` block. The engine reads it for the metrics
# schema; the model side is TransformerConfig.moe (moe.MoEConfig, built
# with MoEConfig.from_ds_config). The port runs expert_parallel_size 1.
#############################################
MOE = "moe"
# 0 = MoE disabled (the block is inert).
MOE_NUM_EXPERTS = "num_experts"
MOE_NUM_EXPERTS_DEFAULT = 0
# Router top-k (1 or 2).
MOE_TOP_K = "top_k"
MOE_TOP_K_DEFAULT = 2
# Per-expert slot count C = ceil(capacity_factor * k * T / E); tokens
# beyond capacity drop to the residual path.
MOE_CAPACITY_FACTOR = "capacity_factor"
MOE_CAPACITY_FACTOR_DEFAULT = 1.25
MOE_AUX_LOSS_WEIGHT = "aux_loss_weight"
MOE_AUX_LOSS_WEIGHT_DEFAULT = 1e-2
MOE_Z_LOSS_WEIGHT = "z_loss_weight"
MOE_Z_LOSS_WEIGHT_DEFAULT = 1e-3
MOE_EXPERT_PARALLEL_SIZE = "expert_parallel_size"
MOE_EXPERT_PARALLEL_SIZE_DEFAULT = 1
# Parsed for ds_config parity: the port's expert FFN always runs as its
# grouped GEMM (the kernel on a CUDA device, its plain versions on the
# CPU); False has no CUDA path and raises there.
MOE_GROUPED_GEMM = "grouped_gemm"
MOE_GROUPED_GEMM_DEFAULT = "auto"

#############################################
# Progressive layer drop (runtime/progressive_layer_drop.py)
#############################################
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PLD_ENABLED = "enabled"
PLD_ENABLED_DEFAULT = False
PLD_THETA = "theta"
PLD_THETA_DEFAULT = 1.0
PLD_GAMMA = "gamma"
PLD_GAMMA_DEFAULT = 0.001

#############################################
# Activation checkpointing (runtime/activation_checkpointing/)
#############################################
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
ACT_CHKPT_PARTITION_ACTIVATIONS = "partition_activations"
ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT = False
ACT_CHKPT_NUMBER_CHECKPOINTS = "number_checkpoints"
ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT = None
ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION = "contiguous_memory_optimization"
ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT = False
ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY = "synchronize_checkpoint_boundary"
ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT = False
ACT_CHKPT_CPU_CHECKPOINTING = "cpu_checkpointing"
ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT = False
ACT_CHKPT_PROFILE = "profile"
ACT_CHKPT_PROFILE_DEFAULT = False

#############################################
# The pipeline block (runtime/pipe/, the JAX PipelineConfig's keys and
# defaults) and the mesh block. The mesh's other axes parse to the JAX
# package's values; the engine raises NotImplementedError when one the
# port does not run yet is enabled (DeepSpeedConfig.unported_features).
#############################################
PIPELINE = "pipeline"
PIPELINE_STAGES = "stages"
PIPELINE_STAGES_DEFAULT = None
PIPELINE_PARTITION = "partition"
PIPELINE_PARTITION_DEFAULT = "best"
PIPELINE_SEED_LAYERS = "seed_layers"
PIPELINE_SEED_LAYERS_DEFAULT = False
PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL = "activation_checkpoint_interval"
PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL_DEFAULT = None
PIPELINE_SCHEDULE = "schedule"
PIPELINE_SCHEDULE_DEFAULT = "gpipe"
MESH = "mesh"
MESH_MODEL_PARALLEL_SIZE = "model_parallel_size"
MESH_PIPE_PARALLEL_SIZE = "pipe_parallel_size"
MESH_SEQUENCE_PARALLEL_SIZE = "sequence_parallel_size"
# Multi-slice scale-out (ICI domains joined by DCN; parsed as the JAX
# MeshConfig.num_slices, above 1 refused).
MESH_NUM_SLICES = "slices"
MESH_NUM_SLICES_DEFAULT = 1
# The flops profiler (profiling/flops_profiler): one training step's
# per-module table at global step profile_step.
FLOPS_PROFILER = "flops_profiler"
FLOPS_PROFILER_ENABLED = "enabled"
FLOPS_PROFILER_ENABLED_DEFAULT = False
FLOPS_PROFILER_PROFILE_STEP = "profile_step"
FLOPS_PROFILER_PROFILE_STEP_DEFAULT = 1
FLOPS_PROFILER_MODULE_DEPTH = "module_depth"
FLOPS_PROFILER_MODULE_DEPTH_DEFAULT = -1
FLOPS_PROFILER_TOP_MODULES = "top_modules"
FLOPS_PROFILER_TOP_MODULES_DEFAULT = 1
FLOPS_PROFILER_DETAILED = "detailed"
FLOPS_PROFILER_DETAILED_DEFAULT = True

# Telemetry (monitor/): the JAX package's keys and defaults. Per-step
# records ride a ring buffer drained to JSONL at report boundaries.
TELEMETRY = "telemetry"
TELEMETRY_ENABLED = "enabled"
TELEMETRY_ENABLED_DEFAULT = False
TELEMETRY_OUTPUT_PATH = "output_path"
TELEMETRY_OUTPUT_PATH_DEFAULT = ""
TELEMETRY_JOB_NAME = "job_name"
TELEMETRY_JOB_NAME_DEFAULT = "DeepSpeedJobName"
# Ring capacity between drains (overflow drops the oldest records and
# the drain reports how many); drain cadence in steps (0 =
# steps_per_print); the Chrome-trace path ("" = no spans).
TELEMETRY_BUFFER_SIZE = "buffer_size"
TELEMETRY_BUFFER_SIZE_DEFAULT = 1024
TELEMETRY_REPORT_STEPS = "report_steps"
TELEMETRY_REPORT_STEPS_DEFAULT = 0
TELEMETRY_TRACE_PATH = "trace_path"
TELEMETRY_TRACE_PATH_DEFAULT = ""
# Recompile sentinel: a new argument signature on an instrumented step
# path after its warmup calls is an event (fail_on_recompile raises).
TELEMETRY_FAIL_ON_RECOMPILE = "fail_on_recompile"
TELEMETRY_FAIL_ON_RECOMPILE_DEFAULT = False
TELEMETRY_RECOMPILE_WARMUP = "recompile_warmup_calls"
TELEMETRY_RECOMPILE_WARMUP_DEFAULT = 2
# Device-memory watermark: peak > analytic * ratio + slack is an event.
TELEMETRY_MEMORY_WATERMARKS = "memory_watermarks"
TELEMETRY_MEMORY_WATERMARKS_DEFAULT = True
TELEMETRY_WATERMARK_RATIO = "watermark_ratio"
TELEMETRY_WATERMARK_RATIO_DEFAULT = 2.0
TELEMETRY_WATERMARK_SLACK_BYTES = "watermark_slack_bytes"
TELEMETRY_WATERMARK_SLACK_BYTES_DEFAULT = 256 * 2 ** 20
# The profiler capture window: the flat keys, and the nested block that
# wins over them (parsed and validated; arming a window is not ported).
TELEMETRY_PROFILE_START_STEP = "profile_start_step"
TELEMETRY_PROFILE_START_STEP_DEFAULT = -1
TELEMETRY_PROFILE_NUM_STEPS = "profile_num_steps"
TELEMETRY_PROFILE_NUM_STEPS_DEFAULT = 1
TELEMETRY_PROFILE_DIR = "profile_dir"
TELEMETRY_PROFILE_DIR_DEFAULT = ""
TELEMETRY_PROFILE = "profile"
TELEMETRY_PROFILE_BLOCK_START = "start_step"
TELEMETRY_PROFILE_BLOCK_START_DEFAULT = -1
TELEMETRY_PROFILE_BLOCK_STEPS = "window_steps"
TELEMETRY_PROFILE_BLOCK_STEPS_DEFAULT = 2
TELEMETRY_PROFILE_BLOCK_DIR = "out_dir"
TELEMETRY_PROFILE_BLOCK_DIR_DEFAULT = ""
TELEMETRY_PROFILE_THRESHOLD = "divergence_threshold"
TELEMETRY_PROFILE_THRESHOLD_DEFAULT = 3.0
TELEMETRY_PROFILE_HOST_FRAC = "host_frac"
TELEMETRY_PROFILE_HOST_FRAC_DEFAULT = 0.10
# The roofline cost model, built once at the first report boundary.
TELEMETRY_COST_MODEL = "cost_model"
TELEMETRY_COST_MODEL_DEFAULT = True
# Rank K > 0 writes <job>.rankK.jsonl instead of discarding its records.
TELEMETRY_PER_HOST = "per_host_shards"
TELEMETRY_PER_HOST_DEFAULT = False
# telemetry.health: the per-leaf grad tap, EWMA spike detection, the hang
# watchdog (off by default) and the crash flight recorder.
TELEMETRY_HEALTH = "health"
TELEMETRY_HEALTH_ENABLED = "enabled"
TELEMETRY_HEALTH_ENABLED_DEFAULT = True
TELEMETRY_HEALTH_GRAD_TAPS = "grad_taps"
TELEMETRY_HEALTH_GRAD_TAPS_DEFAULT = True
TELEMETRY_HEALTH_Z_THRESHOLD = "z_threshold"
TELEMETRY_HEALTH_Z_THRESHOLD_DEFAULT = 6.0
TELEMETRY_HEALTH_EWMA_ALPHA = "ewma_alpha"
TELEMETRY_HEALTH_EWMA_ALPHA_DEFAULT = 0.1
TELEMETRY_HEALTH_WARMUP_STEPS = "warmup_steps"
TELEMETRY_HEALTH_WARMUP_STEPS_DEFAULT = 20
TELEMETRY_HEALTH_WATCHDOG = "watchdog"
TELEMETRY_HEALTH_WATCHDOG_DEFAULT = False
TELEMETRY_HEALTH_WATCHDOG_FACTOR = "watchdog_factor"
TELEMETRY_HEALTH_WATCHDOG_FACTOR_DEFAULT = 10.0
TELEMETRY_HEALTH_WATCHDOG_MIN_S = "watchdog_min_s"
TELEMETRY_HEALTH_WATCHDOG_MIN_S_DEFAULT = 120.0
TELEMETRY_HEALTH_FLIGHT = "flight_recorder"
TELEMETRY_HEALTH_FLIGHT_DEFAULT = True
TELEMETRY_HEALTH_FLIGHT_PATH = "flight_path"
TELEMETRY_HEALTH_FLIGHT_PATH_DEFAULT = ""
TELEMETRY_HEALTH_FLIGHT_WINDOW = "flight_window"
TELEMETRY_HEALTH_FLIGHT_WINDOW_DEFAULT = 64
# The tensorboard block, an alias of telemetry as in the JAX package
# (``telemetry.enabled`` defaults to ``tensorboard.enabled``; an explicit
# telemetry key wins).
TENSORBOARD = "tensorboard"
TENSORBOARD_ENABLED = "enabled"
TENSORBOARD_ENABLED_DEFAULT = False
TENSORBOARD_OUTPUT_PATH = "output_path"
TENSORBOARD_OUTPUT_PATH_DEFAULT = ""
TENSORBOARD_JOB_NAME = "job_name"
TENSORBOARD_JOB_NAME_DEFAULT = "DeepSpeedJobName"

#############################################
# Checkpoint (runtime/async_ckpt.py and the engine's save/load): the
# JAX package's keys, defaults and on-disk layout.
#############################################
CHECKPOINT = "checkpoint"
CHECKPOINT_TAG_VALIDATION = "tag_validation"
CHECKPOINT_TAG_VALIDATION_DEFAULT = "Warn"
CHECKPOINT_TAG_VALIDATION_MODES = ["Warn", "Ignore", "Fail"]
# save_checkpoint() takes the in-step-window snapshot (the state copied
# to host memory) and hands serialization and the two-phase atomic
# commit to a background writer thread.
CHECKPOINT_ASYNC = "async"
CHECKPOINT_ASYNC_DEFAULT = False
# Auto-save cadence: > 0 saves a checkpoint (tag global_stepN) into
# `save_dir` every N completed steps from inside train_batch.
CHECKPOINT_SNAPSHOT_EVERY = "snapshot_every"
CHECKPOINT_SNAPSHOT_EVERY_DEFAULT = 0
# Directory for auto-saves and the SIGTERM final save. Required when
# snapshot_every > 0; enables the preemption handler when set.
CHECKPOINT_SAVE_DIR = "save_dir"
CHECKPOINT_SAVE_DIR_DEFAULT = ""
# SIGTERM handler: a final snapshot+commit when one isn't already in
# flight, then the signal goes on to the previous handler.
CHECKPOINT_PREEMPT_SAVE = "preempt_save"
CHECKPOINT_PREEMPT_SAVE_DEFAULT = True
# Snapshots allowed in the writer queue before the next save blocks
# (each is a full host copy of the state), and the watchdog timeout of
# each background write.
CHECKPOINT_MAX_PENDING = "max_pending_snapshots"
CHECKPOINT_MAX_PENDING_DEFAULT = 1
CHECKPOINT_WRITER_TIMEOUT_S = "writer_timeout_s"
CHECKPOINT_WRITER_TIMEOUT_S_DEFAULT = 300.0
# fsync blobs and directories at commit (durability across machine
# crashes; a process kill never needs it).
CHECKPOINT_FSYNC = "fsync"
CHECKPOINT_FSYNC_DEFAULT = False

#############################################
# Serving tier (deepspeed_tpu_torch/inference/)
#############################################
INFERENCE = "inference"
# Concurrent request slots.
INFERENCE_MAX_SLOTS = "max_slots"
INFERENCE_MAX_SLOTS_DEFAULT = 8
# KV-cache sequence capacity per slot; 0 = the model's max_seq_length.
INFERENCE_MAX_SEQ_LEN = "max_seq_len"
INFERENCE_MAX_SEQ_LEN_DEFAULT = 0
# Weight quantization at engine construction: none, bf16 or int8.
INFERENCE_QUANTIZE = "quantize"
INFERENCE_QUANTIZE_DEFAULT = "none"
INFERENCE_QUANTIZE_MODES = ("none", "bf16", "int8")
# Prefill chunk length (0 = whole-prompt prefill).
INFERENCE_PREFILL_CHUNK = "prefill_chunk"
INFERENCE_PREFILL_CHUNK_DEFAULT = 32
# Paged KV cache page size in tokens (0 = slot-major layout).
INFERENCE_BLOCK_SIZE = "block_size"
INFERENCE_BLOCK_SIZE_DEFAULT = 16
# Pool size in blocks; 0 = full provisioning (max_slots * max_seq_len /
# block_size).
INFERENCE_NUM_BLOCKS = "num_blocks"
INFERENCE_NUM_BLOCKS_DEFAULT = 0
# Speculative decoding: draft tokens per live slot (0 = off).
INFERENCE_SPEC_K = "spec_k"
INFERENCE_SPEC_K_DEFAULT = 0
# n-gram context length of the self-drafting proposer.
INFERENCE_SPEC_NGRAM = "spec_ngram"
INFERENCE_SPEC_NGRAM_DEFAULT = 3
# KV-pool storage dtype: "model" = the model compute dtype, or "bf16".
INFERENCE_KV_DTYPE = "kv_cache_dtype"
INFERENCE_KV_DTYPE_DEFAULT = "model"
INFERENCE_KV_DTYPE_MODES = ("model", "bf16")
# Replica label stamped on the aggregator snapshot ("" = unlabeled).
INFERENCE_REPLICA = "replica"
INFERENCE_REPLICA_DEFAULT = ""
# Paged-attention kernel knob. On a CUDA device the port always runs its
# kernel, so ``false`` there raises; on the CPU the plain version runs
# whatever the knob says.
INFERENCE_PAGED_KERNEL = "paged_kernel"
INFERENCE_PAGED_KERNEL_DEFAULT = "auto"
# inference.slo: TTFT/TPOT targets scored by the engine's SLOTracker.
INFERENCE_SLO = "slo"
INFERENCE_SLO_TTFT_MS = "ttft_ms"
INFERENCE_SLO_TTFT_MS_DEFAULT = 0.0
INFERENCE_SLO_TPOT_MS = "tpot_ms"
INFERENCE_SLO_TPOT_MS_DEFAULT = 0.0
INFERENCE_SLO_AVAILABILITY = "availability"
INFERENCE_SLO_AVAILABILITY_DEFAULT = 0.99
INFERENCE_SLO_WINDOW_S = "window_s"
INFERENCE_SLO_WINDOW_S_DEFAULT = 60.0

#############################################
# Elasticity (elasticity/, the DeepSpeedConfig pre-pass)
#############################################
ELASTICITY = "elasticity"
ENABLED = "enabled"
ENABLED_DEFAULT = False
MAX_ACCEPTABLE_BATCH_SIZE = "max_train_batch_size"
MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT = 2000
MICRO_BATCHES = "micro_batch_sizes"
MICRO_BATCHES_DEFAULT = [2, 4, 6]
MIN_GPUS = "min_gpus"
MIN_GPUS_DEFAULT = 1
MAX_GPUS = "max_gpus"
MAX_GPUS_DEFAULT = 10000
MIN_TIME = "min_time"
MIN_TIME_DEFAULT = 0
VERSION = "version"
VERSION_DEFAULT = 0.1
LATEST_ELASTICITY_VERSION = 0.1
IGNORE_NON_ELASTIC_BATCH_INFO = "ignore_non_elastic_batch_info"
IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT = False
PREFER_LARGER_BATCH = "prefer_larger_batch"
PREFER_LARGER_BATCH_DEFAULT = True
