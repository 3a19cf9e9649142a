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
# Blocks of features the port does not run yet. They parse to the JAX
# package's values; the engine raises NotImplementedError when one is
# enabled (DeepSpeedConfig.unported_features).
#############################################
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PLD_ENABLED = "enabled"
PLD_ENABLED_DEFAULT = False
PIPELINE = "pipeline"
PIPELINE_STAGES = "stages"
PIPELINE_STAGES_DEFAULT = None
MESH = "mesh"
MESH_MODEL_PARALLEL_SIZE = "model_parallel_size"
MESH_PIPE_PARALLEL_SIZE = "pipe_parallel_size"
MESH_SEQUENCE_PARALLEL_SIZE = "sequence_parallel_size"
CHECKPOINT = "checkpoint"
CHECKPOINT_ASYNC = "async"
CHECKPOINT_ASYNC_DEFAULT = False
CHECKPOINT_SNAPSHOT_EVERY = "snapshot_every"
CHECKPOINT_SNAPSHOT_EVERY_DEFAULT = 0
ELASTICITY = "elasticity"
ENABLED = "enabled"
ENABLED_DEFAULT = False
FLOPS_PROFILER = "flops_profiler"
FLOPS_PROFILER_ENABLED = "enabled"
FLOPS_PROFILER_ENABLED_DEFAULT = False
TELEMETRY = "telemetry"
TELEMETRY_ENABLED = "enabled"
TELEMETRY_ENABLED_DEFAULT = False

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
# Weight quantization at engine construction. The port runs "none" only.
INFERENCE_QUANTIZE = "quantize"
INFERENCE_QUANTIZE_DEFAULT = "none"
INFERENCE_QUANTIZE_MODES = ("none", "bf16", "int8")
# Prefill chunk length (0 = whole-prompt prefill, not ported).
INFERENCE_PREFILL_CHUNK = "prefill_chunk"
INFERENCE_PREFILL_CHUNK_DEFAULT = 32
# Paged KV cache page size in tokens (0 = slot-major layout, not ported).
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
# inference.slo — parsed and validated, not acted on by the port yet.
INFERENCE_SLO = "slo"
INFERENCE_SLO_TTFT_MS = "ttft_ms"
INFERENCE_SLO_TTFT_MS_DEFAULT = 0.0
INFERENCE_SLO_TPOT_MS = "tpot_ms"
INFERENCE_SLO_TPOT_MS_DEFAULT = 0.0
INFERENCE_SLO_AVAILABILITY = "availability"
INFERENCE_SLO_AVAILABILITY_DEFAULT = 0.99
INFERENCE_SLO_WINDOW_S = "window_s"
INFERENCE_SLO_WINDOW_S_DEFAULT = 60.0
