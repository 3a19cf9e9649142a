"""ZeRO configuration (port of ``deepspeed_tpu/runtime/zero/config.py``).

Same fields, defaults, legacy bool form and ``ValueError`` messages as
the JAX package, so one ds_config dict parses to the same values in
both. On one card stages 0, 1 and 2 are the same arithmetic (there is
nothing to partition); the engine raises ``NotImplementedError`` for
stage 3 and ``cpu_offload``, which the port does not run yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .. import config_utils
from ... import constants as C


class ZeroConfig:
    def __init__(self, param_dict: Optional[Dict[str, Any]] = None):
        self.stage = C.ZERO_STAGE_DEFAULT
        self.contiguous_gradients = C.ZERO_CONTIGUOUS_GRADIENTS_DEFAULT
        self.reduce_scatter = C.ZERO_REDUCE_SCATTER_DEFAULT
        self.grad_sync = C.ZERO_GRAD_SYNC_DEFAULT
        self.prefetch_depth = C.ZERO_PREFETCH_DEPTH_DEFAULT
        self.dcn_compression = C.ZERO_DCN_COMPRESSION_DEFAULT
        self.reduce_bucket_size = C.ZERO_REDUCE_BUCKET_SIZE_DEFAULT
        self.allgather_partitions = C.ZERO_ALLGATHER_PARTITIONS_DEFAULT
        self.allgather_bucket_size = C.ZERO_ALLGATHER_BUCKET_SIZE_DEFAULT
        self.overlap_comm = C.ZERO_OVERLAP_COMM_DEFAULT
        self.load_from_fp32_weights = C.ZERO_LOAD_FROM_FP32_WEIGHTS_DEFAULT
        self.cpu_offload = C.ZERO_CPU_OFFLOAD_DEFAULT
        self.offload_bucket_size = C.ZERO_OFFLOAD_BUCKET_SIZE_DEFAULT
        self.offload_host_threads = C.ZERO_OFFLOAD_HOST_THREADS_DEFAULT
        self.elastic_checkpoint = C.ZERO_ELASTIC_CHECKPOINT_DEFAULT
        self.max_elements_per_comm = C.ZERO_MAX_ELEMENTS_PER_COMM_DEFAULT

        if param_dict is not None and C.ZERO_OPTIMIZATION in param_dict:
            zero_config_dict = param_dict[C.ZERO_OPTIMIZATION]
            if isinstance(zero_config_dict, bool):
                # Legacy: "zero_optimization": true → stage 1.
                zero_config_dict = {
                    C.ZERO_STAGE: 1 if zero_config_dict else 0
                }
            self._initialize(zero_config_dict)

    def _initialize(self, d: Dict[str, Any]) -> None:
        get = config_utils.get_scalar_param
        self.stage = get(d, C.ZERO_STAGE, C.ZERO_STAGE_DEFAULT)
        self.contiguous_gradients = get(d, C.ZERO_CONTIGUOUS_GRADIENTS,
                                        C.ZERO_CONTIGUOUS_GRADIENTS_DEFAULT)
        self.reduce_bucket_size = get(d, C.ZERO_REDUCE_BUCKET_SIZE,
                                      C.ZERO_REDUCE_BUCKET_SIZE_DEFAULT)
        self.reduce_scatter = get(d, C.ZERO_REDUCE_SCATTER,
                                  C.ZERO_REDUCE_SCATTER_DEFAULT)
        self.grad_sync = get(d, C.ZERO_GRAD_SYNC, C.ZERO_GRAD_SYNC_DEFAULT)
        if self.grad_sync not in C.ZERO_GRAD_SYNC_MODES:
            raise ValueError(
                f"{C.ZERO_GRAD_SYNC} must be one of "
                f"{C.ZERO_GRAD_SYNC_MODES}, got {self.grad_sync!r}")
        if not self.reduce_scatter and self.grad_sync == "explicit":
            raise ValueError(
                f"{C.ZERO_GRAD_SYNC}='explicit' requires "
                f"{C.ZERO_REDUCE_SCATTER}: true — reduce_scatter: false "
                "selects the dense all-reduce gradient path")
        self.prefetch_depth = get(d, C.ZERO_PREFETCH_DEPTH,
                                  C.ZERO_PREFETCH_DEPTH_DEFAULT)
        if not isinstance(self.prefetch_depth, int) \
                or self.prefetch_depth < 0:
            raise ValueError(
                f"{C.ZERO_PREFETCH_DEPTH} must be a non-negative int "
                f"(layers gathered ahead of use), got "
                f"{self.prefetch_depth!r}")
        self.dcn_compression = get(d, C.ZERO_DCN_COMPRESSION,
                                   C.ZERO_DCN_COMPRESSION_DEFAULT)
        if not isinstance(self.dcn_compression, bool):
            raise ValueError(
                f"{C.ZERO_DCN_COMPRESSION} must be a bool (compress the "
                f"inter-slice DCN gradient hop), got "
                f"{self.dcn_compression!r}")
        if self.dcn_compression and self.stage < 2:
            raise ValueError(
                f"{C.ZERO_DCN_COMPRESSION} requires ZeRO stage >= 2: the "
                "compressed DCN hop carries the 1/dp-sharded residual of "
                "the in-slice reduce-scatter, which only exists when "
                "grads are sharded")
        self.overlap_comm = get(d, C.ZERO_OVERLAP_COMM,
                                C.ZERO_OVERLAP_COMM_DEFAULT)
        self.allgather_partitions = get(d, C.ZERO_ALLGATHER_PARTITIONS,
                                        C.ZERO_ALLGATHER_PARTITIONS_DEFAULT)
        self.allgather_bucket_size = get(d, C.ZERO_ALLGATHER_BUCKET_SIZE,
                                         C.ZERO_ALLGATHER_BUCKET_SIZE_DEFAULT)
        self.load_from_fp32_weights = get(
            d, C.ZERO_LOAD_FROM_FP32_WEIGHTS,
            C.ZERO_LOAD_FROM_FP32_WEIGHTS_DEFAULT)
        self.cpu_offload = get(d, C.ZERO_CPU_OFFLOAD,
                               C.ZERO_CPU_OFFLOAD_DEFAULT)
        self.offload_bucket_size = get(d, C.ZERO_OFFLOAD_BUCKET_SIZE,
                                       C.ZERO_OFFLOAD_BUCKET_SIZE_DEFAULT)
        self.offload_host_threads = get(d, C.ZERO_OFFLOAD_HOST_THREADS,
                                        C.ZERO_OFFLOAD_HOST_THREADS_DEFAULT)
        self.elastic_checkpoint = get(d, C.ZERO_ELASTIC_CHECKPOINT,
                                      C.ZERO_ELASTIC_CHECKPOINT_DEFAULT)
        if not isinstance(self.offload_bucket_size, int) \
                or self.offload_bucket_size <= 0:
            raise ValueError(
                f"{C.ZERO_OFFLOAD_BUCKET_SIZE} must be a positive byte "
                f"count, got {self.offload_bucket_size!r}")
        if not isinstance(self.offload_host_threads, int) \
                or self.offload_host_threads < 0:
            raise ValueError(
                f"{C.ZERO_OFFLOAD_HOST_THREADS} must be a non-negative int "
                f"(0 = auto), got {self.offload_host_threads!r}")
        self.max_elements_per_comm = get(d, C.ZERO_MAX_ELEMENTS_PER_COMM,
                                         C.ZERO_MAX_ELEMENTS_PER_COMM_DEFAULT)
        if not isinstance(self.stage, int) or \
                not (0 <= self.stage <= C.MAX_STAGE_ZERO_OPTIMIZATION):
            raise ValueError(
                f"ZeRO stage must be an int in [0, "
                f"{C.MAX_STAGE_ZERO_OPTIMIZATION}], got {self.stage}")
        if self.stage >= 3 and not self.reduce_scatter:
            raise ValueError(
                f"{C.ZERO_REDUCE_SCATTER}: false does not compose with "
                "ZeRO stage 3 — sharded parameters require the gradient "
                "reduce-scattered back to the owning shard")

    def __repr__(self) -> str:
        return f"ZeroConfig({dict(self.__dict__)})"
