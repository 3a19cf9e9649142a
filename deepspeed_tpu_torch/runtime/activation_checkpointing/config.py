"""The ``activation_checkpointing`` section of the ds_config (port of
``deepspeed_tpu/runtime/activation_checkpointing/config.py``): the same
keys and defaults. ``checkpointing.configure(deepspeed_config=...)``
reads ``partition_activations`` and ``cpu_checkpointing`` from it; the
other keys are parsed for parity.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .. import config_utils
from ... import constants as C


class ActivationCheckpointingConfig:
    def __init__(self, param_dict: Optional[Dict[str, Any]] = None):
        self.partition_activations = \
            C.ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT
        self.contiguous_memory_optimization = \
            C.ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT
        self.cpu_checkpointing = C.ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT
        self.number_checkpoints = C.ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT
        self.synchronize_checkpoint_boundary = \
            C.ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT
        self.profile = C.ACT_CHKPT_PROFILE_DEFAULT

        if param_dict is not None and C.ACTIVATION_CHECKPOINTING in param_dict:
            d = param_dict[C.ACTIVATION_CHECKPOINTING]
            get = config_utils.get_scalar_param
            self.partition_activations = get(
                d, C.ACT_CHKPT_PARTITION_ACTIVATIONS,
                C.ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT)
            self.contiguous_memory_optimization = get(
                d, C.ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION,
                C.ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT)
            self.cpu_checkpointing = get(
                d, C.ACT_CHKPT_CPU_CHECKPOINTING,
                C.ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT)
            self.number_checkpoints = get(
                d, C.ACT_CHKPT_NUMBER_CHECKPOINTS,
                C.ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT)
            self.synchronize_checkpoint_boundary = get(
                d, C.ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY,
                C.ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT)
            self.profile = get(d, C.ACT_CHKPT_PROFILE,
                               C.ACT_CHKPT_PROFILE_DEFAULT)

    def __repr__(self) -> str:
        return f"ActivationCheckpointingConfig({self.__dict__})"
