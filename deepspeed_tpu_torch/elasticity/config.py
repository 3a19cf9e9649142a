"""Elasticity config (port of ``deepspeed_tpu/elasticity/config.py``).

Parity with reference ``elasticity/config.py``: fields enabled,
max_train_batch_size, micro_batch_sizes, min/max_gpus, min_time, version,
prefer_larger_batch, ignore_non_elastic_batch_info.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Union

from .. import constants as C


class ElasticityError(Exception):
    """Base elasticity error."""


class ElasticityConfigError(ElasticityError):
    """Invalid elasticity config."""


class ElasticityIncompatibleWorldSize(ElasticityError):
    """Current world size is not valid for the elastic config."""


class ElasticityConfig:
    """Controls batch-size elasticity.

    Example::

        "elasticity": {
            "enabled": true,
            "max_train_batch_size": 2000,
            "micro_batch_sizes": [2, 4, 6],
            "min_gpus": 1,
            "max_gpus": 10000,
            "min_time": 20,
            "version": 0.1
        }
    """

    def __init__(self, param_dict: Union[Dict[str, Any], str]):
        if isinstance(param_dict, str):
            param_dict = json.loads(param_dict)
        self.enabled = param_dict.get(C.ENABLED, C.ENABLED_DEFAULT)
        # Required keys: a typo'd key must fail loudly, not silently train
        # with default batch sizes (reference elasticity/config.py behavior).
        if C.MAX_ACCEPTABLE_BATCH_SIZE not in param_dict:
            raise ElasticityConfigError(
                f"Elasticity config missing required key '{C.MAX_ACCEPTABLE_BATCH_SIZE}'")
        if C.MICRO_BATCHES not in param_dict:
            raise ElasticityConfigError(
                f"Elasticity config missing required key '{C.MICRO_BATCHES}'")
        self.max_acceptable_batch_size = param_dict[C.MAX_ACCEPTABLE_BATCH_SIZE]
        self.micro_batches = param_dict[C.MICRO_BATCHES]
        if not isinstance(self.micro_batches, list) or len(self.micro_batches) == 0:
            raise ElasticityConfigError(
                f"'{C.MICRO_BATCHES}' must be a non-empty list, got {self.micro_batches}")
        if not all(isinstance(m, int) and m > 0 for m in self.micro_batches):
            raise ElasticityConfigError(
                f"'{C.MICRO_BATCHES}' must contain positive ints, got {self.micro_batches}")
        self.min_gpus = param_dict.get(C.MIN_GPUS, C.MIN_GPUS_DEFAULT)
        self.max_gpus = param_dict.get(C.MAX_GPUS, C.MAX_GPUS_DEFAULT)
        if self.min_gpus < 1 or self.max_gpus < self.min_gpus:
            raise ElasticityConfigError(
                f"Invalid gpu bounds: min_gpus={self.min_gpus}, max_gpus={self.max_gpus}")
        self.min_time = param_dict.get(C.MIN_TIME, C.MIN_TIME_DEFAULT)
        self.version = param_dict.get(C.VERSION, C.VERSION_DEFAULT)
        self.prefer_larger_batch_size = param_dict.get(
            C.PREFER_LARGER_BATCH, C.PREFER_LARGER_BATCH_DEFAULT)
        self.ignore_non_elastic_batch_info = param_dict.get(
            C.IGNORE_NON_ELASTIC_BATCH_INFO, C.IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT)

    def repr_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)
