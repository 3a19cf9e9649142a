"""Batch-size elasticity calculator (port of
``deepspeed_tpu/elasticity/elasticity.py``).

Parity with reference ``elasticity/elasticity.py``: from a set of candidate
micro-batch sizes, an upper bound on the global batch, and device-count
bounds, find the global batch size whose set of compatible device counts is
maximal (candidate enumeration elasticity.py:61-121; scoring prefers more
device counts, then larger batch, elasticity.py:94-121; public entry
``compute_elastic_config`` elasticity.py:240-332). Pure math: "gpus"
reads as the data-parallel world size.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple, Union

from .config import (ElasticityConfig, ElasticityConfigError, ElasticityError,
                     ElasticityIncompatibleWorldSize)
from .. import constants as C
from ..utils.logging import logger

# Highly composite numbers: each has more divisors than any smaller positive
# integer, so batch = micro * HCN maximizes the count of compatible device
# counts. Same table the reference uses.
HCN_LIST = [
    1, 2, 4, 6, 12, 24, 36, 48, 60, 120, 180, 240, 360, 720, 840, 1260, 1680,
    2520, 5040, 7560, 10080, 15120, 20160, 25200, 27720, 45360, 50400,
]


def get_candidate_batch_sizes(base_list: List[int],
                              max_acceptable_batch_size: int) -> List[int]:
    """Largest batch ≤ max for each micro-batch base, scaled by an HCN."""
    candidate_batch_size = set()
    for base in base_list:
        if base >= max_acceptable_batch_size:
            candidate_batch_size.add(base)
            continue
        limit = max_acceptable_batch_size // base
        best = 1
        for hcn in HCN_LIST:
            if hcn > limit:
                break
            best = hcn
        candidate_batch_size.add(best * base)
    return sorted(candidate_batch_size)


def get_valid_gpus(batch_size: int, micro_batches: List[int],
                   min_valid_gpus: int, max_valid_gpus: int) -> List[int]:
    """All device counts g with some micro m s.t. g divides batch/m."""
    valid_gpus = set()
    for micro_batch in micro_batches:
        if batch_size % micro_batch != 0:
            continue
        max_gpus = batch_size // micro_batch
        if min_valid_gpus <= max_gpus <= max_valid_gpus:
            valid_gpus.add(max_gpus)
        for i in range(1, max_gpus // 2 + 1):
            if max_gpus % i == 0 and min_valid_gpus <= i <= max_valid_gpus:
                valid_gpus.add(i)
    return sorted(valid_gpus)


def get_best_candidates(candidate_batch_sizes: List[int], micro_batches: List[int],
                        min_gpus: int, max_gpus: int,
                        prefer_larger: bool = True) -> Tuple[int, List[int]]:
    max_valid_gpus = 0
    valid_gpus: List[int] = []
    final_batch_size = int(min(micro_batches))
    for batch_size in candidate_batch_sizes:
        current_valid_gpus = get_valid_gpus(batch_size, micro_batches, min_gpus, max_gpus)
        better_count = len(current_valid_gpus) > max_valid_gpus
        tie = len(current_valid_gpus) == max_valid_gpus
        prefer = prefer_larger and batch_size > final_batch_size
        if current_valid_gpus and (better_count or (tie and prefer)):
            max_valid_gpus = len(current_valid_gpus)
            valid_gpus = current_valid_gpus
            final_batch_size = batch_size
    return final_batch_size, valid_gpus


def _get_compatible_gpus_v01(micro_batches: List[int], max_acceptable_batch_size: int,
                             min_gpus: int, max_gpus: int,
                             prefer_larger: bool = True) -> Tuple[int, List[int]]:
    candidates = get_candidate_batch_sizes(micro_batches, max_acceptable_batch_size)
    return get_best_candidates(candidates, micro_batches, min_gpus, max_gpus, prefer_larger)


def elasticity_enabled(ds_config: Dict[str, Any]) -> bool:
    if C.ELASTICITY not in ds_config:
        return False
    return ds_config[C.ELASTICITY].get(C.ENABLED, C.ENABLED_DEFAULT)


def ensure_immutable_elastic_config(runtime_elastic_config_dict: Dict[str, Any]) -> None:
    """Verify the elastic config hasn't changed vs. the scheduler-stamped hash.

    Parity with elasticity.py:207-239: the scheduler records
    DEEPSPEED_ELASTICITY_CONFIG; a run under it must use the same config.
    """
    import os
    env_key = "DEEPSPEED_ELASTICITY_CONFIG"
    if env_key in os.environ:
        scheduler_dict = json.loads(os.environ[env_key])
        scheduler_hash = hashlib.sha1(
            json.dumps(scheduler_dict, sort_keys=True).encode()).hexdigest()
        runtime_hash = hashlib.sha1(
            json.dumps(runtime_elastic_config_dict, sort_keys=True).encode()).hexdigest()
        if scheduler_hash != runtime_hash:
            raise ElasticityConfigError(
                "Elastic config changed between scheduler and runtime: "
                f"{scheduler_dict} != {runtime_elastic_config_dict}")


def compute_elastic_config(ds_config: Union[str, Dict[str, Any]],
                           target_deepspeed_version: str,
                           world_size: int = 0) -> Tuple[int, List[int], Optional[int]]:
    """Main entry (elasticity.py:240-332).

    Returns (final_batch_size, valid_gpus, micro_batch_size-for-world_size).
    When ``world_size`` is 0 the micro batch is None (config-time query).
    """
    if isinstance(ds_config, str):
        ds_config = json.loads(ds_config)
    if not elasticity_enabled(ds_config):
        raise ElasticityError("Elasticity is not enabled in the given ds_config")

    elastic_config = ElasticityConfig(ds_config[C.ELASTICITY])
    if float(elastic_config.version) > C.LATEST_ELASTICITY_VERSION:
        raise ElasticityConfigError(
            f"Unsupported elasticity version {elastic_config.version}, latest is "
            f"{C.LATEST_ELASTICITY_VERSION}")
    ensure_immutable_elastic_config(ds_config[C.ELASTICITY])

    final_batch_size, valid_gpus = _get_compatible_gpus_v01(
        micro_batches=elastic_config.micro_batches,
        max_acceptable_batch_size=elastic_config.max_acceptable_batch_size,
        min_gpus=elastic_config.min_gpus,
        max_gpus=elastic_config.max_gpus,
        prefer_larger=elastic_config.prefer_larger_batch_size)
    final_batch_size = int(final_batch_size)

    if world_size > 0:
        if world_size not in valid_gpus:
            raise ElasticityIncompatibleWorldSize(
                f"World size ({world_size}) is not valid with the current list of "
                f"valid device counts: {valid_gpus}")
        # Largest compatible micro batch for this world size.
        micro_batch_size = None
        for mbsz in sorted(set(elastic_config.micro_batches), reverse=True):
            if final_batch_size // world_size % mbsz == 0:
                micro_batch_size = mbsz
                break
        if micro_batch_size is None:
            raise ElasticityError(
                f"No compatible micro batch for world size {world_size} and final "
                f"batch {final_batch_size} from {elastic_config.micro_batches}")
        return final_batch_size, valid_gpus, micro_batch_size

    return final_batch_size, valid_gpus, None
