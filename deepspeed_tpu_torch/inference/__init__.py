"""inference/ — the serving tier of the port: the paged block pool, its
allocator and the slot-major layout (kv_cache.py), the decode / verify /
prefill paths (decode.py), the n-gram drafter (spec.py), continuous
batching (scheduler.py), weight quantization (quantize.py), the
InferenceEngine tying them together (engine.py) and the prefix-affinity
replica router (router.py).
"""
from .engine import InferenceEngine
from .kv_cache import (BlockAllocator, KVCacheSpec, PagedKVCacheSpec,
                       PoolExhausted, init_cache, init_paged_cache)
from .quantize import dequantize, quantize_params
from .router import ReplicaRouter
from .scheduler import (ContinuousBatchingScheduler, Request,
                        shared_prefix_requests, synthetic_requests)
from .spec import NGramDrafter

__all__ = [
    "InferenceEngine", "KVCacheSpec", "PagedKVCacheSpec",
    "BlockAllocator", "PoolExhausted", "init_cache", "init_paged_cache",
    "quantize_params", "dequantize", "Request", "synthetic_requests",
    "shared_prefix_requests", "ContinuousBatchingScheduler",
    "ReplicaRouter", "NGramDrafter",
]
