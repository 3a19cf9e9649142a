"""Mixture-of-Experts (port of ``deepspeed_tpu/moe``, expert-parallel
size 1): the routed expert FFN that ``TransformerConfig.moe`` puts in
place of a block's dense FFN."""
from .layer import (MOE_PARAM_KEYS, MoEConfig, aggregate_moe_stats,
                    expert_capacity, moe_ffn, moe_layer_indices, router_topk)

__all__ = ["MOE_PARAM_KEYS", "MoEConfig", "aggregate_moe_stats",
           "expert_capacity", "moe_ffn", "moe_layer_indices", "router_topk"]
