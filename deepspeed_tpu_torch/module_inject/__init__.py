"""Module injection — HF transformer weights into the port's stacked
blocks and back (port of ``deepspeed_tpu/module_inject``).

The JAX package maps HuggingFace *Flax* parameter trees; the port maps
HuggingFace *PyTorch* ``state_dict``s (flat dicts of tensors keyed by
dotted module paths) into the stacked block layout of
``models/transformer.py`` (one ``[L, ...]`` tensor per weight, matmul
kernels ``[in, out]``), and back exactly. Nothing here imports
``transformers``: configs are read by attribute and weights are plain
tensors, so a model built anywhere (or its saved ``state_dict``) feeds
it. A policy is a pure description of where each weight lives.
"""
from .replace import (bert_config_from_hf, extract_bert_encoder,
                      extract_gpt2_blocks, gpt2_config_from_hf,
                      restore_bert_encoder, restore_gpt2_blocks)
from .policy import (InjectionPolicy, detect_policy, get_policy,
                     register_policy, registered_policies, replace_module,
                     replace_subtrees)

__all__ = [
    "bert_config_from_hf", "extract_bert_encoder", "restore_bert_encoder",
    "gpt2_config_from_hf", "extract_gpt2_blocks", "restore_gpt2_blocks",
    "InjectionPolicy", "register_policy", "get_policy", "detect_policy",
    "registered_policies", "replace_module", "replace_subtrees",
]
