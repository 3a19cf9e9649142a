"""Generic policy-driven module replacement (port of
``deepspeed_tpu/module_inject/policy.py``).

The reference's ``replace_module(model, orig_class, replace_fn)`` walks
a torch module tree and swaps the instances a policy matches. Here, as
in the JAX package, a "module" is a weight subtree plus an apply
function, so a policy is four pure functions:

  detect(hf_config)              -> does this policy own the architecture?
  config_from_hf(hf_config)      -> TransformerConfig for the blocks
  extract(state_dict)            -> stacked [L, ...] block params
  restore(stacked, state_dict)   -> a NEW state_dict (the reverse copy)

``replace_module`` is the user entry point: detect (or name) a policy,
return ``(cfg, stacked, restore_fn)``. ``replace_subtrees`` is the
low-level tree walker — the functional analogue of the reference's
recursive ``_replace_module`` — for subtree-level surgery on a nested
dict of weights.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.logging import logger


@dataclasses.dataclass(frozen=True)
class InjectionPolicy:
    """One architecture's injection recipe (reference HFBertLayerPolicy
    et al., module_inject/replace_policy.py)."""
    name: str
    detect: Callable[[Any], bool]
    config_from_hf: Callable[[Any], Any]
    extract: Callable[[Dict[str, Any]], Dict[str, Any]]
    restore: Callable[[Dict[str, Any], Dict[str, Any]], Dict[str, Any]]


_REGISTRY: "OrderedDict[str, InjectionPolicy]" = OrderedDict()


def register_policy(policy: InjectionPolicy, override: bool = False) -> None:
    """Add an architecture policy. Registration order is detection order
    (first match wins), so register more specific policies first."""
    if policy.name in _REGISTRY and not override:
        raise ValueError(f"injection policy '{policy.name}' already "
                         "registered (pass override=True to replace it)")
    _REGISTRY[policy.name] = policy


def get_policy(name: str) -> InjectionPolicy:
    if name not in _REGISTRY:
        raise KeyError(f"no injection policy '{name}'; registered: "
                       f"{list(_REGISTRY)}")
    return _REGISTRY[name]


def registered_policies() -> List[str]:
    return list(_REGISTRY)


def detect_policy(hf_config) -> InjectionPolicy:
    """First registered policy whose ``detect`` accepts the config."""
    for pol in _REGISTRY.values():
        if pol.detect(hf_config):
            return pol
    raise ValueError(
        f"no registered injection policy matches config "
        f"{type(hf_config).__name__} (model_type="
        f"{getattr(hf_config, 'model_type', None)!r}); registered: "
        f"{list(_REGISTRY)}. Register one with "
        "deepspeed_tpu_torch.module_inject.register_policy")


def replace_module(hf_config, hf_params: Dict[str, Any],
                   policy: Optional[Any] = None
                   ) -> Tuple[Any, Dict[str, Any], Callable]:
    """Swap an HF model's transformer layers for the port's blocks.

    The generic entry the reference exposes as ``replace_module``:
    ``policy`` may be a registry name, an InjectionPolicy, or None
    (auto-detect from ``hf_config``); ``hf_params`` is the model's
    ``state_dict``. Returns ``(cfg, stacked, restore_fn)`` where
    ``restore_fn(new_stacked)`` rebuilds the ``state_dict`` (the reverse
    copy).
    """
    if policy is None:
        pol = detect_policy(hf_config)
    elif isinstance(policy, str):
        pol = get_policy(policy)
    else:
        pol = policy
    logger.info(f"module_inject: applying policy '{pol.name}'")
    cfg = pol.config_from_hf(hf_config)
    stacked = pol.extract(hf_params)

    def restore_fn(new_stacked: Dict[str, Any]) -> Dict[str, Any]:
        return pol.restore(new_stacked, hf_params)

    return cfg, stacked, restore_fn


def replace_subtrees(tree: Dict[str, Any],
                     policies: List[Tuple[Callable, Callable]]
                     ) -> Dict[str, Any]:
    """Recursive subtree replacement over a nested-dict param tree — the
    functional analogue of the reference's ``_replace_module``
    (replace_module.py:175-192, named_children recursion + setattr).

    ``policies``: list of ``(match_fn, replace_fn)``; ``match_fn(path,
    subtree) -> bool`` with ``path`` a '/'-joined key string, and
    ``replace_fn(subtree) -> new_subtree``. First matching policy wins and
    its result is NOT recursed into. Returns a new tree (input unmutated).
    """
    def walk(node, path):
        for match_fn, replace_fn in policies:
            if match_fn(path, node):
                return replace_fn(node)
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        return node

    return walk(tree, "")


# --------------------------------------------------------------------- #
# Built-in policies (the round-4 hand-written mappings, now registered
# through the mechanism they predated).
# --------------------------------------------------------------------- #
def _model_type(hf_config) -> str:
    return str(getattr(hf_config, "model_type", "") or "").lower()


def _register_builtins() -> None:
    from .replace import (bert_config_from_hf, extract_bert_encoder,
                          gpt2_config_from_hf, extract_gpt2_blocks,
                          restore_bert_encoder, restore_gpt2_blocks)

    register_policy(InjectionPolicy(
        name="bert",
        detect=lambda c: _model_type(c) == "bert",
        config_from_hf=bert_config_from_hf,
        extract=extract_bert_encoder,
        restore=restore_bert_encoder))

    # RoBERTa's encoder keys are BERT's (encoder.layer.N.attention...);
    # only the embedding front differs
    # (+2 reserved positions, handled by SparseAttentionUtils.
    # extend_position_embedding). Registered as its own policy so
    # detection, error messages, and future divergence stay per-arch.
    register_policy(InjectionPolicy(
        name="roberta",
        detect=lambda c: _model_type(c) == "roberta",
        config_from_hf=bert_config_from_hf,
        extract=extract_bert_encoder,
        restore=restore_bert_encoder))

    register_policy(InjectionPolicy(
        name="gpt2",
        detect=lambda c: _model_type(c) == "gpt2",
        config_from_hf=gpt2_config_from_hf,
        extract=extract_gpt2_blocks,
        restore=restore_gpt2_blocks))


_register_builtins()
