"""Runtime utilities (port of ``deepspeed_tpu/runtime/utils.py``: the
overflow test, global norms and gradient clipping).

All of them take a tree (nested dicts or sequences) of tensors and
return device tensors, so a caller that never reads them on the host
adds no sync. The engine's main path computes its norm, overflow vote
and clip coefficient inside the fused optimizer step
(``ops/fused_update.py``); these are the plain-PyTorch forms of the same
quantities, and ``clip_coefficient`` is the one expression both use.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in _leaves(t)]
    return []


def tree_has_inf_or_nan(tree: Any) -> torch.Tensor:
    """True iff any leaf holds an inf or a nan (a bool tensor)."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.tensor(False)
    flags = [torch.logical_not(torch.isfinite(l.float()).all())
             for l in leaves]
    return torch.stack(flags).any()


def global_norm(tree: Any, ord: int = 2) -> torch.Tensor:
    """L2 (or L1 / inf) norm over all leaves, in fp32."""
    leaves = [l.float() for l in _leaves(tree)]
    if not leaves:
        return torch.tensor(0.0)
    if ord == 2:
        return torch.sqrt(sum(torch.sum(l * l) for l in leaves))
    if ord == 1:
        return sum(torch.sum(torch.abs(l)) for l in leaves)
    return torch.max(torch.stack([torch.max(torch.abs(l)) for l in leaves]))


def clip_coefficient(total_norm: torch.Tensor,
                     max_norm: float) -> torch.Tensor:
    """The global-clip multiplier, ``min(1, clip/(norm+1e-6))``: the one
    definition the fused step and ``clip_grad_norm_`` share."""
    return torch.minimum(torch.ones_like(total_norm),
                         max_norm / (total_norm + 1e-6))


def clip_grad_norm_(grads: Any, max_norm: float, norm_type: int = 2,
                    precomputed_norm: Optional[torch.Tensor] = None
                    ) -> Tuple[Any, torch.Tensor]:
    """Return ``(clipped_grads, total_norm)``; the grads are not
    modified."""
    total_norm = precomputed_norm if precomputed_norm is not None \
        else global_norm(grads, ord=norm_type)
    coef = clip_coefficient(total_norm, max_norm)

    def clip(t):
        if isinstance(t, torch.Tensor):
            return (t.float() * coef).to(t.dtype)
        if isinstance(t, dict):
            return {k: clip(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(clip(v) for v in t)
        return t
    return clip(grads), total_norm


__all__ = ["tree_has_inf_or_nan", "global_norm", "clip_coefficient",
           "clip_grad_norm_"]
