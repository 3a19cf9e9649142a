"""Optimizer construction (port of ``deepspeed_tpu/ops/optimizers.py``).

The port has one optimizer path: Adam / AdamW as the fused one-pass
step (``ops/fused_update.FusedAdam``), which is also the JAX package's
default for the Adam family (``optimizer.params.fused`` on).
``adam_w_mode`` defaults as in the JAX package: decoupled decay for
AdamW, coupled L2 for Adam. Everything else raises
``NotImplementedError`` and names the ROADMAP slice that brings it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Union

from .. import constants as C
from .fused_update import FusedAdam

ScheduleOrFloat = Union[Callable, float]


def _common(params: Dict[str, Any]):
    lr = params.get("lr", 1e-3)
    betas = params.get("betas", (0.9, 0.999))
    eps = params.get("eps", 1e-8)
    weight_decay = params.get("weight_decay", 0.0)
    return lr, tuple(betas), eps, weight_decay


def build_optimizer(name: str, params: Dict[str, Any],
                    schedule_fn: ScheduleOrFloat = None) -> FusedAdam:
    """Build the optimizer of a ds_config ``optimizer`` section.
    ``schedule_fn`` (step -> lr) overrides the static ``lr``."""
    name = name.lower()
    lr, betas, eps, weight_decay = _common(params)
    learning_rate = schedule_fn if schedule_fn is not None else lr
    if name in (C.ADAM_OPTIMIZER, C.ADAMW_OPTIMIZER):
        if not params.get(C.OPTIMIZER_FUSED, C.OPTIMIZER_FUSED_DEFAULT):
            raise NotImplementedError(
                "optimizer.params.fused: false — the port runs Adam only as "
                "its fused one-pass kernels and has no unfused optimizer "
                "path (ROADMAP: not planned); drop the key or set it true")
        adam_w_mode = params.get("adam_w_mode", name == C.ADAMW_OPTIMIZER)
        return FusedAdam(learning_rate, b1=betas[0], b2=betas[1], eps=eps,
                         weight_decay=weight_decay, adam_w_mode=adam_w_mode)
    if name == C.ONEBIT_ADAM_OPTIMIZER:
        raise NotImplementedError(
            "OnebitAdam is not ported yet (ROADMAP slice 6: parallel axes "
            "and comm extras)")
    raise NotImplementedError(
        f"optimizer {name!r} is not ported yet: the port has Adam and "
        "AdamW (ROADMAP slice 6: the other optimizers)")


__all__ = ["build_optimizer"]
