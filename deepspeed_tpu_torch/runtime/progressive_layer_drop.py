"""Progressive layer drop (port of
``deepspeed_tpu/runtime/progressive_layer_drop.py``).

The keep probability at global step t is ``theta(t) = (1 - theta_f) *
exp(-gamma * t) + theta_f``, computed on the host from the int step (the
engine passes ``theta_at(global_steps)`` to a loss that takes
``pld_theta``); ``models/transformer.apply_blocks`` keeps layer l with
probability ``1 - (l+1)/L * (1 - theta)``.
"""
from __future__ import annotations

import math


class ProgressiveLayerDrop:
    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def theta_at(self, step: int) -> float:
        """The keep probability at global step ``step`` (fp64)."""
        return (1.0 - self.theta) * math.exp(-self.gamma * int(step)) + \
            self.theta

    def update_state(self, global_step: int) -> None:
        self.current_theta = self.theta_at(global_step)

    def get_state(self) -> dict:
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self) -> float:
        return self.current_theta
