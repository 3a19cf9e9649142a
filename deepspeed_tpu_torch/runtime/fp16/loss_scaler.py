"""Loss scaling (port of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

``LossScaleState`` keeps the scale, the growth count and the hysteresis
as device tensors, and ``update_loss_scale`` updates them with
``torch.where`` only, as the JAX train step does in-graph: the overflow
vote never leaves the device, so a step costs no host sync. The
``LossScaler`` / ``DynamicLossScaler`` classes are the reference's
host-side API on Python floats.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch


class LossScaleState(NamedTuple):
    loss_scale: torch.Tensor      # f32 scalar
    growth_count: torch.Tensor    # i32: clean steps since last change
    hysteresis: torch.Tensor      # i32: remaining tolerated overflows
    dynamic: bool
    scale_window: int
    min_scale: float
    hysteresis_init: int
    scale_factor: float


def make_loss_scale_state(initial_scale: float = 2.0 ** 32,
                          dynamic: bool = True, scale_window: int = 1000,
                          min_scale: float = 1.0, hysteresis: int = 2,
                          scale_factor: float = 2.0,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> LossScaleState:
    return LossScaleState(
        loss_scale=torch.tensor(initial_scale, dtype=torch.float32,
                                device=device),
        growth_count=torch.tensor(0, dtype=torch.int32, device=device),
        hysteresis=torch.tensor(hysteresis, dtype=torch.int32,
                                device=device),
        dynamic=dynamic, scale_window=scale_window, min_scale=min_scale,
        hysteresis_init=hysteresis, scale_factor=scale_factor)


def update_loss_scale(state: LossScaleState,
                      overflow: torch.Tensor) -> LossScaleState:
    """The JAX ``update_loss_scale`` (reference loss_scaler.py:120-146):

    - overflow & hysteresis exhausted → scale = max(scale/factor, min)
    - overflow & hysteresis left → consume one hysteresis credit
    - clean step → growth_count+=1; at scale_window, scale *= factor and
      the hysteresis credits are restored
    """
    if not state.dynamic:
        return state
    overflow = overflow.to(torch.bool)
    scale, hys, growth = state.loss_scale, state.hysteresis, \
        state.growth_count
    hys_left = hys > 1
    new_scale_on_overflow = torch.where(
        hys_left, scale,
        torch.clamp_min(scale / state.scale_factor, state.min_scale))
    new_hys_on_overflow = torch.where(hys_left, hys - 1, hys)
    grown = (growth + 1) % state.scale_window == 0
    new_scale_clean = torch.where(grown, scale * state.scale_factor, scale)
    new_hys_clean = torch.where(grown, torch.full_like(
        hys, state.hysteresis_init), hys)
    return state._replace(
        loss_scale=torch.where(overflow, new_scale_on_overflow,
                               new_scale_clean),
        growth_count=torch.where(overflow, torch.zeros_like(growth),
                                 growth + 1).to(torch.int32),
        hysteresis=torch.where(overflow, new_hys_on_overflow,
                               new_hys_clean).to(torch.int32))


class LossScalerBase:
    def __init__(self, cur_scale: float):
        self.cur_scale = cur_scale

    @property
    def loss_scale(self) -> float:
        return self.cur_scale

    def update_scale(self, overflow: bool) -> None:
        pass

    def backward(self, loss):
        return loss * self.cur_scale


class LossScaler(LossScalerBase):
    """Static loss scale (reference loss_scaler.py:34)."""

    def __init__(self, scale: float = 1.0):
        super().__init__(scale)

    def has_overflow(self, params) -> bool:
        return False


class DynamicLossScaler(LossScalerBase):
    """Dynamic loss scale (reference loss_scaler.py:79), host-side."""

    def __init__(self, init_scale: float = 2.0 ** 32,
                 scale_factor: float = 2.0, scale_window: int = 1000,
                 min_scale: float = 1.0, delayed_shift: int = 1,
                 consecutive_hysteresis: bool = False):
        super().__init__(init_scale)
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = delayed_shift
        self.cur_hysteresis = delayed_shift
        self.consecutive_hysteresis = consecutive_hysteresis

    def update_scale(self, overflow: bool) -> None:
        if overflow:
            if self.delayed_shift == 1 or self.cur_hysteresis == 1:
                self.cur_scale = max(self.cur_scale / self.scale_factor,
                                     self.min_scale)
            else:
                self.cur_hysteresis -= 1
            self.last_overflow_iter = self.cur_iter
        else:
            if self.consecutive_hysteresis:
                self.cur_hysteresis = self.delayed_shift
            if (self.cur_iter - self.last_overflow_iter) % \
                    self.scale_window == 0:
                if not self.consecutive_hysteresis:
                    self.cur_hysteresis = self.delayed_shift
                self.cur_scale *= self.scale_factor
        self.cur_iter += 1


__all__ = ["LossScaleState", "make_loss_scale_state", "update_loss_scale",
           "LossScaler", "DynamicLossScaler"]
