"""Learning-rate schedules (port of
``deepspeed_tpu/runtime/lr_schedules.py``): ``LRRangeTest``,
``OneCycle``, ``WarmupLR``, ``WarmupDecayLR``, selected by name with the
reference's param keys.

Every schedule is a pure function of the step (``lr_at``). A Python
``int`` step gives a Python float, by the same expressions as the JAX
package's host branch; a tensor step (the engine's on-device optimizer
count) gives an fp32 tensor on its device, by the expressions of the
JAX traced branch, so the engine reads the schedule without a host
sync.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import torch

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


def _f32(step: torch.Tensor) -> torch.Tensor:
    return step.to(torch.float32)


class _ScheduleBase:
    """Stateful wrapper around a pure step → lr function."""

    def __init__(self, optimizer=None, last_batch_iteration: int = -1):
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration

    def lr_at(self, step):
        raise NotImplementedError

    def as_schedule_fn(self) -> Callable[[Any], Any]:
        return self.lr_at

    def get_lr(self) -> List[float]:
        return [float(self.lr_at(max(0, self.last_batch_iteration)))]

    def step(self, last_batch_iteration: Optional[int] = None) -> None:
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration


class LRRangeTest(_ScheduleBase):
    """lr(t) = min_lr * (1 + (t/step_size) * step_rate), continuous or
    staircase."""

    def __init__(self, optimizer=None, lr_range_test_min_lr: float = 1e-3,
                 lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False,
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, last_batch_iteration)
        if lr_range_test_step_size <= 0:
            raise ValueError(f"step_size must be positive, got "
                             f"{lr_range_test_step_size}")
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def lr_at(self, step):
        if isinstance(step, torch.Tensor):
            ratio = _f32(step) / self.step_size
            if self.staircase:
                ratio = torch.floor(ratio)
        else:
            ratio = step / self.step_size
            if self.staircase:
                ratio = math.floor(ratio)
        return self.min_lr * (1.0 + ratio * self.step_rate)

    def get_lr(self) -> List[float]:
        return [float(self.lr_at(self.last_batch_iteration + 1))]


class OneCycle(_ScheduleBase):
    """1-cycle policy: min→max over the first phase, back down over the
    second, then decay below min. The momentum keys are accepted for
    ds_config compatibility; the fused Adam's betas stay fixed."""

    def __init__(self, optimizer=None, cycle_min_lr: float = 1e-3,
                 cycle_max_lr: float = 1e-2, decay_lr_rate: float = 0.0,
                 cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 cycle_first_stair_count: int = 0,
                 cycle_second_stair_count: Optional[int] = None,
                 decay_step_size: int = 0, cycle_momentum: bool = True,
                 cycle_min_mom: float = 0.85, cycle_max_mom: float = 0.99,
                 decay_mom_rate: float = 0.0,
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_step_size = cycle_first_step_size
        self.second_step_size = cycle_second_step_size or \
            cycle_first_step_size
        self.decay_step_size = decay_step_size
        self.total_cycle_size = self.first_step_size + self.second_step_size

    def _decay_interval(self, step):
        decay_iter = step - self.total_cycle_size + 1
        return decay_iter / max(1, self.decay_step_size)

    def lr_at(self, step):
        if isinstance(step, torch.Tensor):
            s = _f32(step)
            up = self.cycle_min_lr + (self.cycle_max_lr -
                                      self.cycle_min_lr) * (
                s / self.first_step_size)
            down = self.cycle_max_lr - (self.cycle_max_lr -
                                        self.cycle_min_lr) * (
                (s - self.first_step_size) / self.second_step_size)
            cyc = torch.where(s <= self.first_step_size, up, down)
            decayed = self.cycle_min_lr / (
                1.0 + self.decay_lr_rate * self._decay_interval(s))
            return torch.where(s < self.total_cycle_size, cyc, decayed)
        if step < self.total_cycle_size:
            if step <= self.first_step_size:
                return self.cycle_min_lr + (self.cycle_max_lr -
                                            self.cycle_min_lr) * (
                    step / self.first_step_size)
            return self.cycle_max_lr - (self.cycle_max_lr -
                                        self.cycle_min_lr) * (
                (step - self.first_step_size) / self.second_step_size)
        return self.cycle_min_lr / (
            1.0 + self.decay_lr_rate * self._decay_interval(step))


class WarmupLR(_ScheduleBase):
    """Warm up from min_lr to max_lr over warmup_num_steps, then hold;
    ``warmup_type`` 'log' (the default) or 'linear'."""

    def __init__(self, optimizer=None, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000,
                 warmup_type: str = WARMUP_LOG_RATE,
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lr = warmup_min_lr
        self.max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        if warmup_type not in (WARMUP_LOG_RATE, WARMUP_LINEAR_RATE):
            raise ValueError(f"Unknown warmup_type {warmup_type}")
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def _gamma(self, step):
        if isinstance(step, torch.Tensor):
            if self.warmup_type == WARMUP_LOG_RATE:
                return self.inverse_log_warm_up * torch.log(
                    _f32(torch.clamp_min(step, 0)) + 1.0)
            return _f32(step) / self.warmup_num_steps
        if self.warmup_type == WARMUP_LOG_RATE:
            return self.inverse_log_warm_up * math.log(max(0, step) + 1)
        return step / self.warmup_num_steps

    def lr_at(self, step):
        warm = self.min_lr + (self.max_lr - self.min_lr) * self._gamma(step)
        if isinstance(step, torch.Tensor):
            return torch.where(step < self.warmup_num_steps, warm,
                               torch.full_like(warm, self.max_lr))
        return warm if step < self.warmup_num_steps else self.max_lr


class WarmupDecayLR(WarmupLR):
    """WarmupLR followed by linear decay to min_lr at total_num_steps."""

    def __init__(self, optimizer=None, total_num_steps: int = 10000,
                 warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000,
                 warmup_type: str = WARMUP_LOG_RATE,
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr,
                         warmup_num_steps, warmup_type, last_batch_iteration)
        self.total_num_steps = total_num_steps

    def lr_at(self, step):
        warm = super().lr_at(step)
        denom = max(1.0, self.total_num_steps - self.warmup_num_steps)
        delta = self.max_lr - self.min_lr
        if isinstance(step, torch.Tensor):
            frac = (self.total_num_steps - _f32(step)) / denom
            decay = self.min_lr + delta * torch.clamp_min(frac, 0.0)
            return torch.where(step < self.warmup_num_steps, warm, decay)
        if step < self.warmup_num_steps:
            return warm
        frac = (self.total_num_steps - step) / denom
        return self.min_lr + delta * max(0.0, frac)


SCHEDULE_CLASSES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
}


def get_lr_schedule(name: str, params: Dict[str, Any],
                    optimizer=None) -> _ScheduleBase:
    """Instantiate a schedule by ds_config name with its param dict."""
    if name not in SCHEDULE_CLASSES:
        raise ValueError(f"Unknown lr schedule {name!r}; valid: "
                         f"{VALID_LR_SCHEDULES}")
    return SCHEDULE_CLASSES[name](optimizer=optimizer, **params)


__all__ = ["LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR",
           "get_lr_schedule", "VALID_LR_SCHEDULES"]
