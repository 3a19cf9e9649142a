"""Wall-clock and throughput timers (port of
``deepspeed_tpu/utils/timer.py``).

``SynchronizedWallClockTimer``: named timers whose start/stop fence the
card's outstanding work with ``torch.cuda.synchronize``, since PyTorch
returns before the card finishes. ``ThroughputTimer``: samples/s with
warm-up steps; by default it fences only at the ends of its reporting
windows, so it adds no per-step sync. ``device_sync_count`` counts the
fences this process issued.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from .logging import logger

_SYNC_COUNT = 0


def device_sync_count() -> int:
    """Total ``torch.cuda.synchronize`` fences issued through this
    module by this process."""
    return _SYNC_COUNT


def _device_sync() -> None:
    """Block until all work queued on the card is complete (nothing to
    wait for without CUDA; the fence is counted either way)."""
    global _SYNC_COUNT
    _SYNC_COUNT += 1
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class SynchronizedWallClockTimer:
    """Named timer group with device-synchronized boundaries."""

    class Timer:
        def __init__(self, name: str):
            self.name_ = name
            self.elapsed_ = 0.0
            self.started_ = False
            self.start_time = 0.0
            self.count = 0

        def start(self, synchronize: bool = True) -> None:
            assert not self.started_, f"timer {self.name_} already started"
            if synchronize:
                _device_sync()
            self.start_time = time.time()
            self.started_ = True

        def stop(self, reset: bool = False, synchronize: bool = True) -> None:
            assert self.started_, f"timer {self.name_} not started"
            if synchronize:
                _device_sync()
            if reset:
                self.elapsed_ = time.time() - self.start_time
            else:
                self.elapsed_ += time.time() - self.start_time
            self.count += 1
            self.started_ = False

        def reset(self) -> None:
            self.elapsed_ = 0.0
            self.started_ = False
            self.count = 0

        def elapsed(self, reset: bool = True) -> float:
            started = self.started_
            count = self.count
            if started:
                self.stop(synchronize=False)
            elapsed = self.elapsed_
            if reset:
                self.reset()
            if started:
                # Mid-run query: restore count so mean() reflects only
                # real start/stop cycles.
                self.count = count
                self.start(synchronize=False)
            return elapsed

        def mean(self) -> float:
            return self.elapsed_ / max(1, self.count)

    def __init__(self):
        self.timers: Dict[str, SynchronizedWallClockTimer.Timer] = {}

    def __call__(self, name: str) -> "SynchronizedWallClockTimer.Timer":
        if name not in self.timers:
            self.timers[name] = self.Timer(name)
        return self.timers[name]

    def log(self, names: List[str], normalizer: float = 1.0,
            reset: bool = True) -> str:
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed = self.timers[name].elapsed(reset=reset) * 1000.0 \
                    / normalizer
                string += f" | {name}: {elapsed:.2f}"
        logger.info(string)
        return string


class ThroughputTimer:
    """Samples/s with warm-up. ``synchronized=True`` fences every step
    (the reference's wall_clock_breakdown); otherwise the timer fences
    only where a window of ``steps_per_output`` (default 100) steps
    closes and averages over it."""

    def __init__(self, batch_size: int, num_workers: int = 1,
                 start_step: int = 2, steps_per_output: Optional[int] = None,
                 logging_fn=None, synchronized: bool = False):
        self.start_time = 0.0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.num_workers = num_workers
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.counted_steps = 0
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or logger.info
        self.synchronized = synchronized
        self._window_len = steps_per_output or 100
        self._window_start: Optional[float] = None
        self._window_steps = 0

    def update_epoch_count(self) -> None:
        self.epoch_count += 1
        self.micro_step_count = 0

    def start(self) -> None:
        self.started = True
        if self.global_step_count < self.start_step:
            return
        if self.synchronized:
            _device_sync()
            self.start_time = time.time()
        elif self._window_start is None:
            _device_sync()
            self._window_start = time.time()
            self._window_steps = 0

    def stop(self, report_speed: bool = True) -> None:
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        self.global_step_count += 1
        if self.global_step_count <= self.start_step:
            return
        if self.synchronized:
            _device_sync()
            duration = time.time() - self.start_time
            self.total_elapsed_time += duration
            self.counted_steps += 1
            self._maybe_report(report_speed, duration)
        else:
            self._window_steps += 1
            boundary = self.global_step_count % self._window_len == 0
            if boundary and self._window_start is not None:
                _device_sync()
                duration = time.time() - self._window_start
                self.total_elapsed_time += duration
                self.counted_steps += self._window_steps
                self._window_start = None
                self._maybe_report(report_speed,
                                   duration / max(1, self._window_steps))

    def _maybe_report(self, report_speed: bool, step_duration: float) -> None:
        if report_speed and self.steps_per_output and \
                self.global_step_count % self.steps_per_output == 0:
            self.logging(
                f"epoch={self.epoch_count}/micro_step="
                f"{self.micro_step_count}/global_step="
                f"{self.global_step_count}, RunningAvgSamplesPerSec="
                f"{self.avg_samples_per_sec():.4f}, CurrSamplesPerSec="
                f"{self.batch_size * self.num_workers / max(step_duration, 1e-12):.4f}")

    def has_samples(self) -> bool:
        """True once at least one measurement window has closed."""
        return self.counted_steps > 0 and self.total_elapsed_time > 0

    def avg_samples_per_sec(self) -> float:
        if self.has_samples():
            samples_per_step = self.batch_size * self.num_workers
            avg_time_per_step = self.total_elapsed_time / self.counted_steps
            return samples_per_step / max(avg_time_per_step, 1e-12)
        return 0.0


__all__ = ["SynchronizedWallClockTimer", "ThroughputTimer",
           "device_sync_count"]
