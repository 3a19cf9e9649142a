"""The hang watchdog (port of ``HangWatchdog`` from
``deepspeed_tpu/monitor/health.py``; the rest of the JAX module — the
grad taps, the anomaly detectors — is not ported yet). The checkpoint
writer (runtime/async_ckpt.py) arms one around each background write:
``pending`` names the write, ``beat`` arms the clock, ``disarm`` stands
it down when the write ends, and a write that outlasts the timeout
fires one all-thread stack dump. ``memory_sampler`` is optional here
(the JAX one samples the device's memory by default)."""
from __future__ import annotations

import faulthandler
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..utils.logging import logger


class HangWatchdog:
    """Daemon thread that fires when no step completes within
    ``max(min_timeout_s, factor * p95(recent step walls))``.

    Hot-path cost: ``pending()`` is one attribute store at dispatch,
    ``beat()`` is a deque append + two stores at completion. The thread
    samples device memory and dumps stacks only when it FIRES."""

    def __init__(self, factor: float = 10.0, min_timeout_s: float = 120.0,
                 poll_s: Optional[float] = None,
                 on_fire: Optional[Callable[[Dict[str, Any]], None]] = None,
                 dump_dir: Optional[str] = None, window: int = 64,
                 memory_sampler: Optional[Callable] = None):
        self.factor = float(factor)
        self.min_timeout_s = float(min_timeout_s)
        self.poll_s = float(poll_s) if poll_s is not None \
            else max(0.05, self.min_timeout_s / 4.0)
        self.on_fire = on_fire
        self.dump_dir = dump_dir or "."
        self._walls: deque = deque(maxlen=int(window))
        self._last_beat = time.perf_counter()
        self._pending: Optional[str] = None
        self._armed = True
        self.fires = 0
        self.events: List[Dict[str, Any]] = []
        self._memory_sampler = memory_sampler
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -------------------------- hot path ----------------------------- #
    def pending(self, name: str) -> None:
        """A step function is dispatching — remember its signature so a
        fire can name what the run was stuck on."""
        self._pending = name

    def beat(self, wall_s: Optional[float] = None) -> None:
        """A step completed: record its wall, reset the clock, re-arm."""
        if wall_s is not None and wall_s > 0.0:
            self._walls.append(float(wall_s))
        self._last_beat = time.perf_counter()
        self._armed = True

    def disarm(self) -> None:
        """Stand down until the next beat(). For bounded-duration guards
        (the async checkpoint writer arms at write start and disarms at
        completion) where silence between work items is legitimate, not
        a hang."""
        self._armed = False

    # -------------------------- thread ------------------------------- #
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ds-hang-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2 * self.poll_s + 1.0)

    def _p95_wall(self) -> Optional[float]:
        """Nearest-rank p95 of the recent step walls (the ONE percentile
        rule the timeout and the fired event both report)."""
        if not self._walls:
            return None
        walls = sorted(self._walls)
        return walls[min(len(walls) - 1,
                         int(round(0.95 * (len(walls) - 1))))]

    def timeout_s(self) -> float:
        p95 = self._p95_wall()
        if p95 is None:
            return self.min_timeout_s
        return max(self.min_timeout_s, self.factor * p95)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            elapsed = time.perf_counter() - self._last_beat
            timeout = self.timeout_s()
            if self._armed and elapsed > timeout:
                self._armed = False   # once per stall; next beat re-arms
                self.fires += 1
                try:
                    event = self._fire(elapsed, timeout)
                except Exception as e:  # the watchdog must never kill
                    event = {"error": f"{type(e).__name__}: {e}"[:200],
                             "elapsed_s": round(elapsed, 3)}
                self.events.append(event)
                if self.on_fire is not None:
                    try:
                        self.on_fire(dict(event))
                    except Exception:
                        pass

    def _fire(self, elapsed: float, timeout: float) -> Dict[str, Any]:
        dump_path = os.path.join(self.dump_dir, "watchdog_stacks.txt")
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            with open(dump_path, "w") as f:
                f.write(f"# hang watchdog fire #{self.fires}: no step in "
                        f"{elapsed:.1f}s (timeout {timeout:.1f}s), "
                        f"pending={self._pending}\n")
                faulthandler.dump_traceback(file=f, all_threads=True)
        except Exception as e:
            dump_path = f"<dump failed: {type(e).__name__}: {e}>"
        mem = None
        if self._memory_sampler is not None:
            try:
                mem = self._memory_sampler()
            except Exception:
                pass
        p95 = self._p95_wall()
        event = {
            "fire": self.fires,
            # No completed step yet => the run never got past warmup
            # (stuck compiling / first dispatch), a different diagnosis
            # than a steady-state hang.
            "phase": "steady" if self._walls else "startup",
            "pending_fn": self._pending,
            "elapsed_s": round(elapsed, 3),
            "timeout_s": round(timeout, 3),
            "p95_step_wall_s": round(p95, 4) if p95 is not None else None,
            "steps_observed": len(self._walls),
            "threads": threading.active_count(),
            "stack_dump_path": dump_path,
        }
        if isinstance(mem, dict):
            event["memory"] = {k: mem[k] for k in
                               ("bytes_in_use_max", "peak_bytes_in_use_max",
                                "num_devices") if k in mem}
        logger.warning(
            f"telemetry: hang watchdog fired — no step completed in "
            f"{elapsed:.1f}s (timeout {timeout:.1f}s, pending "
            f"{self._pending}); stacks dumped to {dump_path}")
        return event


__all__ = ["HangWatchdog"]
