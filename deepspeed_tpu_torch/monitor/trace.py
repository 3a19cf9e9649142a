"""Host-side span tracing: Chrome-trace/Perfetto JSON (port of
``deepspeed_tpu/monitor/trace.py``).

Spans are HOST wall-clock intervals (the launch of a step's kernels,
the host Adam, copies, checkpoint IO) recorded with two
``perf_counter`` reads, never a device fence: on the card a span of
``grad_compute`` is the time to queue its kernels, not their time on
the card (CUDA events or a profiler read that).

The output is the Chrome Trace Event format ("traceEvents" array of
complete/instant events), loadable in Perfetto (ui.perfetto.dev) or
chrome://tracing. The device-side view is ``ProfilerWindow``: a
``torch.profiler`` capture of N configured steps (the card's kernels on
their streams, with CUDA and CPU activities), which
``monitor/profile_ingest.py`` decomposes into per-step buckets.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from ..utils.logging import logger

# Stable lane (tid) assignment so related spans stack in one row each in
# the Perfetto UI; unknown span names land in lane 0.
_LANES = {
    "train_batch": 0, "data_prep": 1, "step_dispatch": 2,
    "grad_compute": 2, "grad_sync": 3, "optimizer_apply": 4,
    "offload_step": 2, "offload_d2h": 3, "offload_norm": 4,
    "offload_adam": 5, "offload_h2d": 6,
    "checkpoint_save": 7, "checkpoint_load": 7,
}


class TraceWriter:
    """Chrome-trace writer in the JSON **array** format: events append to
    the file incrementally at each flush (the buffer then clears, so
    memory and per-flush IO stay O(events-since-last-flush), not
    O(run-length)); the array stays unterminated until ``close()``, which
    the trace format explicitly permits — a crashed run's partial file
    still loads in Perfetto. Non-writer processes buffer nothing."""

    def __init__(self, path: str, is_writer: Optional[bool] = None,
                 per_host: bool = False, rank: Optional[int] = None,
                 world: Optional[int] = None):
        # Shared writer resolution (monitor/hostinfo.py — the one copy
        # of the process-0 guard); with per_host, non-zero ranks write
        # their own ``<trace>.rankK.<ext>`` shard.
        from .hostinfo import resolve_writer, shard_path
        self.is_writer, self.rank, self.world = resolve_writer(
            is_writer, per_host=per_host, rank=rank, world=world)
        self.path = shard_path(path, self.rank if self.is_writer else 0)
        self._events: List[Dict[str, Any]] = []
        self._file = None
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self.closed = False

    # ------------------------------------------------------------------ #
    def _ts_us(self, t_abs: float) -> float:
        return (t_abs - self._t0) * 1e6

    def lane(self, name: str) -> int:
        return _LANES.get(name, 0)

    def add_span(self, name: str, t_start: float, dur_s: float,
                 tid: Optional[int] = None,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record a completed span from absolute ``perf_counter`` seconds."""
        if self.closed or not self.is_writer:
            return
        ev = {"name": name, "ph": "X", "pid": self._pid,
              "tid": self.lane(name) if tid is None else tid,
              "ts": self._ts_us(t_start), "dur": max(0.0, dur_s * 1e6)}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, args: Optional[Dict[str, Any]] = None,
                t_abs: Optional[float] = None) -> None:
        if self.closed or not self.is_writer:
            return
        ev = {"name": name, "ph": "i", "s": "p", "pid": self._pid, "tid": 0,
              "ts": self._ts_us(time.perf_counter()
                                if t_abs is None else t_abs)}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def flow(self, name: str, flow_id: int, phase: str, t_abs: float,
             tid: int = 0, cat: str = "request") -> None:
        """Flow-event arrow (ph ``s``/``t``/``f``) linking spans across
        lanes — Perfetto draws one arrow chain per ``flow_id`` (e.g. a
        request's route→admit→first-token across replica tracks)."""
        if self.closed or not self.is_writer:
            return
        if phase not in ("s", "t", "f"):
            raise ValueError(f"flow phase must be s/t/f, got {phase!r}")
        ev = {"name": name, "cat": cat, "ph": phase, "id": int(flow_id),
              "pid": self._pid, "tid": tid, "ts": self._ts_us(t_abs)}
        if phase == "f":
            ev["bp"] = "e"  # bind to the enclosing slice, not the next one
        with self._lock:
            self._events.append(ev)

    @contextmanager
    def span(self, name: str, **args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_span(name, t0, time.perf_counter() - t0,
                          args=args or None)

    # ------------------------------------------------------------------ #
    def flush(self) -> None:
        if not self.is_writer or self.closed:
            return
        with self._lock:
            events, self._events = self._events, []
        if not events:
            return
        if self._file is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._file = open(self.path, "w")
            self._file.write("[\n")
        for ev in events:
            self._file.write(json.dumps(ev) + ",\n")
        self._file.flush()

    def close(self) -> None:
        if self.closed:
            return
        self.flush()
        if self._file is not None:
            # Terminate the array with a sentinel (no trailing comma) so
            # the closed file is strict JSON; pre-close files are the
            # unterminated array form Perfetto accepts.
            self._file.write(json.dumps(
                {"name": "trace_end", "ph": "i", "s": "p",
                 "pid": self._pid, "tid": 0,
                 "ts": self._ts_us(time.perf_counter())}) + "]\n")
            self._file.close()
            self._file = None
        self.closed = True


class ProfilerWindow:
    """Capture a ``torch.profiler`` device trace for ``num_steps`` steps
    starting at ``start_step`` — the device-side complement to the host
    spans. ``tick(step)`` is two int compares on the hot path.

    Each window captures into its own ``step_<start>_<stop>`` suffix of
    ``out_dir`` (the trace is ``<host>.<pid>.trace.json`` there) so two
    windows in one run can never silently overwrite each other — a
    reused range is refused, not clobbered. Outcomes are surfaced as
    structured ``profile_window`` events through the ``on_event(kind,
    payload)`` callback (the telemetry JSONL), so downstream ingestion
    (monitor/profile_ingest.py) can locate the capture — or learn
    exactly why there isn't one — from the JSONL alone; log lines are a
    courtesy copy, not the record.

    ``device`` is the engine's: on a CUDA device the capture records CPU
    and CUDA activities, and ``stop`` waits for the card once (inside
    the window) so the last window step's kernels are in the trace; on
    the CPU it records CPU activities only. The profiler records the
    whole process: another engine's work inside the window is in the
    trace too.
    """

    # Capture dirs claimed by any window in this process — the
    # same-out_dir uniqueness assert for satellite windows.
    _claimed_dirs: set = set()

    def __init__(self, start_step: int, num_steps: int, out_dir: str,
                 on_event=None, device=None):
        self.start_step = int(start_step)
        self.stop_step = int(start_step) + max(1, int(num_steps))
        self.out_dir = out_dir
        # Step-range suffix: the actual capture destination.
        self.capture_dir = os.path.join(
            out_dir, f"step_{self.start_step}_{self.stop_step}")
        self.trace_file = os.path.join(
            self.capture_dir,
            f"{socket.gethostname()}.{os.getpid()}.trace.json")
        self.device = device
        self._on_event = on_event
        self._prof = None
        self._active = False
        self.failed = False

    def _on_cuda(self) -> bool:
        return getattr(self.device, "type", None) == "cuda"

    def _emit(self, phase: str, ok: bool, reason: Optional[str] = None,
              **extra) -> None:
        payload = {"phase": phase, "path": self.capture_dir,
                   "start_step": self.start_step,
                   "stop_step": self.stop_step, "ok": bool(ok)}
        if reason is not None:
            payload["reason"] = reason
        payload.update(extra)
        if self._on_event is not None:
            try:
                self._on_event("profile_window", payload)
            except Exception as e:  # never take down the step loop
                logger.warning(f"telemetry: profile_window event emit "
                               f"failed ({type(e).__name__}: {e})")

    def _claim_dir(self) -> None:
        """Refuse a capture dir another window already used (in-process
        set) or that already holds a capture on disk (cross-process) —
        the silent-overwrite hazard."""
        if self.capture_dir in ProfilerWindow._claimed_dirs:
            raise RuntimeError(
                f"duplicate profile capture dir {self.capture_dir!r} "
                f"(a window for this step range already ran)")
        if os.path.isdir(self.capture_dir) and os.listdir(self.capture_dir):
            raise RuntimeError(
                f"profile capture dir {self.capture_dir!r} is not empty "
                f"(refusing to overwrite an existing capture)")
        ProfilerWindow._claimed_dirs.add(self.capture_dir)

    def tick(self, step: int) -> None:
        if self.failed:
            return
        # Range check, not equality: a run resumed from a checkpoint past
        # start_step (the first tick arrives mid-window or later) must
        # still capture whatever remains of the window instead of
        # silently never profiling.
        if not self._active and self.start_step <= step < self.stop_step:
            try:
                import torch.profiler as tp
                self._claim_dir()
                os.makedirs(self.capture_dir, exist_ok=True)
                acts = [tp.ProfilerActivity.CPU]
                if self._on_cuda():
                    acts.append(tp.ProfilerActivity.CUDA)
                prof = tp.profile(activities=acts)
                prof.start()
                self._prof = prof
                self._active = True
                self._emit("start", ok=True, armed_at_step=int(step))
            except Exception as e:
                self.failed = True
                reason = f"{type(e).__name__}: {e}"
                self._emit("start", ok=False, reason=reason)
                logger.warning(f"telemetry: torch.profiler trace failed to "
                               f"start ({reason})")
        elif self._active and step >= self.stop_step:
            self.stop()

    def stop(self) -> None:
        if not self._active:
            return
        self._active = False
        prof, self._prof = self._prof, None
        try:
            if self._on_cuda():
                from ..utils.timer import _device_sync
                _device_sync(self.device)
            prof.stop()
            prof.export_chrome_trace(self.trace_file)
            self._emit("stop", ok=True)
            logger.info(f"telemetry: torch.profiler trace written to "
                        f"{self.trace_file}")
        except Exception as e:
            self.failed = True
            reason = f"{type(e).__name__}: {e}"
            self._emit("stop", ok=False, reason=reason)
            logger.warning(f"telemetry: torch.profiler trace failed to "
                           f"stop ({reason})")


__all__ = ["TraceWriter", "ProfilerWindow"]
