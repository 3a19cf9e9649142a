"""Host-side span tracing: Chrome-trace/Perfetto JSON (port of
``deepspeed_tpu/monitor/trace.py``).

Spans are HOST wall-clock intervals (the launch of a step's kernels,
the host Adam, copies, checkpoint IO) recorded with two
``perf_counter`` reads, never a device fence: on the card a span of
``grad_compute`` is the time to queue its kernels, not their time on
the card (CUDA events or a profiler read that).

The output is the Chrome Trace Event format ("traceEvents" array of
complete/instant events), loadable in Perfetto (ui.perfetto.dev) or
chrome://tracing. ``ProfilerWindow`` (a device-trace capture window,
ingested into a per-step decomposition in JAX) is not ported: arming
one raises (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

# Stable lane (tid) assignment so related spans stack in one row each in
# the Perfetto UI; unknown span names land in lane 0.
_LANES = {
    "train_batch": 0, "data_prep": 1, "step_dispatch": 2,
    "grad_compute": 2, "grad_sync": 3, "optimizer_apply": 4,
    "offload_step": 2, "offload_d2h": 3, "offload_norm": 4,
    "offload_adam": 5, "offload_h2d": 6,
    "checkpoint_save": 7, "checkpoint_load": 7,
}

PROFILE_WINDOW_UNPORTED = (
    "telemetry.profile windows (a device-trace capture ingested into the "
    "per-step decomposition and reconciled with the cost model) are not "
    "ported yet (ROADMAP queue 1 item 9: monitor/profile_ingest.py and "
    "reconcile.py)")


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
    """The JAX capture window's place: building one raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(PROFILE_WINDOW_UNPORTED)


__all__ = ["TraceWriter", "ProfilerWindow", "PROFILE_WINDOW_UNPORTED"]
