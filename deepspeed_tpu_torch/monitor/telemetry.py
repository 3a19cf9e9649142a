"""Telemetry core: per-step records in a ring buffer, drained to JSONL at
report boundaries — with ZERO added host<->device syncs on the hot path
(port of ``deepspeed_tpu/monitor/telemetry.py``; same records, keys and
contract).

The hot-path contract (the engine's ``_maybe_log`` discipline, extended):

- ``record_step`` appends the step's metrics dict AS-IS to a bounded ring
  buffer. The metrics are device tensors whose kernels may still be
  queued — holding them costs a few bytes of device memory and waits on
  nothing.
- ``maybe_drain`` fires only at report boundaries (``report_steps``,
  default = ``steps_per_print``): ONE batched copy to the host of every
  buffered tensor (``_fetch``: one fp64 buffer a device, one
  ``.tolist()``), then JSONL writes, the memory-watermark sample, and
  the trace flush. Between boundaries the subsystem performs no device
  access of any kind.
- When the ring overflows before a drain, the OLDEST records drop and the
  drain's report record says how many (no silent truncation).

The JSONL stream is line records tagged by ``kind``:

- ``meta``   — once per run: dp, zero stage, precision, grad-sync mode,
  analytic wire bytes/step, analytic per-device model-state bytes.
- ``step``   — one per train step (loss, lr, loss_scale, overflow,
  grad_norm, wall_ms, wire_bytes, ``mfu`` once the cost model is armed,
  offload phase timings + overlap fraction when offloading).
- ``report`` — one per drain: samples/sec window, ``window_mfu``,
  skipped steps, device memory sample, the goodput ledger's settled
  window, dropped-record count.
- ``event``  — recompile sentinel hits, memory watermarks, anomaly and
  watchdog events (monitor/health.py), user events.
- ``cost_model`` — once per run (first report boundary): per-path
  roofline verdicts from the flops profiler's op walk of each path +
  the wire model (see monitor/cost_model.py).
- ``event`` ``profile`` — one per completed ``telemetry.profile`` capture
  window (``monitor/trace.py::ProfilerWindow``, a ``torch.profiler``
  trace), at the next report boundary: the per-step bucket
  decomposition of the window (monitor/profile_ingest.py) and, with the
  cost model armed, its reconciliation against the floors
  (monitor/reconcile.py), plus a ``reconcile_divergence`` event for
  each component past its threshold.
- ``final``  — the terminal drain marker ``close()`` writes. A run
  segment that ends WITHOUT one was truncated (crash, kill -9, lost
  machine) and ``tools/telemetry_report.py`` says so instead of
  presenting partial-window stats as a complete run.

Across processes: rank 0 writes the primary stream; with
``telemetry.per_host_shards`` every other process writes
``<job>.rankK.jsonl`` (monitor/hostinfo.py is the one writer resolver)
instead of the historical silent record drop, and the report tool
aggregates the shards (straggler skew, step-count/loss desync).

``tools/telemetry_report.py`` summarizes a stream into TELEMETRY.json.
"""
from __future__ import annotations

import atexit
import functools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .cost_model import mfu as _mfu_formula
from .flight import FlightRecorder
from .goodput import GoodputLedger, extract_step_info
from .health import HangWatchdog, HealthMonitor
from .hostinfo import resolve_writer, shard_path
from .memory import MemoryWatermark, analytic_state_bytes, device_memory_stats
from .peaks import ChipPeaks
from .profile_ingest import ingest
from .recompile import RecompileSentinel
from .reconcile import divergence_events, reconcile
from .trace import ProfilerWindow, TraceWriter
from ..utils.logging import log_dist, logger

# The metrics key the engine's grad tap rides under; popped from the
# record at drain time (provenance feeds anomaly events, not the
# per-step JSONL, which keeps its scalar-only shape).
HEALTH_TAP_KEY = "health_leaf_sq"


def _fetch(values: List[torch.Tensor]) -> List[Any]:
    """Host values of device tensors: each device's tensors flattened
    into one fp64 buffer (exact for the float, int32 and bool metrics)
    and copied to the host at once — one wait on the card a drain. A
    0-dim tensor comes back as a Python scalar of its kind, any other
    as a numpy array of its shape."""
    out: List[Any] = [None] * len(values)
    by_dev: Dict[Any, List[int]] = {}
    for i, v in enumerate(values):
        by_dev.setdefault(v.device, []).append(i)
    for dev, idxs in by_dev.items():
        flat = torch.cat([values[i].detach().reshape(-1).to(torch.float64)
                          for i in idxs]).tolist()
        off = 0
        for i in idxs:
            v = values[i]
            n = v.numel()
            chunk = flat[off:off + n]
            off += n
            if v.dtype == torch.bool:
                cast = [bool(x) for x in chunk]
            elif not v.is_floating_point():
                cast = [int(x) for x in chunk]
            else:
                cast = chunk
            out[i] = cast[0] if v.dim() == 0 else \
                np.asarray(cast).reshape(tuple(v.shape))
    return out


def _to_py(v: Any) -> Any:
    """Host-native scalar for JSON (called at drain time, post-sync)."""
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if isinstance(v, np.ndarray) and v.ndim == 0:
        return _to_py(v[()])
    if hasattr(v, "dtype") and getattr(v, "ndim", 1) == 0:
        return _to_py(np.asarray(v)[()])
    return v


class JsonlSink:
    """Line-JSON event sink with the resource story the old engine
    ``_Monitor`` lacked: process 0 writes the primary stream (every SPMD
    process used to append to the same file); with ``per_host`` every
    other process writes its own ``<job>.rankK.jsonl`` shard (the
    hostinfo resolver — no more silent record drop on non-writers);
    ``close()`` is idempotent, and an atexit hook closes stragglers.
    Tensorboard scalars ride along when the writer is importable."""

    def __init__(self, output_path: str, job_name: str,
                 tensorboard: bool = False, is_writer: Optional[bool] = None,
                 per_host: bool = False, rank: Optional[int] = None,
                 world: Optional[int] = None):
        self.is_writer, self.rank, self.world = resolve_writer(
            is_writer, per_host=per_host, rank=rank, world=world)
        self.closed = False
        self.jsonl = None
        self.writer = None
        self._lock = threading.Lock()   # watchdog events write off-thread
        out = output_path or "./runs"
        self.path = shard_path(os.path.join(out, f"{job_name}.jsonl"),
                               self.rank if self.is_writer else 0)
        if not self.is_writer:
            if self.world > 1 and not per_host:
                # The drop is a policy now, not an accident: say so once.
                logger.info(
                    f"telemetry: process {self.rank} discards step records "
                    f"(set telemetry.per_host_shards for a per-host JSONL "
                    f"shard)")
            return
        os.makedirs(out, exist_ok=True)
        self.jsonl = open(self.path, "a")
        if tensorboard and self.rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(log_dir=os.path.join(out, job_name))
            except Exception:
                self.writer = None
        atexit.register(self.close)

    def write(self, rec: Dict[str, Any]) -> None:
        if self.closed or self.jsonl is None:
            return
        with self._lock:
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()
        if self.writer is not None and rec.get("kind") == "step":
            step = int(rec.get("step", 0))
            for k, v in rec.items():
                if k not in ("kind", "step", "ts") and \
                        isinstance(v, (int, float)) and \
                        not isinstance(v, bool):
                    self.writer.add_scalar(f"Train/{k}", v, step)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        atexit.unregister(self.close)
        if self.jsonl is not None:
            self.jsonl.close()
            self.jsonl = None
        if self.writer is not None:
            try:
                self.writer.close()
            except Exception:
                pass
            self.writer = None


class Telemetry:
    """The engine-facing facade over the monitor subsystem. Disabled
    (default) it is inert: every hot-path method is a single attribute
    test, no files open, no wrapping happens."""

    def __init__(self, cfg, default_report_steps: int = 10,
                 meta: Optional[Dict[str, Any]] = None,
                 is_writer: Optional[bool] = None,
                 device: Optional[torch.device] = None):
        self.cfg = cfg
        # The engine's device: a capture window on a CUDA device records
        # the card's kernels too.
        self.device = device
        self.enabled = bool(getattr(cfg, "enabled", False))
        self.meta: Dict[str, Any] = dict(meta or {})
        self.step_provider: Callable[[], int] = lambda: -1
        self.sentinel: Optional[RecompileSentinel] = None
        self.tracer: Optional[TraceWriter] = None
        self.watermark: Optional[MemoryWatermark] = None
        self.sink: Optional[JsonlSink] = None
        self.ledger: Optional[GoodputLedger] = None
        self.health: Optional[HealthMonitor] = None
        self.watchdog: Optional[HangWatchdog] = None
        self.flight: Optional[FlightRecorder] = None
        self.profiler: Optional[ProfilerWindow] = None
        self.cost_model_payload: Optional[Dict[str, Any]] = None
        self._mfu_arm: Optional[Dict[str, Any]] = None
        self._compile_wall_seen = 0.0
        self._ckpt_depth = 0
        self.dropped_records = 0
        self.events: List[Dict[str, Any]] = []
        self._closed = False
        if not self.enabled:
            return
        # Goodput ledger: the first window opens NOW (engine init time
        # lands in its "other" bucket — honest, not hidden).
        self.ledger = GoodputLedger()
        self.report_steps = int(cfg.report_steps) or \
            max(1, int(default_report_steps))
        self._ring: deque = deque(maxlen=int(cfg.buffer_size))
        per_host = bool(getattr(cfg, "per_host_shards", False))
        self.sink = JsonlSink(cfg.output_path, cfg.job_name,
                              tensorboard=getattr(cfg, "tensorboard", False),
                              is_writer=is_writer, per_host=per_host)
        self.meta.setdefault("process_index", self.sink.rank)
        self.meta.setdefault("process_count", self.sink.world)
        # close() writes a terminal `final` record; the report tool uses
        # this capability flag to call a marker-less segment truncated.
        self.meta.setdefault("emits_final", True)
        if cfg.trace_path:
            self.tracer = TraceWriter(cfg.trace_path, is_writer=is_writer,
                                      per_host=per_host)
        # Non-writer processes keep the sentinel/watermark checks but
        # skip step-record collection entirely: buffering scalars and
        # batch-fetching them at drains only to feed a null sink would be
        # held memory and a pointless device round trip per boundary.
        self._collect = self.sink.is_writer or self.tracer is not None
        # With the cost model on, the sentinel walks each path's first
        # call through the flops profiler (the cost model's flops and
        # bytes; that call is already the path's cold one).
        walk_fn = None
        if getattr(cfg, "cost_model", True):
            from ..profiling.flops_profiler.profiler import walk as _walk

            def walk_fn(fn, args, kwargs):
                return _walk(fn, *args, **kwargs)
        self.sentinel = RecompileSentinel(
            warmup_calls=cfg.recompile_warmup_calls,
            fail_on_recompile=cfg.fail_on_recompile,
            on_event=self._on_recompile, walk_fn=walk_fn)
        # Health layer (monitor/health.py + flight.py): drain-time
        # anomaly detection, the hang watchdog, the crash flight
        # recorder. All host-side — the only device piece is the
        # engine's grad tap, which rides the ring like any other metric.
        hc = getattr(cfg, "health", None)
        if hc is not None and getattr(hc, "enabled", False):
            self.meta.setdefault("health_enabled", True)
            self.health = HealthMonitor(
                z_threshold=hc.z_threshold, ewma_alpha=hc.ewma_alpha,
                warmup_steps=hc.warmup_steps)
            if hc.watchdog:
                self.watchdog = HangWatchdog(
                    factor=hc.watchdog_factor,
                    min_timeout_s=hc.watchdog_min_s,
                    dump_dir=cfg.output_path or "./runs",
                    on_fire=lambda ev: self.event("watchdog", ev))
                self.watchdog.start()
            if hc.flight_recorder and self.sink.is_writer:
                # An explicit flight_path shards per rank too — with
                # per_host on, every rank persisting to ONE file would
                # let the last handler clobber the primary's postmortem.
                fpath = shard_path(
                    hc.flight_path or os.path.join(
                        cfg.output_path or "./runs", "FLIGHT.json"),
                    self.sink.rank)
                self.flight = FlightRecorder(
                    fpath, window=hc.flight_window,
                    snapshot_fn=self._flight_snapshot)
                fl = self.flight
                fl.ledger_peek = lambda: (self.ledger.peek()
                                          if self.ledger else {})
                fl.ledger_summary = lambda: (self.ledger.summary()
                                             if self.ledger else {})
                fl.ring_steps = lambda: [s for s, _, _, _ in self._ring]
                fl.health_summary = lambda: (self.health.summary()
                                             if self.health else {})
                fl.watchdog_fires = lambda: (self.watchdog.fires
                                             if self.watchdog else 0)
                fl.install(close_cb=self.close)
                self.meta.setdefault("flight_path", fpath)
        self._profile_out = cfg.profile_dir or os.path.join(
            cfg.output_path or "./runs", "torch_trace")
        self._profile_done: List[Dict[str, Any]] = []
        if int(cfg.profile_start_step) >= 0:
            self.profiler = ProfilerWindow(cfg.profile_start_step,
                                           cfg.profile_num_steps,
                                           self._profile_out,
                                           on_event=self._profiler_event,
                                           device=device)
        self._meta_written = False
        atexit.register(self.close)

    # ------------------------------------------------------------------ #
    # Hot path (per step): append-only, no device access
    # ------------------------------------------------------------------ #
    def record_step(self, step: int, metrics: Dict[str, Any],
                    **host_fields: Any) -> None:
        """Buffer one step's record. ``metrics`` values may be (and on the
        card are) device tensors; they are copied only at the next
        drain."""
        if not self.enabled:
            return
        if self.watchdog is not None:
            # Heartbeat BEFORE the collect gate: non-collecting SPMD
            # processes still want hang detection.
            w = host_fields.get("wall_ms")
            self.watchdog.beat(float(w) / 1e3
                               if isinstance(w, (int, float)) else None)
        if not self._collect:
            return
        if len(self._ring) == self._ring.maxlen:
            self.dropped_records += 1
        self._ring.append((int(step), time.time(), dict(metrics),
                           host_fields))

    def heartbeat(self) -> None:
        """Manual watchdog beat for loops that are legitimately idle
        (the serving scheduler waiting on open-loop arrivals is not a
        hang)."""
        if self.watchdog is not None:
            self.watchdog.beat(None)

    def set_tap_spec(self, spec) -> None:
        """Arm NaN/Inf provenance: the engine hands over the TapSpec
        decoding its ``health_leaf_sq`` grad tap."""
        if self.health is not None:
            self.health.spec = spec

    def profiler_tick(self, step: int) -> None:
        if self.profiler is not None:
            self.profiler.tick(step)

    def _profiler_event(self, kind: str, payload: Dict[str, Any]) -> None:
        """ProfilerWindow outcome callback: every start/stop lands in the
        JSONL as a structured ``profile_window`` event (host IO only —
        no device access); a successful stop queues the capture for
        ingestion at the next report boundary."""
        self.event(kind, payload)
        if payload.get("phase") == "stop" and payload.get("ok"):
            self._profile_done.append(dict(payload))

    def arm_profile_window(self, num_steps: int,
                           start_step: Optional[int] = None
                           ) -> Optional[str]:
        """Arm a ``torch.profiler`` capture window over ``num_steps`` hot
        steps starting at ``start_step`` (default: the next step).
        Returns the capture dir, or None when refused (telemetry off, or
        a previously armed window hasn't finished — windows never
        clobber each other)."""
        if not self.enabled:
            return None
        p = self.profiler
        if p is not None and not p.failed and \
                (p._active or self.step_provider() < p.stop_step):
            logger.warning("telemetry: profile window already armed for "
                           f"steps [{p.start_step}, {p.stop_step}); "
                           "refusing to replace it")
            return None
        start = int(self.step_provider() + 1 if start_step is None
                    else start_step)
        self.profiler = ProfilerWindow(start, int(num_steps),
                                       self._profile_out,
                                       on_event=self._profiler_event,
                                       device=self.device)
        return self.profiler.capture_dir

    def _drain_profiles(self) -> None:
        """Report-boundary ingestion of completed capture windows: parse
        the trace, decompose the step wall into buckets, reconcile
        against the cost model when one is armed, and write one
        ``profile`` event (+ any ``reconcile_divergence`` events) per
        window. Pure host-side parsing — no device access."""
        done, self._profile_done = self._profile_done, []
        for win in done:
            n_steps = max(1, int(win.get("stop_step", 1))
                          - int(win.get("start_step", 0)))
            try:
                decomp = ingest(win["path"], n_steps=n_steps)
            except Exception as e:
                self.event("profile", {
                    "window": win,
                    "error": f"ingest failed ({type(e).__name__}: {e})"})
                continue
            payload: Dict[str, Any] = {"window": win,
                                       "decomposition": decomp}
            if self.cost_model_payload is not None and \
                    "error" not in decomp:
                pc = getattr(self.cfg, "profile", None)
                recon = reconcile(
                    decomp, self.cost_model_payload,
                    threshold=getattr(pc, "divergence_threshold", 3.0),
                    host_frac=getattr(pc, "host_frac", 0.10))
                payload["reconciliation"] = recon
                self.event("profile", payload)
                for d in divergence_events(recon):
                    self.event("reconcile_divergence", d)
            else:
                self.event("profile", payload)

    def span(self, name: str, **args):
        """Host-span context manager. Feeds the trace writer (when a
        trace_path is set) and, for ``checkpoint_*`` spans, the goodput
        ledger's checkpoint bucket — outermost span only, so the
        pipeline engine's nested per-layer spans don't double-count.
        The async save path's ``checkpoint_snapshot`` span additionally
        files its wall under the ledger's ``checkpoint_snapshot``
        sub-figure — the exposed part of an async save."""
        bucket = "checkpoint" if name.startswith("checkpoint_") else None
        if self.tracer is None and (bucket is None or self.ledger is None):
            return nullcontext()
        sub = "checkpoint_snapshot" if name == "checkpoint_snapshot" \
            else None
        return self._span_ctx(name, bucket, args, sub=sub)

    @contextmanager
    def _span_ctx(self, name: str, bucket: Optional[str],
                  args: Dict[str, Any], sub: Optional[str] = None):
        outermost = False
        if bucket is not None and self.ledger is not None:
            outermost = self._ckpt_depth == 0
            self._ckpt_depth += 1
        t0 = time.perf_counter()
        try:
            if self.tracer is not None:
                with self.tracer.span(name, **args):
                    yield
            else:
                yield
        finally:
            if bucket is not None and self.ledger is not None:
                self._ckpt_depth -= 1
                if outermost:
                    self.ledger.note(bucket, time.perf_counter() - t0,
                                     sub=sub)

    def note_checkpoint_write_bg(self, seconds: float) -> None:
        """Background checkpoint-writer wall (called from the writer
        thread): reported in the ledger's overlapped ``checkpoint_write``
        figure, never charged against the window."""
        if self.ledger is not None:
            self.ledger.note_background("checkpoint_write", seconds)

    def add_span(self, name: str, t_start: float, dur_s: float,
                 args: Optional[Dict[str, Any]] = None) -> None:
        if self.tracer is not None:
            self.tracer.add_span(name, t_start, dur_s, args=args)

    def instrument_step_fn(self, name: str, fn: Callable) -> Callable:
        """Recompile-sentinel wrapping for a step path; identity when
        telemetry is disabled. With the hang watchdog on, each call also
        records the pending path (one attribute store) so a watchdog
        fire can name what the run was stuck on."""
        if self.sentinel is None:
            return fn
        wrapped = self.sentinel.instrument(name, fn)
        wd = self.watchdog
        if wd is None:
            return wrapped
        raw = getattr(wrapped, "__wrapped__", wrapped)

        @functools.wraps(wrapped)
        def with_pending(*args, **kwargs):
            wd.pending(name)
            return wrapped(*args, **kwargs)

        # Keep the raw path reachable via __wrapped__; functools.wraps
        # would point it at the sentinel wrapper instead.
        with_pending.__wrapped__ = raw
        return with_pending

    def raise_pending(self) -> None:
        """Surface a deferred fail_on_recompile violation (see
        RecompileSentinel.raise_pending — the raise happens AFTER the
        caller stored the step's state)."""
        if self.sentinel is not None:
            self.sentinel.raise_pending()

    # ------------------------------------------------------------------ #
    # Offload trace synthesis: spans from the ALREADY-fenced per-bucket
    # timings run_bucketed_step measured — no new fences.
    # ------------------------------------------------------------------ #
    def add_offload_trace(self, timings: Dict[str, Any]) -> None:
        if self.tracer is None or not timings:
            return
        origin = timings.get("t_origin")
        pb = timings.get("per_bucket")
        t0s = timings.get("per_bucket_t0")
        if origin is None or not pb or not t0s:
            return
        phase_names = {"d2h_ms": "offload_d2h", "norm_ms": "offload_norm",
                       "adam_ms": "offload_adam", "h2d_ms": "offload_h2d"}
        for key, span_name in phase_names.items():
            starts = t0s.get(key.replace("_ms", "_t0"))
            durs = pb.get(key)
            if starts is None or durs is None:
                continue
            for b, (t0, ms) in enumerate(zip(starts, durs)):
                if ms <= 0.0:
                    continue
                self.tracer.add_span(f"{span_name} b{b}", origin + t0,
                                     ms / 1e3,
                                     tid=self.tracer.lane(span_name))

    # ------------------------------------------------------------------ #
    # Events (immediate write — rare, structured)
    # ------------------------------------------------------------------ #
    def event(self, kind: str, payload: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        # Meta must LEAD the stream: telemetry_report treats a meta
        # record as a new-run boundary and resets its accumulators, so
        # an event written before the first drain (an early recompile, a
        # serving request completing inside the first report window)
        # would otherwise be dropped from the summary.
        self._ensure_meta()
        rec = {"kind": "event", "event": kind,
               "step": int(self.step_provider()), "ts": time.time(),
               **payload}
        self.events.append(rec)
        self._write(rec)
        if self.flight is not None:
            self.flight.note_event(rec)
        if self.tracer is not None:
            self.tracer.instant(kind, args=payload)

    def _on_recompile(self, event: Dict[str, Any]) -> None:
        log_dist(
            f"telemetry: new argument signature on '{event['fn']}' after "
            f"warmup (miss #{event['total_compiles']}); signature delta: "
            + "; ".join(event["signature_delta"]), ranks=[0])
        self.event("recompile", event)

    @property
    def recompile_count(self) -> int:
        return self.sentinel.recompile_count if self.sentinel else 0

    # ------------------------------------------------------------------ #
    # Cost model (roofline + MFU) arming — report-boundary work
    # ------------------------------------------------------------------ #
    def set_cost_model(self, payload: Dict[str, Any],
                       samples_per_step: Optional[int] = None) -> None:
        """Record the built cost model (one ``cost_model`` JSONL record)
        and arm per-step MFU: this and later drains stamp ``mfu`` onto
        every step record from its wall and the armed flops/peak — no
        extra device access (wall is already host data)."""
        if not self.enabled:
            return
        self.cost_model_payload = payload
        self._ensure_meta()
        self._write({"kind": "cost_model", "ts": time.time(), **payload})
        step = payload.get("step") or {}
        chip = payload.get("chip") or {}
        flops = float(step.get("flops_per_step") or 0.0)
        n_dev = int(payload.get("n_devices") or 1)
        try:
            peaks = ChipPeaks(**chip)
        except TypeError:
            return
        if flops > 0 and peaks.bf16_tflops > 0:
            self._mfu_arm = {
                "flops_per_step": flops,
                "peaks": peaks,
                "n_devices": n_dev,
                "samples_per_step": samples_per_step,
            }

    def _step_mfu(self, step_time_s: float) -> Optional[float]:
        """The shared MFU formula (cost_model.mfu) at the armed per-step
        flops/peak — one definition for per-step and window figures."""
        arm = self._mfu_arm
        if arm is None or step_time_s <= 0:
            return None
        return _mfu_formula(arm["flops_per_step"], step_time_s,
                            arm["n_devices"], arm["peaks"])

    # ------------------------------------------------------------------ #
    # Report boundary
    # ------------------------------------------------------------------ #
    def set_analytic_footprint(self, nbytes: int,
                               sampler: Optional[Callable] = None) -> None:
        """Arm the memory watermark with the analytic per-device
        model-state bytes (see monitor/memory.py)."""
        if not self.enabled or not self.cfg.memory_watermarks:
            return
        self.watermark = MemoryWatermark(
            nbytes, ratio=self.cfg.watermark_ratio,
            slack_bytes=self.cfg.watermark_slack_bytes,
            sampler=sampler or device_memory_stats)
        self.meta["analytic_state_bytes"] = int(nbytes)

    def maybe_drain(self, step: int,
                    extra: Optional[Dict[str, Any]] = None,
                    extra_fn: Optional[Callable[[], Dict[str, Any]]] = None
                    ) -> bool:
        """Drain iff ``step`` is a report boundary. ``extra_fn`` is only
        invoked when the drain fires — callers can defer work (e.g. a
        counter sync) that must not run on non-boundary steps."""
        if not self.enabled or step % self.report_steps != 0:
            return False
        if extra is None and extra_fn is not None:
            extra = extra_fn()
        self.drain(extra)
        return True

    def drain(self, extra: Optional[Dict[str, Any]] = None) -> None:
        """Flush the ring to JSONL: one batched copy of every buffered
        tensor, then the memory sample + watermark check."""
        if not self.enabled:
            return
        self._ensure_meta()
        recs = list(self._ring)
        self._ring.clear()
        # One copy to the host for the whole window.
        pending = []
        for _, _, metrics, _ in recs:
            for v in metrics.values():
                if isinstance(v, torch.Tensor):
                    pending.append(v)
        fetched = iter(_fetch(pending)) if pending else iter(())
        step_infos = []
        anomaly_events: List[Dict[str, Any]] = []
        for step, ts, metrics, host_fields in recs:
            rec: Dict[str, Any] = {"kind": "step", "step": step, "ts": ts}
            for k, v in metrics.items():
                rec[k] = _to_py(next(fetched) if isinstance(v, torch.Tensor)
                                else v)
            for k, v in host_fields.items():
                rec[k] = _to_py(v) if not isinstance(v, dict) else v
            # MoE per-expert routed token counts ride as one [E] array
            # (fetched in the same batched copy) — JSON-listify.
            moe_tokens = rec.get("moe_expert_tokens")
            if isinstance(moe_tokens, np.ndarray):
                rec["moe_expert_tokens"] = [
                    round(float(t), 2) for t in moe_tokens.reshape(-1)]
            # The grad tap (already fetched in THE batched copy above)
            # feeds provenance, not the JSONL record.
            leaf_sq = rec.pop(HEALTH_TAP_KEY, None)
            if self.health is not None:
                anomaly_events.extend(
                    self.health.check_step(step, rec, leaf_sq))
            wall_ms = rec.get("wall_ms")
            if isinstance(wall_ms, (int, float)):
                m = self._step_mfu(float(wall_ms) / 1e3)
                if m is not None:
                    # Per-step MFU from the step's host wall (see the
                    # wall_ms note); the fenced figure is window_mfu.
                    # 4 significant digits, NOT fixed decimals — a tiny
                    # dev-model MFU (1e-10 on the CPU) must stay nonzero.
                    rec["mfu"] = float(f"{m:.4g}")
            step_infos.append(extract_step_info(rec))
            self._write(rec)
            if self.flight is not None:
                self.flight.note_step(rec)
        # Anomaly events write AFTER the window's step records so the
        # stream stays chronologically readable; each names its step.
        for ev in anomaly_events:
            self.event("anomaly", ev)
        report: Dict[str, Any] = {
            "kind": "report", "step": int(self.step_provider()),
            "ts": time.time(), "records": len(recs),
            "dropped_records": self.dropped_records,
        }
        self.dropped_records = 0
        if extra:
            report.update({k: _to_py(v) if not isinstance(v, dict) else v
                           for k, v in extra.items()})
        if self._mfu_arm is not None and report.get("samples_per_sec_valid") \
                and report.get("samples_per_sec") \
                and self._mfu_arm.get("samples_per_step"):
            # Fenced window MFU: the throughput timer's synchronized
            # window average, not dispatch wall.
            step_time_s = self._mfu_arm["samples_per_step"] / \
                float(report["samples_per_sec"])
            m = self._step_mfu(step_time_s)
            if m is not None:
                report["window_mfu"] = float(f"{m:.4g}")
        if self.ledger is not None:
            if self.sentinel is not None:
                delta = self.sentinel.compile_wall_s - \
                    self._compile_wall_seen
                self._compile_wall_seen = self.sentinel.compile_wall_s
                self.ledger.note("recompile", delta)
            report["goodput"] = self.ledger.close_window(step_infos)
        if self.watermark is not None:
            stats, wm_event = self.watermark.check()
            report["memory"] = stats if stats is not None \
                else {"available": False}
            if wm_event is not None:
                logger.warning(
                    "telemetry: device memory watermark exceeded — peak "
                    f"{wm_event['peak_bytes_in_use_max'] / 2**30:.2f} GB vs "
                    f"analytic model-state "
                    f"{wm_event['analytic_state_bytes'] / 2**30:.2f} GB "
                    f"(x{wm_event['ratio']}); a sharding regression can "
                    "look exactly like this")
                self.event("memory_watermark", wm_event)
        self._write(report)
        if self._profile_done:
            self._drain_profiles()
        if self.flight is not None:
            self.flight.note_report(report)
        if self.tracer is not None:
            self.tracer.flush()

    def _ensure_meta(self) -> None:
        if self._meta_written:
            return
        self._meta_written = True
        self._write({"kind": "meta", "ts": time.time(), **self.meta})

    def _write(self, rec: Dict[str, Any]) -> None:
        if self.sink is not None:
            self.sink.write(rec)

    def _flight_snapshot(self) -> Dict[str, Any]:
        """Config/mesh/env snapshot for FLIGHT.json (host metadata only
        — callable from a signal handler)."""
        import platform
        import sys as _sys
        env: Dict[str, Any] = {"python": platform.python_version(),
                               "argv": list(_sys.argv)[:8],
                               "hostname": platform.node()}
        try:
            env["torch"] = torch.__version__
            env["cuda"] = torch.version.cuda
            env["local_devices"] = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
        except Exception:
            pass
        return {**{k: v for k, v in self.meta.items()
                   if not isinstance(v, (list, tuple)) or len(v) < 32},
                "env": env}

    # ------------------------------------------------------------------ #
    def close(self) -> None:
        if not self.enabled or self._closed:
            return
        # Mark closed FIRST: a signal handler landing on top of a
        # running close() (atexit already mid-drain when SIGTERM
        # arrives) must be a no-op re-entry, not a second drain.
        self._closed = True
        if self.watchdog is not None:
            self.watchdog.stop()
        # Stop a still-open capture window BEFORE the terminal drain so
        # its trace is ingested into this run's JSONL, not lost.
        if self.profiler is not None:
            self.profiler.stop()
        if self._ring or (self.ledger is not None
                          and self.ledger.has_pending()):
            # Drain buffered steps AND settle any trailing attributed
            # time (a checkpoint saved after the last report boundary
            # must not vanish from the goodput ledger).
            self.drain()
        else:
            self._ensure_meta()
        if self._profile_done:
            # A capture that completed after the last boundary (or whose
            # run had no further drain) still lands in the JSONL.
            self._drain_profiles()
        # Terminal drain marker: its absence is how the report tool
        # recognizes a truncated segment.
        self._write({"kind": "final", "step": int(self.step_provider()),
                     "ts": time.time()})
        if self.flight is not None:
            self.flight.closed_clean = True
            self.flight.persist("close")
            self.flight.uninstall()
        # Release process-lifetime anchors: the atexit hook keeps this
        # object (and anything its callbacks close over) alive, so a
        # closed Telemetry must unhook itself and drop the engine-side
        # step_provider closure — otherwise every engine ever built with
        # telemetry enabled pins its full device state until exit.
        atexit.unregister(self.close)
        self.step_provider = lambda: -1
        if self.tracer is not None:
            self.tracer.close()
        if self.sink is not None:
            self.sink.close()


__all__ = ["Telemetry", "JsonlSink", "analytic_state_bytes",
           "device_memory_stats"]
