"""Goodput ledger: attribute every wall-clock second between report
boundaries to a named bucket (the port's copy of
``deepspeed_tpu/monitor/goodput.py``; same buckets and arithmetic).

Throughput says how fast the useful steps were; goodput says where the
REST of the wall-clock went. The ledger runs on host-side monotonic
clocks only (no device syncs — the telemetry invariant), accumulating
in-window costs as they are measured and settling the window at each
drain:

- ``useful_compute`` — host wall spent inside non-overflow train steps,
  minus the stalls measured inside them. On the card's paths this is
  launch wall (kernels queue asynchronously); the roofline/MFU side
  covers device occupancy. On the host-synchronous offload path it is
  true step wall.
- ``data_stall``   — time the engine waited on ``next(data_iter)`` (new
  dataloader fetch-wait instrumentation).
- ``recompile``    — wall of calls with a new argument signature (the
  port's first call of a path builds its kernels and warms its
  allocator), from the recompile sentinel's per-miss clock. Cold-start
  calls count too: they are real lost wall-clock in their window.
- ``overflow_skipped`` — wall of steps whose dynamic-loss-scale
  overflow check voted to skip the update (work executed, result
  discarded), minus any stall/compile wall measured inside those steps
  — that time is reattributed to its own bucket (a step can both
  cold-compile and overflow; the seconds are counted once).
- ``checkpoint``   — EXPOSED checkpoint wall (outermost checkpoint span
  only): sync save/load wall, or under async checkpointing the
  snapshot fetch + any blocking wait on the writer. Two sub-figures
  ride along without joining the bucket sum: ``checkpoint_snapshot_s``
  (the snapshot-phase subset of the exposed bucket) and
  ``checkpoint_write_bg_s`` (the BACKGROUND writer's wall — measured on
  its own thread, overlapping useful compute, so charging it against
  the window would double-count the same seconds).
- ``offload_exposed`` — ZeRO-Offload host time NOT hidden behind device
  work (step wall minus the device-only phase).
- ``other``        — the residual: window wall minus everything above
  (engine init in the first window, user code between steps, drain
  work). The ledger never invents time: buckets are measured
  independently, so a NEGATIVE residual means double-attribution and is
  surfaced, not clamped — and the "sums to window wall within 1%"
  acceptance gate is a real check on the measured buckets, not a
  tautology.

Windows are contiguous: a window closes at drain time and the next one
opens at the same instant, so no second is silently outside all windows.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

BUCKETS = ("useful_compute", "data_stall", "recompile", "overflow_skipped",
           "checkpoint", "offload_exposed", "other")

# (wall_s, overflow, offload_exposed_s) for one drained step record.
StepInfo = Tuple[float, bool, float]


class GoodputLedger:
    """Window-scoped wall-clock attribution (host clocks only)."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.window_t0: float = clock()
        self._noted: Dict[str, float] = {"data_stall": 0.0,
                                         "recompile": 0.0,
                                         "checkpoint": 0.0}
        # Sub-figures: named subsets of a bucket (checkpoint_snapshot
        # within checkpoint). Reported per window, never summed into the
        # bucket total a second time.
        self._sub: Dict[str, float] = {}
        # Background seconds measured on other threads (the checkpoint
        # writer): overlap the window, reported but not charged.
        self._bg: Dict[str, float] = {}
        self._bg_lock = threading.Lock()
        self.windows_closed = 0
        self.totals: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self.sub_totals: Dict[str, float] = {}
        self.bg_totals: Dict[str, float] = {}
        self.total_window_s = 0.0

    # ------------------------------------------------------------------ #
    # In-window accumulation (hot-path safe: float adds)
    # ------------------------------------------------------------------ #
    def note(self, bucket: str, seconds: float,
             sub: Optional[str] = None) -> None:
        """Record directly-measured seconds for ``data_stall`` /
        ``recompile`` / ``checkpoint`` as they happen. ``sub`` names a
        reported-only subset of the bucket (``checkpoint_snapshot``)."""
        if seconds > 0.0:
            self._noted[bucket] = self._noted.get(bucket, 0.0) + seconds
            if sub is not None:
                self._sub[sub] = self._sub.get(sub, 0.0) + seconds

    def note_background(self, key: str, seconds: float) -> None:
        """Record seconds measured on a BACKGROUND thread (the async
        checkpoint writer). Reported as ``<key>_bg_s`` per window,
        excluded from the bucket sum — those seconds overlap the window
        and charging them would double-count the wall."""
        if seconds > 0.0:
            with self._bg_lock:
                self._bg[key] = self._bg.get(key, 0.0) + seconds

    def has_pending(self) -> bool:
        """True when directly-measured seconds await settlement — e.g. a
        checkpoint saved after the last report boundary. close() checks
        this so trailing attributed time is never silently dropped."""
        if any(v > 0.0 for v in self._noted.values()):
            return True
        with self._bg_lock:
            return any(v > 0.0 for v in self._bg.values())

    def peek(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Non-destructive view of the OPEN window (the flight
        recorder's "unsettled goodput window"): elapsed wall since the
        last settlement plus the directly-measured buckets noted so far.
        Settlement math (residual, consistency) only happens at
        close_window — this is the raw evidence, not a verdict."""
        now = self._clock() if now is None else now
        with self._bg_lock:
            bg = {k: round(v, 6) for k, v in self._bg.items()}
        return {
            "open_window_s": round(max(0.0, now - self.window_t0), 6),
            "noted_s": {k: round(v, 6) for k, v in self._noted.items()},
            "background_s": bg,
            "windows_closed": self.windows_closed,
        }

    # ------------------------------------------------------------------ #
    # Window settlement (report-boundary work)
    # ------------------------------------------------------------------ #
    def close_window(self, steps: Iterable[StepInfo],
                     now: Optional[float] = None) -> Dict[str, Any]:
        """Settle the current window against the drained step records and
        open the next one. Returns the JSONL-ready ledger dict."""
        now = self._clock() if now is None else now
        window_s = max(0.0, now - self.window_t0)
        step_list: List[StepInfo] = list(steps)

        overflow_s = sum(w for w, o, _ in step_list if o)
        exposed_s = sum(e for w, o, e in step_list if not o)
        in_step_s = sum(w for w, o, _ in step_list if not o)
        data_stall = self._noted.get("data_stall", 0.0)
        recompile = self._noted.get("recompile", 0.0)
        checkpoint = self._noted.get("checkpoint", 0.0)
        # Stalls measured inside train_batch are part of the per-step
        # wall; useful compute is what remains of the non-overflow steps.
        useful = in_step_s - data_stall - recompile - exposed_s
        if useful < 0.0:
            # The excess stall/compile wall was measured inside OVERFLOW
            # steps (e.g. the first step cold-compiles AND overflows
            # under a high initial loss scale): those seconds belong to
            # data_stall/recompile — the more actionable attribution —
            # so move them out of the overflow bucket instead of
            # double-counting. overflow_s going negative here is the
            # genuine double-attribution signal (checked below).
            overflow_s += useful
            useful = 0.0
        buckets = {
            "useful_compute": useful,
            "data_stall": data_stall,
            "recompile": recompile,
            "overflow_skipped": overflow_s,
            "checkpoint": checkpoint,
            "offload_exposed": exposed_s,
        }
        other = window_s - sum(buckets.values())
        buckets["other"] = other

        sub = self._sub
        self._sub = {}
        with self._bg_lock:
            bg = self._bg
            self._bg = {}
        self._noted = {"data_stall": 0.0, "recompile": 0.0,
                       "checkpoint": 0.0}
        self.window_t0 = now
        self.windows_closed += 1
        for b in BUCKETS:
            self.totals[b] += buckets[b]
        for k, v in sub.items():
            self.sub_totals[k] = self.sub_totals.get(k, 0.0) + v
        for k, v in bg.items():
            self.bg_totals[k] = self.bg_totals.get(k, 0.0) + v
        self.total_window_s += window_s

        out: Dict[str, Any] = {"window_s": round(window_s, 6),
                               "steps": len(step_list)}
        out.update({f"{b}_s": round(buckets[b], 6) for b in BUCKETS})
        # Reported-only figures: subsets of a bucket and background
        # (overlapped) seconds — OUTSIDE the sum the accounted-fraction
        # check covers, by design.
        out.update({f"{k}_s": round(v, 6) for k, v in sub.items()})
        out.update({f"{k}_bg_s": round(v, 6) for k, v in bg.items()})
        # Sum check the acceptance gate reads: measured buckets + residual
        # vs window wall. A healthy run keeps overflow and the residual
        # non-negative; double-attribution shows up as either < 0.
        out["accounted_fraction"] = round(
            sum(buckets.values()) / window_s, 6) if window_s > 0 else 1.0
        out["consistent"] = bool(
            overflow_s >= -0.01 * window_s and other >= -0.01 * window_s)
        return out

    # ------------------------------------------------------------------ #
    def summary(self) -> Dict[str, Any]:
        """Run-cumulative bucket totals and the goodput fraction."""
        total = self.total_window_s
        out: Dict[str, Any] = {
            "windows": self.windows_closed,
            "total_window_s": round(total, 6),
        }
        out.update({f"{b}_s": round(self.totals[b], 6) for b in BUCKETS})
        out.update({f"{k}_s": round(v, 6)
                    for k, v in self.sub_totals.items()})
        out.update({f"{k}_bg_s": round(v, 6)
                    for k, v in self.bg_totals.items()})
        out["goodput_fraction"] = round(
            self.totals["useful_compute"] / total, 6) if total > 0 else 0.0
        if total > 0:
            # The headline the resilience gate reads: how much of the
            # wall the run actually PAID for checkpointing (background
            # write wall is excluded — it overlapped).
            out["checkpoint_exposed_share"] = round(
                self.totals["checkpoint"] / total, 6)
        return out


def extract_step_info(rec: Dict[str, Any]) -> StepInfo:
    """StepInfo from a drained (post-fetch, host-native) step record."""
    wall_s = float(rec.get("wall_ms", 0.0)) / 1e3
    overflow = bool(rec.get("overflow", False))
    exposed_s = 0.0
    off = rec.get("offload")
    if isinstance(off, dict):
        off_wall = float(off.get("wall_ms", 0.0))
        dev = float(off.get("device_step_ms", 0.0))
        if off_wall > 0.0 and dev > 0.0:
            exposed_s = max(0.0, off_wall - dev) / 1e3
    return (wall_s, overflow, exposed_s)


__all__ = ["GoodputLedger", "BUCKETS", "extract_step_info"]
