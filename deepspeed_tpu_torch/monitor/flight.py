"""Crash flight recorder: the forensic state a dying run leaves behind
(port of ``deepspeed_tpu/monitor/flight.py``).

A SIGTERM (preemption), an uncaught fault, or a plain crash used to take
the in-flight telemetry ring, the open goodput window, and every anomaly
event down with the process — exactly the evidence a postmortem needs.
The flight recorder keeps a HOST-SIDE mirror of the last N drained step
records, the recent events, and callbacks into the live ring/ledger, and
persists all of it ATOMICALLY (tmp file + ``os.replace``) to
``FLIGHT.json`` on:

- SIGTERM / SIGINT — the handler snapshots the signal-time state (the
  unsettled goodput window and the ring's undrained step ids — pure
  host memory, safe even when the card is hung), then attempts a
  clean ``Telemetry.close()`` (which drains the ring so the last
  records make it into ``last_steps``), then persists and CHAINS to the
  previous handler (default disposition re-raises, so exit codes stay
  honest).
- atexit — a process that exits without ``close()`` still persists.
- explicit ``Telemetry.close()`` — every cleanly-closed run leaves a
  ``reason: "close"`` artifact; the REASON is sticky, so a SIGTERM'd
  run's file says SIGTERM even though close() persisted last.
- hard faults — ``faulthandler.enable()`` onto a sidecar log
  (``flight_fault.log``) when no earlier enable exists, so SIGSEGV
  leaves thread stacks next to the JSON.

``tools/telemetry_report.py`` reports flight-recorder presence and the
recorded reason in its ``health`` section.
"""
from __future__ import annotations

import atexit
import faulthandler
import json
import os
import signal
import sys
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..utils.logging import logger

_SIGNALS = ("SIGTERM", "SIGINT")


def dispatch_prev_handler(prev, signum, frame, own_handler) -> None:
    """Continue a chained signal after our handler ran: call a callable
    prior handler, or re-raise under the default disposition so the
    process reports the true termination signal (None / C-installed
    handlers are opaque — dying by the signal is the only honest
    continuation; SIG_IGN stays ignored)."""
    if callable(prev) and prev is not own_handler:
        prev(signum, frame)
    elif prev in (signal.SIG_DFL, None):
        # If the process disposition still points at the caller (a chain
        # restored it), force the default first — otherwise the re-raise
        # would re-enter it forever.
        try:
            if signal.getsignal(signum) == own_handler:
                signal.signal(signum, signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        try:
            os.kill(os.getpid(), signum)
        except Exception:
            sys.exit(128 + int(signum))


class FlightRecorder:
    """Host-side black box for one Telemetry instance."""

    def __init__(self, path: str, window: int = 64,
                 snapshot_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 max_events: int = 128):
        self.path = path
        self.window = int(window)
        self.snapshot_fn = snapshot_fn
        self.last_steps: deque = deque(maxlen=self.window)
        self.last_report: Optional[Dict[str, Any]] = None
        self.events: deque = deque(maxlen=int(max_events))
        self.reason: Optional[str] = None
        self.persist_count = 0
        self.closed_clean = False
        # Live-state callbacks the owner (Telemetry) wires up.
        self.ledger_peek: Optional[Callable[[], Dict[str, Any]]] = None
        self.ledger_summary: Optional[Callable[[], Dict[str, Any]]] = None
        self.ring_steps: Optional[Callable[[], List[int]]] = None
        self.health_summary: Optional[Callable[[], Dict[str, Any]]] = None
        self.watchdog_fires: Optional[Callable[[], int]] = None
        self._at_signal: Optional[Dict[str, Any]] = None
        self._close_cb: Optional[Callable[[], None]] = None
        self._prev_handlers: Dict[int, Any] = {}
        # Kept across uninstall: a NEWER recorder may have chained our
        # handler before we uninstalled, so a stale invocation must
        # still be able to pass the signal through (without touching
        # the artifact).
        self._chain_prev: Dict[int, Any] = {}
        self._installed = False
        self._fault_file = None
        self._atexit_hook = None

    # ------------------------------------------------------------------ #
    # Feed (called by Telemetry at drain time / on events)
    # ------------------------------------------------------------------ #
    def note_step(self, rec: Dict[str, Any]) -> None:
        self.last_steps.append(rec)

    def note_report(self, rec: Dict[str, Any]) -> None:
        self.last_report = rec

    def note_event(self, rec: Dict[str, Any]) -> None:
        self.events.append(rec)

    # ------------------------------------------------------------------ #
    # Install / uninstall
    # ------------------------------------------------------------------ #
    def install(self, close_cb: Optional[Callable[[], None]] = None) -> None:
        """Hook SIGTERM/SIGINT (chaining any previous handler), atexit,
        and — when nothing else enabled it — faulthandler onto a sidecar
        log next to FLIGHT.json."""
        if self._installed:
            return
        self._installed = True
        self._close_cb = close_cb
        for name in _SIGNALS:
            signum = getattr(signal, name, None)
            if signum is None:
                continue
            try:
                prev = signal.signal(signum, self._on_signal)
                self._prev_handlers[int(signum)] = prev
            except (ValueError, OSError):
                # Not the main thread / restricted env: signals are a
                # best-effort layer; atexit + explicit close still work.
                pass
        self._atexit_hook = self._on_atexit
        atexit.register(self._atexit_hook)
        if not faulthandler.is_enabled():
            try:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._fault_file = open(
                    os.path.join(d or ".", "flight_fault.log"), "w")
                faulthandler.enable(file=self._fault_file)
            except Exception:
                self._fault_file = None

    def uninstall(self) -> None:
        """Restore chained handlers and drop the atexit hook (idempotent
        — the signal handler itself calls this mid-flight)."""
        if not self._installed:
            return
        self._installed = False
        self._chain_prev.update(self._prev_handlers)
        for signum, prev in self._prev_handlers.items():
            try:
                if signal.getsignal(signum) == self._on_signal:
                    # A None prior handler (installed from C) cannot be
                    # re-installed from Python; default disposition is
                    # the closest restoration (and prevents our handler
                    # from re-entering itself on the re-raise).
                    signal.signal(signum, signal.SIG_DFL
                                  if prev is None else prev)
            except (ValueError, OSError, TypeError):
                pass
        self._prev_handlers = {}
        if self._atexit_hook is not None:
            atexit.unregister(self._atexit_hook)
            self._atexit_hook = None
        if self._fault_file is not None:
            try:
                faulthandler.disable()
                self._fault_file.close()
            except Exception:
                pass
            self._fault_file = None

    # ------------------------------------------------------------------ #
    # Triggers
    # ------------------------------------------------------------------ #
    def _on_signal(self, signum, frame) -> None:
        if not self._installed:
            # Stale link in a handler chain: a newer recorder (same
            # process, e.g. a second engine) chained this handler before
            # our uninstall. The live recorder already persisted ITS
            # artifact — touching ours now would clobber the postmortem
            # with a dead engine's state. Pass the signal through.
            self._dispatch_prev(self._chain_prev.get(int(signum),
                                                     signal.SIG_DFL),
                                signum, frame)
            return
        try:
            name = signal.Signals(signum).name
        except Exception:
            name = f"signal {signum}"
        self.note_signal(name)
        # Persist the host-safe snapshot FIRST: the clean close below
        # drains the ring with one device read, and on a HUNG card (the
        # flagship hang-then-SIGTERM scenario) that blocks until the
        # grace period's SIGKILL — the artifact must already be on disk
        # by then. A successful close upgrades it with a second persist.
        self.persist()
        prev = self._prev_handlers.get(int(signum), signal.SIG_DFL)
        try:
            if self._close_cb is not None:
                self._close_cb()   # drains the ring -> last_steps fills
        except Exception:
            pass
        self.persist()
        self.uninstall()
        self._dispatch_prev(prev, signum, frame)

    def _dispatch_prev(self, prev, signum, frame) -> None:
        dispatch_prev_handler(prev, signum, frame, self._on_signal)

    def note_signal(self, name: str) -> None:
        """Snapshot the signal-time state BEFORE any drain runs: the
        unsettled goodput window and the undrained ring step ids are
        pure host memory — capturing them cannot block on a hung
        device."""
        if self.reason is None:
            self.reason = name
        snap: Dict[str, Any] = {"ts": time.time()}
        try:
            if self.ledger_peek is not None:
                snap["goodput_unsettled"] = self.ledger_peek()
            if self.ring_steps is not None:
                snap["undrained_steps"] = list(self.ring_steps())
        except Exception:
            pass
        if self._at_signal is None:
            self._at_signal = snap

    def _on_atexit(self) -> None:
        if self.reason is None:
            self.reason = "atexit"
        try:
            self.persist()
        except Exception:
            pass

    # ------------------------------------------------------------------ #
    # The write
    # ------------------------------------------------------------------ #
    def persist(self, reason: Optional[str] = None) -> Optional[str]:
        """Atomically write FLIGHT.json. The first recorded reason is
        sticky: a SIGTERM'd run's artifact says SIGTERM even though the
        chained close() persists again afterwards."""
        if self.reason is None and reason is not None:
            self.reason = reason
        payload: Dict[str, Any] = {
            "flight_recorder": 1,
            "reason": self.reason or "unknown",
            "ts": time.time(),
            "pid": os.getpid(),
            "persist_count": self.persist_count + 1,
            "closed_clean": self.closed_clean,
            "last_steps": list(self.last_steps),
            "last_report": self.last_report,
            "events": list(self.events),
        }
        if self.snapshot_fn is not None:
            try:
                payload["snapshot"] = self.snapshot_fn()
            except Exception:
                payload["snapshot"] = None
        at_sig = self._at_signal
        try:
            if at_sig is not None:
                # The signal-time view: what was open when the run died.
                payload["at_signal"] = at_sig
                payload["goodput_unsettled"] = \
                    at_sig.get("goodput_unsettled")
                payload["undrained_steps"] = \
                    at_sig.get("undrained_steps", [])
            else:
                if self.ledger_peek is not None:
                    payload["goodput_unsettled"] = self.ledger_peek()
                if self.ring_steps is not None:
                    payload["undrained_steps"] = list(self.ring_steps())
            if self.ledger_summary is not None:
                payload["goodput_totals"] = self.ledger_summary()
            if self.health_summary is not None:
                payload["anomalies"] = self.health_summary()
            if self.watchdog_fires is not None:
                payload["watchdog_fires"] = int(self.watchdog_fires())
        except Exception:
            pass
        if payload["last_steps"]:
            payload["final_step"] = payload["last_steps"][-1].get("step")
        tmp = self.path + ".tmp"
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, default=str)
            os.replace(tmp, self.path)
            self.persist_count += 1
            return self.path
        except OSError as e:
            # A deleted tmp dir at interpreter teardown must not turn a
            # crash handler into a second crash.
            try:
                logger.debug(f"flight recorder persist failed: {e}")
            except Exception:
                pass
            return None


__all__ = ["FlightRecorder", "dispatch_prev_handler"]
