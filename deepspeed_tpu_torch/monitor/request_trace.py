"""Request-scoped tracing for the serving tier (port of
``deepspeed_tpu/monitor/request_trace.py``; pure host code, the same
records).

A ``RequestTrace`` is the host-side record of one request's life: born
at enqueue, carried through the route decision (the chosen replica plus
every candidate's occupancy / queue-depth / prefix-affinity score),
admission attempts and reservation rejections, prefill (chunk count,
prefix-cache hits, copy-on-write forks), every decode/verify iteration
it participates in (batch occupancy and spec acceptance at that tick),
and completion or abort.

Contract (the telemetry spine's): **zero added device syncs**. Every
input is host state of the scheduler and the router — queue lengths,
slot maps, ``perf_counter`` stamps — plus token counts the engine
already fetched in its one per-iteration copy to the host. This module
imports neither torch nor numpy.

Storage is ring-buffered: per-request tick marks cap at
``tick_capacity`` (drops counted, never silently), completed timelines
retain the last ``capacity`` records. On completion a request's
timeline drains into the existing writers:

- one ``request_trace`` JSONL event (the same immediate-write class as
  ``request_complete``), carrying the full span timeline — so
  ``tools/telemetry_report.py`` can reconstruct worst-request
  exemplars from the JSONL alone;
- Perfetto spans on a per-replica lane plus flow arrows
  (``TraceWriter.flow``) linking route→admit→first-token across
  replica tracks.

Timelines are contiguous by construction: consecutive phases share
their boundary instant (queued ends exactly where prefill starts,
prefill ends exactly at first token), so ``validate_timeline`` checks
gaps/overlaps exactly, not within an epsilon. A span's duration is the
difference of its end's and its start's offsets (the JAX package takes
the difference of the absolute instants, whose sum with the start's
offset can miss the next offset by an ulp, which ``validate_timeline``
then reports as a gap or an overlap: ROADMAP F9).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

# Perfetto lanes: training spans own 0-7 (trace._LANES); the serving
# request view gets the router on lane 8 and replicas on 9+.
ROUTER_LANE = 8
_REPLICA_LANE0 = 9


class _Rec:
    """Mutable per-request record while the request is in flight."""

    __slots__ = ("rid", "replica", "t_enqueue", "t_route", "route",
                 "admission_attempts", "t_first_reject", "reject_reason",
                 "t_admit", "slot", "prefill", "t_first", "ticks",
                 "ticks_dropped", "emitted", "t_end", "outcome", "cow_forks")

    def __init__(self, rid: int, t_enqueue: float):
        self.rid = rid
        self.replica: Optional[str] = None
        self.t_enqueue = t_enqueue
        self.t_route: Optional[float] = None
        self.route: Optional[dict] = None
        self.admission_attempts = 0
        self.t_first_reject: Optional[float] = None
        self.reject_reason: Optional[str] = None
        self.t_admit: Optional[float] = None
        self.slot: Optional[int] = None
        self.prefill: Optional[dict] = None
        self.t_first: Optional[float] = None
        self.ticks: List[dict] = []
        self.ticks_dropped = 0
        self.emitted = 0
        self.t_end: Optional[float] = None
        self.outcome: Optional[str] = None
        self.cow_forks = 0


class RequestTrace:
    """Host-side per-request span recorder for a scheduler or router."""

    def __init__(self, capacity: int = 1024, tick_capacity: int = 512,
                 clock=time.perf_counter):
        self.capacity = int(capacity)
        self.tick_capacity = int(tick_capacity)
        self._clock = clock
        self._live: Dict[int, _Rec] = {}
        self.completed: List[dict] = []  # ring of finished timelines
        self.records_dropped = 0
        self._replica_lanes: Dict[str, int] = {}

    # ------------------------------------------------------------- marks
    def enqueue(self, rid: int, t: Optional[float] = None) -> None:
        if rid in self._live:
            return
        if len(self._live) >= self.capacity:
            self.records_dropped += 1
            return
        self._live[rid] = _Rec(rid, self._clock() if t is None else t)

    def route(self, rid: int, chosen: int, candidates: List[dict],
              t: Optional[float] = None) -> None:
        """Record the routing decision with every candidate's scores."""
        rec = self._live.get(rid)
        if rec is None:
            return
        rec.t_route = self._clock() if t is None else t
        rec.route = {"chosen": int(chosen), "candidates": candidates}

    def admit_reject(self, rid: int, reason: str = "reservation",
                     t: Optional[float] = None) -> bool:
        """A failed admission attempt; returns True on the FIRST one."""
        rec = self._live.get(rid)
        if rec is None:
            return False
        rec.admission_attempts += 1
        first = rec.t_first_reject is None
        if first:
            rec.t_first_reject = self._clock() if t is None else t
            rec.reject_reason = reason
        return first

    def admit(self, rid: int, slot: int, t: Optional[float] = None,
              replica: Optional[str] = None) -> None:
        rec = self._live.get(rid)
        if rec is None:
            return
        rec.t_admit = self._clock() if t is None else t
        rec.slot = int(slot)
        if replica is not None:
            rec.replica = replica

    def prefill(self, rid: int, wall_s: float, tokens: int, chunks: int = 1,
                cached_tokens: int = 0, cow_fork: bool = False) -> None:
        rec = self._live.get(rid)
        if rec is None:
            return
        rec.prefill = {"wall_ms": wall_s * 1e3, "tokens": int(tokens),
                       "chunks": int(chunks),
                       "cached_tokens": int(cached_tokens)}
        if cow_fork:
            rec.cow_forks += 1

    def first_token(self, rid: int, t: Optional[float] = None) -> None:
        rec = self._live.get(rid)
        if rec is not None and rec.t_first is None:
            rec.t_first = self._clock() if t is None else t

    def tick(self, rid: int, occupancy: int, emitted: int,
             proposed: int = 0, accepted: int = 0,
             t: Optional[float] = None) -> None:
        """One decode/verify iteration this request participated in."""
        rec = self._live.get(rid)
        if rec is None:
            return
        rec.emitted += int(emitted)
        if len(rec.ticks) >= self.tick_capacity:
            rec.ticks_dropped += 1
            return
        mark = {"t": self._clock() if t is None else t,
                "occupancy": int(occupancy), "emitted": int(emitted)}
        if proposed:
            mark["proposed"] = int(proposed)
            mark["accepted"] = int(accepted)
        rec.ticks.append(mark)

    # ---------------------------------------------------------- lifecycle
    def complete(self, rid: int, t: Optional[float] = None,
                 telemetry=None) -> Optional[dict]:
        return self._finish(rid, "complete", t, telemetry)

    def abort(self, rid: int, reason: str = "abort",
              t: Optional[float] = None, telemetry=None) -> Optional[dict]:
        return self._finish(rid, reason, t, telemetry)

    def _finish(self, rid: int, outcome: str, t: Optional[float],
                telemetry) -> Optional[dict]:
        rec = self._live.pop(rid, None)
        if rec is None:
            return None
        rec.t_end = self._clock() if t is None else t
        rec.outcome = "complete" if outcome == "complete" else "abort"
        tl = self._timeline(rec, outcome)
        self.completed.append(tl)
        if len(self.completed) > self.capacity:
            del self.completed[:len(self.completed) - self.capacity]
        if telemetry is not None:
            self._drain(rec, tl, telemetry)
        return tl

    # ---------------------------------------------------------- timeline
    def _timeline(self, rec: _Rec, outcome: str) -> dict:
        """Build the contiguous span timeline (offsets in ms from enqueue).

        Consecutive spans share boundary instants and each duration is
        the difference of two offsets, so a span's start plus its
        duration is the next span's start (and the last's is
        ``total_ms``) in floating point too.
        """
        t0 = rec.t_enqueue

        def ms(t: Optional[float]) -> Optional[float]:
            return None if t is None else (t - t0) * 1e3

        spans: List[dict] = []
        # queued: enqueue → admit (or end, if never admitted). The route
        # decision is an instant inside it.
        q_end = rec.t_admit if rec.t_admit is not None else rec.t_end
        spans.append({"phase": "queued", "t_ms": 0.0,
                      "dur_ms": ms(q_end) or 0.0})
        if rec.t_admit is not None:
            # prefill runs to first token, or to the end for a request
            # aborted mid-service — either way no gap before decode/end.
            pf_end = rec.t_first if rec.t_first is not None else rec.t_end
            pf_start = ms(rec.t_admit)
            pf = {"phase": "prefill", "t_ms": pf_start,
                  "dur_ms": ms(pf_end) - pf_start}
            if rec.prefill:
                pf.update(rec.prefill)
            if rec.cow_forks:
                pf["cow_forks"] = rec.cow_forks
            spans.append(pf)
            if rec.t_first is not None:
                dec_start = ms(rec.t_first)
                spans.append({"phase": "decode", "t_ms": dec_start,
                              "dur_ms": ms(rec.t_end) - dec_start,
                              "ticks": len(rec.ticks) + rec.ticks_dropped,
                              "emitted": rec.emitted})
        tl: dict = {"rid": rec.rid, "outcome": rec.outcome,
                    "t0_s": rec.t_enqueue, "spans": spans,
                    "total_ms": ms(rec.t_end),
                    "admission_attempts": rec.admission_attempts,
                    "new_tokens": rec.emitted}
        if outcome not in ("complete", "abort"):
            tl["abort_reason"] = outcome
        if rec.replica is not None:
            tl["replica"] = rec.replica
        if rec.route is not None:
            tl["route"] = rec.route
            tl["route_ms"] = ms(rec.t_route)
        if rec.t_first_reject is not None:
            tl["first_reject_ms"] = ms(rec.t_first_reject)
            tl["reject_reason"] = rec.reject_reason
        if rec.t_admit is not None:
            tl["queue_wait_ms"] = ms(rec.t_admit)
        if rec.t_first is not None:
            tl["ttft_ms"] = ms(rec.t_first)
            if rec.t_admit is not None:
                tl["service_ttft_ms"] = (rec.t_first - rec.t_admit) * 1e3
        if rec.ticks:
            tl["ticks"] = [
                {"t_ms": (m["t"] - t0) * 1e3, **{k: v for k, v in m.items()
                                                 if k != "t"}}
                for m in rec.ticks]
        if rec.ticks_dropped:
            tl["ticks_dropped"] = rec.ticks_dropped
        return tl

    # ------------------------------------------------------------- drain
    def _lane(self, replica: Optional[str]) -> int:
        if not replica:
            return _REPLICA_LANE0
        if replica not in self._replica_lanes:
            self._replica_lanes[replica] = \
                _REPLICA_LANE0 + len(self._replica_lanes)
        return self._replica_lanes[replica]

    def _drain(self, rec: _Rec, tl: dict, telemetry) -> None:
        """Emit the finished timeline: one JSONL event + Perfetto spans
        with flow arrows route→admit→first-token. Host file IO only."""
        try:
            telemetry.event("request_trace", tl)
        except Exception:
            pass
        tracer = getattr(telemetry, "tracer", None)
        if tracer is None:
            return
        lane = self._lane(rec.replica)
        t0 = rec.t_enqueue
        prefix = f"req{rec.rid}"
        for sp in tl["spans"]:
            t_abs = t0 + sp["t_ms"] / 1e3
            args = {k: v for k, v in sp.items()
                    if k not in ("phase", "t_ms", "dur_ms")}
            args["rid"] = rec.rid
            tracer.add_span(f"{prefix}/{sp['phase']}", t_abs,
                            sp["dur_ms"] / 1e3,
                            tid=ROUTER_LANE if sp["phase"] == "queued"
                            else lane, args=args)
        # Flow chain: route (router lane) → admit → first token (replica
        # lane) — one arrow per request across tracks.
        t_route = rec.t_route if rec.t_route is not None else rec.t_enqueue
        tracer.flow(prefix, rec.rid, "s", t_route, tid=ROUTER_LANE)
        if rec.t_admit is not None:
            tracer.flow(prefix, rec.rid, "t", rec.t_admit, tid=lane)
        if rec.t_first is not None:
            tracer.flow(prefix, rec.rid, "f", rec.t_first, tid=lane)

    # ------------------------------------------------------------ report
    def summary(self) -> dict:
        return {"completed": len(self.completed),
                "in_flight": len(self._live),
                "records_dropped": self.records_dropped,
                "ticks_dropped": sum(tl.get("ticks_dropped", 0)
                                     for tl in self.completed)}


def validate_timeline(tl: dict) -> List[str]:
    """Check one drained timeline for structural defects.

    Returns a list of problems (empty = valid): spans must be present,
    start at offset 0, be contiguous (each span ends exactly where the
    next begins — shared instants, so equality is exact), and a
    completed request must carry the enqueue→admit→first-token→complete
    chain (queued/prefill/decode with ttft and queue_wait split).
    """
    problems: List[str] = []
    spans = tl.get("spans") or []
    if not spans:
        return ["no spans"]
    if spans[0]["t_ms"] != 0.0:
        problems.append(f"first span starts at {spans[0]['t_ms']}, not 0")
    for a, b in zip(spans, spans[1:]):
        end = a["t_ms"] + a["dur_ms"]
        if end != b["t_ms"]:
            kind = "gap" if end < b["t_ms"] else "overlap"
            problems.append(
                f"{kind} between {a['phase']} and {b['phase']}: "
                f"{end} != {b['t_ms']}")
    last = spans[-1]
    total = tl.get("total_ms")
    if total is not None and last["t_ms"] + last["dur_ms"] != total:
        problems.append("last span does not end at total_ms")
    if tl.get("outcome") == "complete":
        phases = [s["phase"] for s in spans]
        if phases != ["queued", "prefill", "decode"]:
            problems.append(f"completed request has phases {phases}")
        for key in ("ttft_ms", "queue_wait_ms", "service_ttft_ms"):
            if tl.get(key) is None:
                problems.append(f"completed request missing {key}")
        if tl.get("ttft_ms") is not None \
                and tl.get("queue_wait_ms") is not None \
                and tl.get("service_ttft_ms") is not None:
            if abs(tl["queue_wait_ms"] + tl["service_ttft_ms"]
                   - tl["ttft_ms"]) > 1e-6:
                problems.append("queue_wait + service_ttft != ttft")
    return problems


__all__ = ["RequestTrace", "validate_timeline", "ROUTER_LANE"]
