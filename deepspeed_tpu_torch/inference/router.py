"""Multi-replica serving: an admission router over N InferenceEngines
(port of ``deepspeed_tpu/inference/router.py``; host code).

Each replica is a full ``InferenceEngine`` (its own KV pool and its own
``ServingAggregator``); the router owns the open-loop arrival queue and
decides, per request, WHICH replica admits it —

- **load**: occupancy (active slots / capacity) plus local queue depth,
  from each replica's host counters — the router never touches a
  device;
- **prefix affinity**: a replica already holding the prompt's cached
  prefix blocks scores higher, so shared prefixes land where their
  blocks live and the paged cache's hit rate survives scale-out.

Replicas then run the single-engine scheduler's own iteration-level
continuous batching (``ContinuousBatchingScheduler.admit`` and
``step``): admit from the local queue, one decode/verify step for
every live slot, evict finished. Engines that share one device
(several replicas on one card) take their steps in turn, so
per-iteration walls stack: tokens/s and TTFT measured that way are a
lower bound on what replicas on their own cards would do.

Reports keep replicas apart: per-replica aggregator snapshots plus the
pooled ``ServingAggregator.merged`` aggregate — never
percentiles-of-percentiles — and ``recompiles``, summed over the
replicas. When a replica has telemetry on, one ``RequestTrace``
(``monitor/request_trace.py``) spans the fleet: each arrival's route
decision is recorded with every candidate's scores, the replica-side
marks land in the same record, each finished request drains into its
replica's stream, and the report gains ``trace``. Host state only: no
device sync is added.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .scheduler import (ContinuousBatchingScheduler, Request,
                        request_records)
from ..monitor.serving import ServingAggregator


class ReplicaRouter:
    """Route + serve an open-loop stream over N engine replicas."""

    def __init__(self, engines: Sequence[Any], temperature: float = 0.0,
                 eos_token: Optional[int] = None,
                 affinity_weight: float = 1.0,
                 idle_sleep_s: float = 0.0005,
                 max_wall_s: Optional[float] = None):
        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        self.engines = list(engines)
        self.temperature = float(temperature)
        self.eos_token = eos_token
        self.affinity_weight = float(affinity_weight)
        self.idle_sleep_s = float(idle_sleep_s)
        self.max_wall_s = max_wall_s
        self.routed: List[int] = [0] * len(self.engines)
        self.affinity_hits = 0
        # Per-request decision records: every candidate's occupancy /
        # queue depth / affinity tokens / composite score at route time
        # (ring-capped). The chosen replica is argmax of the recorded
        # scores by construction.
        self.decisions: List[dict] = []
        self.decision_capacity = 4096
        self.trace = None               # RequestTrace, built in serve()

    # ------------------------------------------------------------------ #
    def _score_parts(self, eng, queue_len: int, req: Request) -> dict:
        """One candidate's routing signals (all host counters): higher
        composite score is better — prefix affinity minus load
        (occupancy + normalized queue depth)."""
        plen = max(len(req.prompt), 1)
        affinity_tokens = eng.prefix_match_tokens(req.prompt)
        occupancy = eng.active_slots / eng.max_slots
        queue_load = queue_len / eng.max_slots
        return {
            "occupancy": round(occupancy, 4),
            "queue_depth": queue_len,
            "affinity_tokens": affinity_tokens,
            "score": self.affinity_weight * (affinity_tokens / plen)
            - (occupancy + queue_load),
        }

    def route(self, req: Request, queues: List[deque]) -> int:
        """Pick the admitting replica for one request (called once, at
        arrival). The full candidate table is recorded."""
        cands = []
        for i, eng in enumerate(self.engines):
            parts = self._score_parts(eng, len(queues[i]), req)
            parts["replica"] = i
            label = eng.replica
            if label:
                parts["label"] = label
            cands.append(parts)
        scores = [c["score"] for c in cands]
        best = int(np.argmax(scores))
        plain = [-(c["occupancy"] + c["queue_depth"]
                   / self.engines[i].max_slots)
                 for i, c in enumerate(cands)]
        if best != int(np.argmax(plain)):
            self.affinity_hits += 1     # affinity overrode pure load
        self.routed[best] += 1
        if len(self.decisions) < self.decision_capacity:
            self.decisions.append({"rid": req.rid, "chosen": best,
                                   "candidates": cands})
        if self.trace is not None:
            self.trace.route(req.rid, best, cands)
        return best

    # ------------------------------------------------------------------ #
    def serve(self, requests: Sequence[Request]) -> Dict[str, Any]:
        """Run the stream to completion across all replicas; returns the
        multi-replica report: pooled aggregate + per-replica snapshots +
        per-request records (each naming its replica). Each replica
        admits from its own queue and steps through its own
        ``ContinuousBatchingScheduler``."""
        t0 = time.perf_counter()
        pending = deque(sorted(requests, key=lambda r: r.arrival_s))
        # One request trace for the fleet, built when a replica streams.
        if self.trace is None and any(e.telemetry.enabled
                                      for e in self.engines):
            from ..monitor.request_trace import RequestTrace
            self.trace = RequestTrace()
        scheds = [ContinuousBatchingScheduler(
            eng, temperature=self.temperature, eos_token=self.eos_token,
            trace=self.trace, label=eng.replica or f"r{i}")
            for i, eng in enumerate(self.engines)]
        queues: List[deque] = [deque() for _ in self.engines]
        active: List[Dict[int, Request]] = [{} for _ in self.engines]
        replica_of: Dict[int, int] = {}

        while pending or any(queues) or any(active):
            now = time.perf_counter() - t0
            if self.max_wall_s is not None and now > self.max_wall_s:
                for sched, queue, live in zip(scheds, queues, active):
                    sched.abort(queue, live)
                break
            # 1. arrivals route to a replica queue immediately.
            while pending and pending[0].arrival_s <= now:
                req = pending.popleft()
                req.t_arrival = t0 + req.arrival_s
                if self.trace is not None:
                    self.trace.enqueue(req.rid, t=req.t_arrival)
                i = self.route(req, queues)
                replica_of[req.rid] = i
                queues[i].append(req)
            # 2. per-replica admissions (FCFS within the replica), then
            # one iteration for that replica's live slots.
            stepped = False
            for sched, queue, live in zip(scheds, queues, active):
                sched.admit(queue, live)
                stepped = sched.step(live) or stepped
            if not stepped and (pending or any(queues)):
                # When every replica is idle, nothing is in flight and no
                # future arrival can change the picture, a queued head
                # that still cannot admit NEVER will (its worst-case
                # block need exceeds its replica's per-group pool):
                # raise instead of spinning.
                if not pending and \
                        not any(e.active.any() for e in self.engines):
                    req = next(q[0] for q in queues if q)
                    raise RuntimeError(
                        f"request {req.rid} can never be admitted on "
                        f"its routed replica: {len(req.prompt)} prompt "
                        f"+ {req.max_new_tokens} new tokens exceeds "
                        "the block pool's per-group capacity")
                for eng in self.engines:
                    eng.telemetry.heartbeat()
                t_sl = time.perf_counter()
                time.sleep(self.idle_sleep_s)
                dt = time.perf_counter() - t_sl
                for eng, queue in zip(self.engines, queues):
                    eng.serving.ledger.note(
                        "admission_blocked" if queue else "idle", dt)

        wall = time.perf_counter() - t0
        # Each replica's stream drains its snapshot over the serve wall.
        per_replica = [sched.finish(wall) for sched in scheds]
        merged = ServingAggregator.merged(
            [e.serving for e in self.engines])
        report = dict(merged.snapshot(wall_s=wall))
        report["recompiles"] = sum(e.telemetry.recompile_count
                                   for e in self.engines)
        report["unfinished"] = len(pending) + sum(map(len, queues)) + \
            sum(map(len, active))
        report["replicas"] = per_replica
        report["router"] = {
            "replicas": len(self.engines),
            "routed": list(self.routed),
            "affinity_overrides": self.affinity_hits,
            "affinity_weight": self.affinity_weight,
            "decisions_recorded": len(self.decisions),
        }
        if self.trace is not None:
            report["trace"] = self.trace.summary()
        report["requests"] = request_records(requests, replica_of)
        return report


__all__ = ["ReplicaRouter"]
