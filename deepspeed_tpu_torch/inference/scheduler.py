"""Continuous batching: iteration-level scheduling over the engine's
slots (port of ``deepspeed_tpu/inference/scheduler.py``; pure host
code).

Every iteration the scheduler (1) admits arrived requests into free
slots — prefill runs as its own device operation and splices into the
cache — (2) runs ONE decode (or draft-then-verify) step for every live
slot, and (3) evicts the slots that finished. The arrival process is
OPEN-LOOP: requests carry arrival offsets and join the queue when the
wall clock passes them, so TTFT includes queue wait. Waits land in the
engine's goodput ledger (``idle`` before an arrival,
``admission_blocked`` while the head of the queue cannot be admitted);
requests abandoned at ``max_wall_s`` are reported to the engine's SLO
tracker. The JAX scheduler's request traces and ``recompiles`` key wait
for the port's telemetry.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request in the open-loop stream."""
    rid: int
    prompt: np.ndarray                  # [P] int32 token ids
    max_new_tokens: int = 16
    arrival_s: float = 0.0              # offset from serve() start
    # -- runtime state (scheduler-owned) --
    slot: Optional[int] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    t_arrival: float = 0.0              # absolute clock
    t_admit: Optional[float] = None     # slot acquired (queue wait end)
    t_first: Optional[float] = None     # first token produced (TTFT end)
    t_last: Optional[float] = None      # latest token produced
    admission_attempts: int = 0         # head-of-queue rejections

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.t_first is None \
            else self.t_first - self.t_arrival

    @property
    def queue_wait_s(self) -> Optional[float]:
        return None if self.t_admit is None \
            else self.t_admit - self.t_arrival

    @property
    def service_ttft_s(self) -> Optional[float]:
        if self.t_admit is None or self.t_first is None:
            return None
        return self.t_first - self.t_admit

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token AFTER the first; None for
        single-token responses."""
        if self.t_first is None or self.t_last is None \
                or len(self.out_tokens) < 2:
            return None
        return (self.t_last - self.t_first) / (len(self.out_tokens) - 1)


def synthetic_requests(n: int, prompt_len: Tuple[int, int] = (8, 16),
                       max_new_tokens: int = 16, rate_rps: float = 0.0,
                       vocab_size: int = 512, seed: int = 0
                       ) -> List[Request]:
    """Open-loop synthetic stream: Poisson arrivals at ``rate_rps`` (0 =
    all at t=0), uniform random prompts with lengths in ``prompt_len``
    (inclusive). The same seed gives the JAX package's stream."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    lo, hi = prompt_len
    for i in range(n):
        if rate_rps > 0 and i > 0:
            t += float(rng.exponential(1.0 / rate_rps))
        plen = int(rng.integers(lo, hi + 1))
        prompt = rng.integers(0, vocab_size, size=plen).astype(np.int32)
        out.append(Request(rid=i, prompt=prompt,
                           max_new_tokens=max_new_tokens, arrival_s=t))
    return out


def shared_prefix_requests(n: int, prefix_len: int = 32,
                           tail_len: Tuple[int, int] = (4, 12),
                           max_new_tokens: int = 16,
                           rate_rps: float = 0.0, vocab_size: int = 512,
                           seed: int = 0) -> List[Request]:
    """Shared-prefix stream: every request carries the SAME
    ``prefix_len``-token system prompt followed by a random tail with a
    length in ``tail_len`` (inclusive)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab_size, size=prefix_len).astype(np.int32)
    t = 0.0
    out = []
    lo, hi = tail_len
    for i in range(n):
        if rate_rps > 0 and i > 0:
            t += float(rng.exponential(1.0 / rate_rps))
        tail = rng.integers(0, vocab_size,
                            size=int(rng.integers(lo, hi + 1))
                            ).astype(np.int32)
        out.append(Request(rid=i,
                           prompt=np.concatenate([prefix, tail]),
                           max_new_tokens=max_new_tokens, arrival_s=t))
    return out


class ContinuousBatchingScheduler:
    """Per-iteration insert/evict over an InferenceEngine's slots."""

    def __init__(self, engine, temperature: float = 0.0,
                 eos_token: Optional[int] = None,
                 idle_sleep_s: float = 0.0005,
                 max_wall_s: Optional[float] = None):
        self.engine = engine
        self.temperature = float(temperature)
        self.eos_token = eos_token
        self.idle_sleep_s = float(idle_sleep_s)
        self.max_wall_s = max_wall_s

    def _finished(self, req: Request, slot_len: int) -> bool:
        if len(req.out_tokens) >= req.max_new_tokens:
            return True
        if self.eos_token is not None and req.out_tokens and \
                req.out_tokens[-1] == self.eos_token:
            return True
        # Slot full: the next decode would have nowhere to write.
        return slot_len >= self.engine.max_len

    def _complete(self, req: Request) -> None:
        self.engine.complete_request(
            req.rid, req.ttft_s or 0.0, req.tpot_s,
            prompt_tokens=len(req.prompt),
            new_tokens=len(req.out_tokens),
            queue_wait_s=req.queue_wait_s,
            service_ttft_s=req.service_ttft_s,
            admission_attempts=req.admission_attempts)

    def _reject(self, req: Request, queue_len: int) -> None:
        """Head-of-queue admission rejection (no slot, or the pool
        cannot cover the request's worst case): the request's attempt
        count, and the engine's count of rejections."""
        eng = self.engine
        req.admission_attempts += 1
        eng.note_admission_reject(req.rid, eng.last_admit_block or "no_slot",
                                  req.admission_attempts, queue_len)

    def _evict_finished(self, active: Dict[int, Request]) -> None:
        eng = self.engine
        for slot in list(active):
            req = active[slot]
            if self._finished(req, eng.context_len(slot)):
                self._complete(req)
                eng.release_slot(slot)
                del active[slot]

    def admit(self, queue: deque, active: Dict[int, Request]) -> None:
        """Admissions from the head of ``queue``, FCFS: when the head
        cannot be admitted (no slot, or the pool cannot cover its worst
        case) everything behind waits. Paged chunked prefill admits in
        one-slot-per-group batches (``prefill_many``); the other engines
        admit one request at a time (``prefill``). Admitted requests
        join ``active`` (slot -> request) unless their first token
        finished them."""
        eng = self.engine
        batched = eng.paged and eng.prefill_chunk > 0
        while queue:
            batch = []
            used: set = set()
            while queue:
                req = queue[0]
                slot = eng.select_slot(req.prompt, req.max_new_tokens,
                                       exclude_groups=used)
                if slot is None:
                    # With exclusions the refusal may only be this
                    # batch's one-slot-per-group shape.
                    if not used:
                        self._reject(req, len(queue))
                    break
                queue.popleft()
                req.t_admit = time.perf_counter()
                used.add(eng.group_of(slot))
                batch.append((req, slot))
                if not batched:
                    break
            if not batch:
                break
            if batched:
                results = eng.prefill_many(
                    [(slot, req.prompt, req.max_new_tokens)
                     for req, slot in batch], self.temperature)
            else:
                req, slot = batch[0]
                results = [eng.prefill(req.prompt, slot, self.temperature,
                                       max_new_tokens=req.max_new_tokens)]
            t_now = time.perf_counter()
            admitted: Dict[int, Request] = {}
            for (req, slot), (tok, _) in zip(batch, results):
                req.slot = slot
                req.t_first = req.t_last = t_now
                req.out_tokens = [tok]
                eng.activate_slot(slot, len(req.prompt), tok)
                eng.serving.note_prefill(len(req.prompt))
                admitted[slot] = req
            self._evict_finished(admitted)
            active.update(admitted)

    def step(self, active: Dict[int, Request]) -> bool:
        """One decode (or draft-then-verify) iteration for every live
        slot, then evict the slots that finished; False when no slot is
        live. Speculative decoding is greedy-only: sampling streams fall
        back to plain decode."""
        if not active:
            return False
        eng = self.engine
        if eng.spec_enabled and self.temperature == 0.0:
            emitted, n_new = eng.spec_decode_once(self.temperature)
            t_now = time.perf_counter()
            for slot, req in active.items():
                budget = req.max_new_tokens - len(req.out_tokens)
                toks = [int(t) for t in emitted[slot, :int(n_new[slot])]]
                if self.eos_token is not None and self.eos_token in toks:
                    toks = toks[:toks.index(self.eos_token) + 1]
                req.out_tokens.extend(toks[:max(budget, 0)])
                req.t_last = t_now
        else:
            sampled, _ = eng.decode_once(self.temperature)
            t_now = time.perf_counter()
            for slot, req in active.items():
                req.out_tokens.append(int(sampled[slot]))
                req.t_last = t_now
        self._evict_finished(active)
        return True

    def abort(self, queue: deque, active: Dict[int, Request]) -> None:
        """Abandon the run without leaking capacity: the slots in flight
        abort as ``max_wall``, the queued requests as ``starved``; each
        counts against the SLO's availability."""
        eng = self.engine
        for slot in list(active):
            eng.abort_request(active[slot].rid, "max_wall")
            eng.release_slot(slot)
            del active[slot]
        for req in queue:
            eng.abort_request(req.rid, "starved")

    def serve(self, requests: Sequence[Request]) -> Dict[str, Any]:
        """Run the stream to completion; returns the serving report (the
        aggregator snapshot + per-request records)."""
        eng = self.engine
        ledger = eng.serving.ledger
        t0 = time.perf_counter()
        pending = deque(sorted(requests, key=lambda r: r.arrival_s))
        queue: deque = deque()
        active: Dict[int, Request] = {}
        while pending or queue or active:
            now = time.perf_counter() - t0
            if self.max_wall_s is not None and now > self.max_wall_s:
                self.abort(queue, active)
                break
            # 1. open-loop arrivals join the queue on schedule.
            while pending and pending[0].arrival_s <= now:
                req = pending.popleft()
                req.t_arrival = t0 + req.arrival_s
                queue.append(req)
            # 2. admissions; 3. one iteration for the live slots.
            self.admit(queue, active)
            if self.step(active):
                continue
            if queue:
                # Queued work, no free capacity, nothing decoding: unless
                # nothing can EVER free what the head request needs, wait.
                if not pending and not eng.active.any():
                    req = queue[0]
                    raise RuntimeError(
                        f"request {req.rid} can never be admitted: "
                        f"{len(req.prompt)} prompt + "
                        f"{req.max_new_tokens} new tokens exceeds the "
                        "block pool's per-group capacity")
                t_sl = time.perf_counter()
                time.sleep(self.idle_sleep_s)
                ledger.note("admission_blocked", time.perf_counter() - t_sl)
            elif pending:
                # Idle ahead of the next arrival — open-loop wait.
                gap = pending[0].arrival_s - (time.perf_counter() - t0)
                if gap > 0:
                    t_sl = time.perf_counter()
                    time.sleep(min(gap, self.idle_sleep_s))
                    ledger.note("idle", time.perf_counter() - t_sl)

        wall = time.perf_counter() - t0
        report = dict(eng.serving.snapshot(wall_s=wall))
        report["unfinished"] = len(pending) + len(queue) + len(active)
        report["requests"] = request_records(requests)
        return report


def request_records(requests: Sequence[Request],
                    replica_of: Optional[Dict[Any, int]] = None
                    ) -> List[Dict[str, Any]]:
    """The report's per-request records by rid, each naming its replica
    when ``replica_of`` is given."""
    out = []
    for r in sorted(requests, key=lambda r: r.rid):
        rec: Dict[str, Any] = {"rid": r.rid}
        if replica_of is not None:
            rec["replica"] = replica_of.get(r.rid)
        rec.update(
            prompt_tokens=len(r.prompt), new_tokens=len(r.out_tokens),
            ttft_ms=round(r.ttft_s * 1e3, 3)
            if r.ttft_s is not None else None,
            tpot_ms=round(r.tpot_s * 1e3, 3)
            if r.tpot_s is not None else None,
            tokens=list(map(int, r.out_tokens)))
        out.append(rec)
    return out


__all__ = ["Request", "synthetic_requests", "shared_prefix_requests",
           "ContinuousBatchingScheduler", "request_records"]
