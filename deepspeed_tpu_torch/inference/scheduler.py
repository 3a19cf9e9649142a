"""Continuous batching: iteration-level scheduling over the engine's
slots (port of ``deepspeed_tpu/inference/scheduler.py``; pure host
code).

Every iteration the scheduler (1) admits arrived requests into free
slots — prefill runs as its own device operation and splices into the
paged cache — (2) runs ONE decode (or draft-then-verify) step for every
live slot, and (3) evicts the slots that finished. The arrival process
is OPEN-LOOP: requests carry arrival offsets and join the queue when the
wall clock passes them, so TTFT includes queue wait.
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

    def _reject(self, req: Request) -> None:
        """Head-of-queue admission rejection (no slot, or the pool
        cannot cover the request's worst case)."""
        req.admission_attempts += 1
        self.engine.serving.note_reject()

    def serve(self, requests: Sequence[Request]) -> Dict[str, Any]:
        """Run the stream to completion; returns the serving report (the
        aggregator snapshot + per-request records)."""
        eng = self.engine
        t0 = time.perf_counter()
        pending = deque(sorted(requests, key=lambda r: r.arrival_s))
        queue: deque = deque()
        active: Dict[int, Request] = {}
        # Speculative decoding is greedy-only: sampling streams fall back
        # to plain decode.
        spec = eng.spec_enabled and self.temperature == 0.0

        while pending or queue or active:
            now = time.perf_counter() - t0
            if self.max_wall_s is not None and now > self.max_wall_s:
                # Abandon the run without leaking capacity.
                for slot in list(active):
                    eng.release_slot(slot)
                    del active[slot]
                break
            # 1. open-loop arrivals join the queue on schedule.
            while pending and pending[0].arrival_s <= now:
                req = pending.popleft()
                req.t_arrival = t0 + req.arrival_s
                queue.append(req)
            # 2. admissions, FCFS: when the head of the queue cannot be
            # admitted (no slot, or the pool cannot cover its worst case)
            # everything behind waits. Chunked prefill admits in
            # one-slot-per-group batches (``prefill_many``); whole-prompt
            # prefill admits one request at a time (``prefill``).
            batched = eng.prefill_chunk > 0
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
                            self._reject(req)
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
                for (req, slot), (tok, _) in zip(batch, results):
                    req.slot = slot
                    req.t_first = req.t_last = t_now
                    req.out_tokens = [tok]
                    eng.activate_slot(slot, len(req.prompt), tok)
                    eng.serving.note_prefill(len(req.prompt))
                    if self._finished(req, eng.context_len(slot)):
                        self._complete(req)
                        eng.release_slot(slot)
                    else:
                        active[slot] = req
            # 3. one decode (or draft-then-verify) iteration for every
            # live slot.
            if active and spec:
                emitted, n_new = eng.spec_decode_once(self.temperature)
                t_now = time.perf_counter()
                for slot in list(active):
                    req = active[slot]
                    budget = req.max_new_tokens - len(req.out_tokens)
                    toks = [int(t) for t in emitted[slot, :int(n_new[slot])]]
                    if self.eos_token is not None and \
                            self.eos_token in toks:
                        toks = toks[:toks.index(self.eos_token) + 1]
                    req.out_tokens.extend(toks[:max(budget, 0)])
                    req.t_last = t_now
                    if self._finished(req, eng.context_len(slot)):
                        self._complete(req)
                        eng.release_slot(slot)
                        del active[slot]
            elif active:
                sampled, _ = eng.decode_once(self.temperature)
                t_now = time.perf_counter()
                for slot in list(active):
                    req = active[slot]
                    req.out_tokens.append(int(sampled[slot]))
                    req.t_last = t_now
                    if self._finished(req, eng.context_len(slot)):
                        self._complete(req)
                        eng.release_slot(slot)
                        del active[slot]
            elif pending and not queue:
                # Idle ahead of the next arrival — open-loop wait.
                gap = pending[0].arrival_s - (time.perf_counter() - t0)
                if gap > 0:
                    time.sleep(min(gap, self.idle_sleep_s))
            elif queue:
                # Queued work, no free capacity, nothing decoding: unless
                # nothing can EVER free what the head request needs, wait.
                if not active and not pending and not eng.active.any():
                    req = queue[0]
                    raise RuntimeError(
                        f"request {req.rid} can never be admitted: "
                        f"{len(req.prompt)} prompt + "
                        f"{req.max_new_tokens} new tokens exceeds the "
                        "block pool's per-group capacity")
                time.sleep(self.idle_sleep_s)

        wall = time.perf_counter() - t0
        report = dict(eng.serving.snapshot(wall_s=wall))
        report["unfinished"] = len(pending) + len(queue) + len(active)
        report["requests"] = [
            {"rid": r.rid, "prompt_tokens": len(r.prompt),
             "new_tokens": len(r.out_tokens),
             "ttft_ms": round(r.ttft_s * 1e3, 3)
             if r.ttft_s is not None else None,
             "tpot_ms": round(r.tpot_s * 1e3, 3)
             if r.tpot_s is not None else None,
             "tokens": list(map(int, r.out_tokens))}
            for r in sorted(requests, key=lambda r: r.rid)]
        return report


__all__ = ["Request", "synthetic_requests", "shared_prefix_requests",
           "ContinuousBatchingScheduler"]
