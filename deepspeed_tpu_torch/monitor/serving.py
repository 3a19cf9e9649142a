"""Per-request serving metrics (port of
``deepspeed_tpu/monitor/serving.py``; pure host code).

Serving accounts per REQUEST (TTFT — time to first token, queue wait
included; TPOT — mean time per output token after the first) and per
decode ITERATION (occupancy = active slots / total slots). Inputs are host
wall-clock times and host counters, so aggregation adds no device sync.
``ServingAggregator.snapshot()`` has the JAX package's keys for the same
notes; ``ServingAggregator.merged`` pools several replicas' raw samples.
The goodput ledger and SLO tracker (``monitor/serving_slo.py``) ride the
snapshot as ``ledger`` and ``slo``.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile on an already-sorted list."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[k])


def _pcts(vals: List[float]) -> Dict[str, float]:
    s = sorted(vals)
    return {"p50": round(percentile(s, 50), 3),
            "p95": round(percentile(s, 95), 3),
            "mean": round(sum(s) / len(s), 3) if s else 0.0,
            "n": len(s)}


class ServingAggregator:
    """Accumulates per-iteration and per-request serving metrics.

    ``label`` names the replica this aggregator feeds (the multi-
    replica router runs one engine — and one aggregator — per replica);
    snapshots carry it so no consumer interleaves two replicas'
    percentile streams into one misleading distribution. ``ServingAggregator.merged``
    builds the honest aggregate view by POOLING the raw samples.
    """

    def __init__(self, max_slots: int, label: Optional[str] = None):
        self.max_slots = max(1, int(max_slots))
        self.label = label
        self.t0 = time.perf_counter()
        self.iterations = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.completed = 0
        # Paged-cache accounting (engine-fed; stays empty — and out of
        # the snapshot — on slot-major engines that predate it).
        self.prompt_tokens_admitted = 0
        self.cached_tokens_admitted = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        # Analytic attend-work accounting (engine-fed, paged engines
        # only): the same iterations priced BOTH ways — the paged
        # kernel's live-context term vs the one-hot contraction's
        # pool-capacity term (the JAX package's plain attend). ``attend_mode`` names which one actually
        # ran; the totals are host arithmetic (projections), never
        # device measurements.
        self.attend_mode: Optional[str] = None
        self.attend_flops_kernel = 0
        self.attend_flops_onehot = 0
        self.attend_bytes_kernel = 0
        self.attend_bytes_onehot = 0
        self.attend_tokens = 0
        # Admission-rejection accounting (the reservation gate's retries
        # used to be invisible): total rejected reservations plus the
        # per-completed-request attempt counts.
        self.reservations_rejected = 0
        self._admission_attempts: List[float] = []
        # Optional overlays (engine-attached): a ServingGoodputLedger
        # and an SLOTracker (monitor/serving_slo.py) — or, on a merged
        # aggregator, their already-settled snapshot dicts. When unset
        # the snapshot omits the sections (skip-never-fail downstream).
        self.ledger: Optional[Any] = None
        self.slo: Optional[Any] = None
        self._occupancy: List[float] = []
        self._decode_ms: List[float] = []
        self._ttft_ms: List[float] = []
        self._tpot_ms: List[float] = []
        self._queue_wait_ms: List[float] = []
        self._service_ttft_ms: List[float] = []
        self._hbm_per_token: List[float] = []
        self._cache_bytes: List[int] = []

    # ---- per decode iteration ---- #
    def note_iteration(self, active_slots: int, decode_s: float,
                       cache_bytes: Optional[int] = None,
                       context_tokens: Optional[int] = None,
                       emitted_tokens: Optional[int] = None) -> None:
        """``emitted_tokens`` defaults to one per active slot (plain
        decode); the speculative verify step passes the real count.
        ``cache_bytes`` / ``context_tokens`` sample the HBM the cache
        holds against the tokens it serves — the hbm_bytes_per_token
        series the paging win is measured on."""
        self.iterations += 1
        self.decode_tokens += int(emitted_tokens
                                  if emitted_tokens is not None
                                  else active_slots)
        self._occupancy.append(active_slots / self.max_slots)
        self._decode_ms.append(decode_s * 1e3)
        if cache_bytes is not None and context_tokens:
            self._cache_bytes.append(int(cache_bytes))
            self._hbm_per_token.append(cache_bytes / context_tokens)

    def note_prefill(self, prompt_tokens: int) -> None:
        self.prefill_tokens += int(prompt_tokens)

    def note_admit(self, prompt_tokens: int, cached_tokens: int) -> None:
        """Prefix-cache accounting at admission: how many of the
        prompt's tokens rode already-resident blocks."""
        self.prompt_tokens_admitted += int(prompt_tokens)
        self.cached_tokens_admitted += int(cached_tokens)

    def note_spec(self, proposed: int, accepted: int) -> None:
        self.spec_proposed += int(proposed)
        self.spec_accepted += int(accepted)

    def note_attend(self, flops_kernel: int, flops_onehot: int,
                    bytes_kernel: int, bytes_onehot: int,
                    tokens: int) -> None:
        """One iteration's analytic attend work, both ways (see
        InferenceEngine._attend_work); ``tokens`` are the iteration's
        emitted tokens — the per-token denominators."""
        self.attend_flops_kernel += int(flops_kernel)
        self.attend_flops_onehot += int(flops_onehot)
        self.attend_bytes_kernel += int(bytes_kernel)
        self.attend_bytes_onehot += int(bytes_onehot)
        self.attend_tokens += int(tokens)

    def note_reject(self) -> None:
        """One reservation-gate / slot-pool admission rejection."""
        self.reservations_rejected += 1

    # ---- per completed request ---- #
    def note_request(self, ttft_s: float, tpot_s: Optional[float],
                     new_tokens: int,
                     queue_wait_s: Optional[float] = None,
                     service_ttft_s: Optional[float] = None,
                     admission_attempts: Optional[int] = None) -> None:
        """``queue_wait_s``/``service_ttft_s`` split the end-to-end TTFT
        at the admission instant (router backlog vs slow prefill —
        indistinguishable in the pooled ttft figure alone)."""
        self.completed += 1
        self._ttft_ms.append(ttft_s * 1e3)
        if tpot_s is not None:
            self._tpot_ms.append(tpot_s * 1e3)
        if queue_wait_s is not None:
            self._queue_wait_ms.append(queue_wait_s * 1e3)
        if service_ttft_s is not None:
            self._service_ttft_ms.append(service_ttft_s * 1e3)
        if admission_attempts is not None:
            self._admission_attempts.append(float(admission_attempts))

    @property
    def occupancy_mean(self) -> float:
        if not self._occupancy:
            return 0.0
        return sum(self._occupancy) / len(self._occupancy)

    def snapshot(self, wall_s: Optional[float] = None) -> Dict[str, Any]:
        """The canonical serving summary. ``tokens_per_s`` counts
        GENERATED (decode) tokens over the serve wall — prefill tokens
        are reported separately, not inflated into throughput. Fields
        the engine never fed (no paged cache, no spec decode) are
        omitted."""
        wall = wall_s if wall_s is not None \
            else time.perf_counter() - self.t0
        snap = {
            "iterations": self.iterations,
            "completed": self.completed,
            "occupancy_mean": round(self.occupancy_mean, 4),
            "occupancy_p50": round(
                percentile(sorted(self._occupancy), 50), 4),
            "decode_tokens": self.decode_tokens,
            "prefill_tokens": self.prefill_tokens,
            "tokens_per_s": round(self.decode_tokens / wall, 3)
            if wall > 0 else 0.0,
            "wall_s": round(wall, 6),
            "ttft_ms": _pcts(self._ttft_ms),
            "tpot_ms": _pcts(self._tpot_ms),
            "decode_step_ms": _pcts(self._decode_ms),
        }
        if self.label is not None:
            snap["replica"] = self.label
        if self._queue_wait_ms:
            snap["queue_wait_ms"] = _pcts(self._queue_wait_ms)
        if self._service_ttft_ms:
            snap["service_ttft_ms"] = _pcts(self._service_ttft_ms)
        if self.reservations_rejected or self._admission_attempts:
            snap["admission"] = {
                "reservations_rejected": self.reservations_rejected,
                "attempts": _pcts(self._admission_attempts),
            }
        if self.ledger is not None:
            snap["ledger"] = self.ledger.snapshot(wall_s=wall) \
                if hasattr(self.ledger, "snapshot") else self.ledger
        if self.slo is not None:
            slo = self.slo.snapshot() if hasattr(self.slo, "snapshot") \
                else self.slo
            if slo is not None:
                snap["slo"] = slo
        if self._hbm_per_token:
            snap["hbm_bytes_per_token"] = _pcts(self._hbm_per_token)
            snap["cache_bytes_p95"] = int(percentile(
                sorted(self._cache_bytes), 95))
        if self.prompt_tokens_admitted:
            snap["prefix"] = {
                "prompt_tokens": self.prompt_tokens_admitted,
                "cached_tokens": self.cached_tokens_admitted,
                "hit_rate": round(self.cached_tokens_admitted /
                                  self.prompt_tokens_admitted, 4),
            }
        if self.spec_proposed:
            snap["spec"] = {
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "acceptance_rate": round(self.spec_accepted /
                                         self.spec_proposed, 4),
            }
        if self.attend_tokens:
            t = self.attend_tokens
            snap["attend"] = {
                "mode": self.attend_mode or "onehot",
                "flops_per_token": {
                    "kernel": round(self.attend_flops_kernel / t, 1),
                    "onehot": round(self.attend_flops_onehot / t, 1)},
                "hbm_bytes_per_token": {
                    "kernel": round(self.attend_bytes_kernel / t, 1),
                    "onehot": round(self.attend_bytes_onehot / t, 1)},
                "projection": "analytic (host-priced, not a device "
                              "measurement)",
            }
            if self.attend_bytes_kernel:
                # The structural headline: one-hot HBM traffic over the
                # kernel's, same iterations — >1 means the pool
                # outweighs the live contexts it served.
                snap["attend_work_ratio"] = round(
                    self.attend_bytes_onehot / self.attend_bytes_kernel,
                    4)
        return snap

    @classmethod
    def merged(cls, aggs: List["ServingAggregator"],
               label: str = "aggregate") -> "ServingAggregator":
        """The honest aggregate over replicas: raw samples POOLED, not
        percentiles-of-percentiles, counters summed, capacity summed."""
        out = cls(sum(a.max_slots for a in aggs) or 1, label=label)
        for a in aggs:
            out.iterations += a.iterations
            out.decode_tokens += a.decode_tokens
            out.prefill_tokens += a.prefill_tokens
            out.completed += a.completed
            out.prompt_tokens_admitted += a.prompt_tokens_admitted
            out.cached_tokens_admitted += a.cached_tokens_admitted
            out.spec_proposed += a.spec_proposed
            out.spec_accepted += a.spec_accepted
            out.attend_flops_kernel += a.attend_flops_kernel
            out.attend_flops_onehot += a.attend_flops_onehot
            out.attend_bytes_kernel += a.attend_bytes_kernel
            out.attend_bytes_onehot += a.attend_bytes_onehot
            out.attend_tokens += a.attend_tokens
            if out.attend_mode is None:
                out.attend_mode = a.attend_mode
            # Occupancy normalizes per-replica (active/its own slots):
            # pooling the normalized samples keeps the mean meaningful
            # as "fraction of owned capacity busy".
            out._occupancy.extend(a._occupancy)
            out._decode_ms.extend(a._decode_ms)
            out._ttft_ms.extend(a._ttft_ms)
            out._tpot_ms.extend(a._tpot_ms)
            out._queue_wait_ms.extend(a._queue_wait_ms)
            out._service_ttft_ms.extend(a._service_ttft_ms)
            out._admission_attempts.extend(a._admission_attempts)
            out.reservations_rejected += a.reservations_rejected
            out._hbm_per_token.extend(a._hbm_per_token)
            out._cache_bytes.extend(a._cache_bytes)
        # Fleet-level SLO/ledger views: pooled outcomes and bucket-wise
        # sums, stored as settled dicts (a merged aggregator keeps
        # accumulating nothing).
        from .serving_slo import ServingGoodputLedger, SLOTracker
        trackers = [a.slo for a in aggs if isinstance(a.slo, SLOTracker)]
        if trackers:
            out.slo = SLOTracker.merged(trackers)
        led = [a.ledger.snapshot() for a in aggs
               if a.ledger is not None and hasattr(a.ledger, "snapshot")]
        led += [a.ledger for a in aggs if isinstance(a.ledger, dict)]
        if led:
            out.ledger = ServingGoodputLedger.merged(led)
        return out


__all__ = ["ServingAggregator", "percentile"]
