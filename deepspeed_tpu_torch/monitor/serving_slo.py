"""Per-replica serving goodput ledger and SLO burn-rate tracking (port
of ``deepspeed_tpu/monitor/serving_slo.py``; pure host arithmetic, the
same buckets, keys, rounding and errors).

Every wall-second of a serving replica lands in exactly one bucket and
the buckets sum to the wall:

- ``prefill``            — prompt ingestion (chunked or whole).
- ``decode_useful``      — decode/verify wall that emitted accepted
                           tokens (for speculative iterations, the
                           accepted-row share of the verify wall).
- ``spec_wasted``        — the drafted-but-rejected share of verify
                           wall.
- ``admission_blocked``  — queued work existed but the reservation gate /
                           slot pool refused admission and nothing else
                           ran.
- ``idle``               — no queued work (open-loop arrival gaps).
- ``other``              — the residual (host loop overhead, and peer
                           replicas' steps when several engines share
                           one process).

``other`` is computed at settle time, never noted directly, so the
sum-to-wall identity holds by construction and the real check is the
``consistent`` flag: a residual below -1% of wall means double
attribution and is surfaced, not clamped.

``SLOTracker`` scores each completed request against TTFT/TPOT targets
and computes attainment plus the burn rate of the error budget
``1 - availability``. The inputs are host clocks and host counters: no
device sync.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

SERVING_BUCKETS = ("prefill", "decode_useful", "spec_wasted",
                   "admission_blocked", "idle")

# Residual tolerance: |negative residual| beyond this fraction of wall
# marks the ledger inconsistent (double-attributed time).
_TOL = 0.01


class ServingGoodputLedger:
    """Attribute a serving replica's wall to SERVING_BUCKETS + residual.

    Buckets are measured independently (each caller notes the wall it
    directly measured); ``snapshot(wall_s)`` settles the residual into
    ``other`` and flags over-attribution instead of hiding it.
    """

    def __init__(self, label: Optional[str] = None, clock=time.perf_counter):
        self.label = label
        self._clock = clock
        self.t0 = clock()
        self._noted: Dict[str, float] = {b: 0.0 for b in SERVING_BUCKETS}

    def note(self, bucket: str, seconds: float) -> None:
        """Attribute ``seconds`` of directly-measured wall to ``bucket``."""
        if bucket not in self._noted:
            raise ValueError(
                f"unknown serving bucket {bucket!r}; "
                f"expected one of {SERVING_BUCKETS}")
        if seconds > 0:
            self._noted[bucket] += float(seconds)

    def reset(self) -> None:
        self.t0 = self._clock()
        for b in self._noted:
            self._noted[b] = 0.0

    def noted_total(self) -> float:
        return sum(self._noted.values())

    def snapshot(self, wall_s: Optional[float] = None) -> dict:
        """Settle against ``wall_s`` (default: elapsed since construction).

        Non-destructive: callers can snapshot at every report boundary
        and again at serve end.
        """
        wall = float(wall_s) if wall_s is not None else self._clock() - self.t0
        noted = self.noted_total()
        other = wall - noted
        tol = _TOL * max(wall, 1e-9)
        out: dict = {"wall_s": wall}
        if self.label:
            out["label"] = self.label
        for b in SERVING_BUCKETS:
            out[f"{b}_s"] = self._noted[b]
        # other is the residual: the identity sum(buckets)+other == wall
        # holds by construction; a residual below -1% of wall means the
        # measured buckets overlap (double attribution) — surfaced, not
        # clamped.
        out["other_s"] = other
        out["accounted_fraction"] = (noted + max(other, 0.0)) / max(wall, 1e-9)
        out["consistent"] = bool(other >= -tol)
        return out

    @classmethod
    def merged(cls, snapshots: Sequence[dict]) -> dict:
        """Pool per-replica ledger snapshots (bucket-wise sums).

        Walls sum too: replicas that interleave on one process (the
        router's engines on one card) double-count real time in the
        merged wall — honest for bucket *shares*, not absolute fleet
        wall.
        """
        snaps = [s for s in snapshots if isinstance(s, dict)]
        out: dict = {"wall_s": sum(float(s.get("wall_s", 0.0)) for s in snaps),
                     "replicas": len(snaps)}
        noted = 0.0
        for b in SERVING_BUCKETS:
            tot = sum(float(s.get(f"{b}_s", 0.0)) for s in snaps)
            out[f"{b}_s"] = tot
            noted += tot
        other = out["wall_s"] - noted
        out["other_s"] = other
        out["accounted_fraction"] = ((noted + max(other, 0.0))
                                     / max(out["wall_s"], 1e-9))
        out["consistent"] = all(bool(s.get("consistent", True)) for s in snaps)
        return out


class SLOTracker:
    """Windowed SLO attainment + error-budget burn rate.

    A completed request is *good* when its TTFT and TPOT are both
    inside target (an unset target — 0 — always passes).  Aborted or
    starved-to-death requests count as bad via ``observe_failure``.

    - attainment  = good / total
    - error budget = 1 - availability_target
    - burn_rate   = (1 - attainment) / error_budget
      (> 1: the budget is being consumed faster than the SLO allows).

    ``windowed`` recomputes both over the trailing ``window_s`` seconds
    so a burst of misses is visible before the cumulative numbers move.
    """

    def __init__(self, ttft_ms: float = 0.0, tpot_ms: float = 0.0,
                 availability: float = 0.99, window_s: float = 60.0,
                 clock=time.perf_counter):
        if not (0.0 < availability < 1.0):
            raise ValueError("availability target must be in (0, 1)")
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        self.ttft_ms = float(ttft_ms)
        self.tpot_ms = float(tpot_ms)
        self.availability = float(availability)
        self.window_s = float(window_s)
        self._clock = clock
        # (t, good) per outcome; pruned lazily against window_s.
        self._outcomes: List[tuple] = []
        self.total = 0
        self.good = 0
        self.ttft_misses = 0
        self.tpot_misses = 0
        self.failures = 0

    @property
    def enabled(self) -> bool:
        return self.ttft_ms > 0 or self.tpot_ms > 0

    def observe(self, ttft_s: Optional[float], tpot_s: Optional[float],
                t: Optional[float] = None) -> bool:
        """Score one completed request; returns whether it met the SLO."""
        good = True
        if self.ttft_ms > 0 and ttft_s is not None \
                and ttft_s * 1e3 > self.ttft_ms:
            good = False
            self.ttft_misses += 1
        if self.tpot_ms > 0 and tpot_s is not None \
                and tpot_s * 1e3 > self.tpot_ms:
            good = False
            self.tpot_misses += 1
        self.total += 1
        if good:
            self.good += 1
        self._outcomes.append((t if t is not None else self._clock(), good))
        return good

    def observe_failure(self, t: Optional[float] = None) -> None:
        """An aborted / never-served request: counts against availability."""
        self.total += 1
        self.failures += 1
        self._outcomes.append((t if t is not None else self._clock(), False))

    def _burn(self, good: int, total: int) -> dict:
        att = good / total if total else None
        budget = 1.0 - self.availability
        burn = None if att is None else (1.0 - att) / max(budget, 1e-9)
        return {"attainment": att, "burn_rate": burn}

    def snapshot(self, now: Optional[float] = None) -> dict:
        now = now if now is not None else self._clock()
        cutoff = now - self.window_s
        w = [(t, g) for (t, g) in self._outcomes if t >= cutoff]
        self._outcomes = w  # lazy prune
        out = {
            "targets": {"ttft_ms": self.ttft_ms, "tpot_ms": self.tpot_ms,
                        "availability": self.availability,
                        "window_s": self.window_s},
            "total": self.total,
            "good": self.good,
            "ttft_misses": self.ttft_misses,
            "tpot_misses": self.tpot_misses,
            "failures": self.failures,
        }
        out.update(self._burn(self.good, self.total))
        wg = sum(1 for (_, g) in w if g)
        out["window"] = {"n": len(w)}
        out["window"].update(self._burn(wg, len(w)))
        return out

    @classmethod
    def merged(cls, trackers: Sequence["SLOTracker"]) -> Optional[dict]:
        """Fleet-level snapshot: pool outcomes across replica trackers.

        Targets are taken from the first tracker (the fleet shares one
        SLO); window attainment pools each tracker's trailing window.
        """
        live = [t for t in trackers if t is not None and t.enabled]
        if not live:
            return None
        base = live[0]
        out = {
            "targets": {"ttft_ms": base.ttft_ms, "tpot_ms": base.tpot_ms,
                        "availability": base.availability,
                        "window_s": base.window_s},
            "replicas": len(live),
            "total": sum(t.total for t in live),
            "good": sum(t.good for t in live),
            "ttft_misses": sum(t.ttft_misses for t in live),
            "tpot_misses": sum(t.tpot_misses for t in live),
            "failures": sum(t.failures for t in live),
        }
        out.update(base._burn(out["good"], out["total"]))
        now = base._clock()
        wn = wg = 0
        for t in live:
            cutoff = now - t.window_s
            w = [(ts, g) for (ts, g) in t._outcomes if ts >= cutoff]
            wn += len(w)
            wg += sum(1 for (_, g) in w if g)
        out["window"] = {"n": wn}
        out["window"].update(base._burn(wg, wn))
        return out


__all__ = ["SERVING_BUCKETS", "ServingGoodputLedger", "SLOTracker"]
