"""Measured-vs-analytic reconciliation: profile buckets against roofline
floors (port of ``deepspeed_tpu/monitor/reconcile.py``, as it is).

Joins a :mod:`monitor.profile_ingest` per-step wall decomposition (what
the device *actually* spent its time on) against the
:mod:`monitor.cost_model` analytic per-path floors (what perfect
execution *should* cost) and answers three questions:

1. **How far over the floor is each component?** Per component
   ``measured_over_floor`` ratio: measured compute-side busy time
   (gemm + pallas + unattributed device work) vs the fused per-step
   ``max(t_compute, t_hbm)`` floor; ``collective_ici`` wall vs the
   summed ``t_comm`` floor; ``collective_dcn`` wall vs ``t_dcn``.
2. **Did the predicted bound come true?** The cost model predicts a
   binding ceiling per step (``BOUND_COMPUTE``/``HBM``/``INTERCONNECT``
   /``DCN``); the dominant measured bucket either confirms it
   (``verdict: "match"``) or contradicts it (``"mismatch"`` — the
   interesting case: e.g. predicted compute-bound but the wire or the
   host dominates the wall).
3. **Where should a human look?** ``divergences`` lists every component
   whose measured wall exceeds its floor by more than the configurable
   ``threshold`` (ratio for floored components; for zero-floor
   components like ``host``, a fraction of the per-step wall) — each one
   becomes a structured ``reconcile_divergence`` telemetry event.

Pure host-side arithmetic over already-computed dicts — no device
work; runs at the telemetry report boundary.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from .cost_model import (BOUND_COMPUTE, BOUND_DCN, BOUND_HBM,
                         BOUND_INTERCONNECT)

__all__ = ["reconcile", "divergence_events",
           "DEFAULT_THRESHOLD", "DEFAULT_HOST_FRAC"]

# A component this far over its analytic floor is flagged. 3x is lax on
# purpose: the CPU and tiny models sit far off the roofline; the knob
# (telemetry.profile.divergence_threshold) tightens it on the card.
DEFAULT_THRESHOLD = 3.0
# Zero-floor components (host transfers/stalls have no analytic floor —
# ideally they don't exist) diverge past this fraction of the step wall.
DEFAULT_HOST_FRAC = 0.10

# Which measured bucket confirms which predicted bound. gemm/pallas busy
# time realizes both the compute and the HBM ceiling (a fused kernel is
# simultaneously doing flops and streaming bytes — the trace cannot
# split them); idle confirms nothing.
_BUCKET_CONFIRMS = {
    "gemm": (BOUND_COMPUTE, BOUND_HBM),
    "pallas": (BOUND_COMPUTE, BOUND_HBM),
    "unattributed": (BOUND_COMPUTE, BOUND_HBM),
    "collective_ici": (BOUND_INTERCONNECT,),
    "collective_dcn": (BOUND_DCN,),
}


def _ratio(measured: float, floor: float) -> Optional[float]:
    if floor <= 1e-9:
        return None
    return round(measured / floor, 4)


def _step_floors(cost_model: Dict[str, Any]) -> Dict[str, float]:
    """Fused per-step component floors (ms) from the cost-model payload:
    sum over the step's paths, weighted by invocations/step. The
    compute-side floor takes ``max(t_compute, t_hbm)`` per path (they
    overlap inside one path), then adds across paths (the step runs its
    paths one after another)."""
    step = cost_model.get("step") or {}
    paths = cost_model.get("paths") or {}
    floors = {"compute": 0.0, "collective_ici": 0.0, "collective_dcn": 0.0}
    for name, weight in (step.get("paths") or {}).items():
        p = paths.get(name)
        if not p or not p.get("available"):
            continue
        w = float(weight)
        floors["compute"] += max(p.get("t_compute_ms", 0.0),
                                 p.get("t_hbm_ms", 0.0)) * w
        floors["collective_ici"] += p.get("t_comm_ms", 0.0) * w
        floors["collective_dcn"] += p.get("t_dcn_ms", 0.0) * w
    return {k: round(v, 6) for k, v in floors.items()}


def reconcile(decomposition: Dict[str, Any],
              cost_model: Dict[str, Any],
              threshold: float = DEFAULT_THRESHOLD,
              host_frac: float = DEFAULT_HOST_FRAC) -> Dict[str, Any]:
    """Join one ingest decomposition against one cost-model payload.

    ``decomposition`` is :func:`profile_ingest.ingest`'s summary (needs
    ``per_step_ms`` + ``per_step_wall_ms``); ``cost_model`` is
    :func:`cost_model.build_cost_model`'s payload. Returns the
    JSONL-ready reconciliation record; feed it to
    :func:`divergence_events` for the telemetry event list.
    """
    per_step = decomposition.get("per_step_ms") or {}
    wall_ms = float(decomposition.get("per_step_wall_ms", 0.0) or 0.0)
    floors = _step_floors(cost_model)

    compute_busy = (per_step.get("gemm", 0.0) + per_step.get("pallas", 0.0)
                    + per_step.get("unattributed", 0.0))
    components: Dict[str, Dict[str, Any]] = {
        "compute": {
            "measured_ms": round(compute_busy, 6),
            "floor_ms": floors["compute"],
            "measured_over_floor": _ratio(compute_busy, floors["compute"]),
        },
        "collective_ici": {
            "measured_ms": round(per_step.get("collective_ici", 0.0), 6),
            "floor_ms": floors["collective_ici"],
            "measured_over_floor": _ratio(
                per_step.get("collective_ici", 0.0),
                floors["collective_ici"]),
        },
        "collective_dcn": {
            "measured_ms": round(per_step.get("collective_dcn", 0.0), 6),
            "floor_ms": floors["collective_dcn"],
            "measured_over_floor": _ratio(
                per_step.get("collective_dcn", 0.0),
                floors["collective_dcn"]),
        },
        "host": {
            "measured_ms": round(per_step.get("host", 0.0), 6),
            "floor_ms": 0.0,
            "wall_frac": round(per_step.get("host", 0.0) / wall_ms, 4)
            if wall_ms > 0 else None,
        },
    }

    # Divergences: floored components by ratio; host by wall fraction.
    divergences: List[Dict[str, Any]] = []
    for comp in ("compute", "collective_ici", "collective_dcn"):
        c = components[comp]
        r = c["measured_over_floor"]
        c["diverged"] = bool(r is not None and r > threshold)
        if c["diverged"]:
            divergences.append({
                "component": comp, "measured_ms": c["measured_ms"],
                "floor_ms": c["floor_ms"], "measured_over_floor": r,
                "threshold": threshold})
    host = components["host"]
    hf = host["wall_frac"]
    host["diverged"] = bool(hf is not None and hf > host_frac)
    if host["diverged"]:
        divergences.append({
            "component": "host", "measured_ms": host["measured_ms"],
            "floor_ms": 0.0, "wall_frac": hf, "threshold": host_frac})

    # Boundedness verdict: dominant measured bucket vs predicted bound.
    busy = {b: per_step.get(b, 0.0) for b in _BUCKET_CONFIRMS}
    dominant = max(busy, key=busy.get) if any(v > 0 for v in busy.values()) \
        else None
    predicted = (cost_model.get("step") or {}).get("bound")
    if dominant is None or predicted is None:
        verdict = "indeterminate"
    elif predicted in _BUCKET_CONFIRMS[dominant]:
        verdict = "match"
    else:
        verdict = "mismatch"

    # Per-path boundedness: every registered path gets a verdict — does
    # the step-level measured dominant bucket confirm the path's own
    # predicted bound? (Buckets are step-scoped; per-path device
    # attribution needs hardware annotations we don't require.)
    path_verdicts: Dict[str, Dict[str, Any]] = {}
    for name, p in (cost_model.get("paths") or {}).items():
        if not p.get("available"):
            path_verdicts[name] = {"bound": None, "floor_ms": None,
                                   "verdict": "unavailable"}
            continue
        pb = p.get("bound")
        if dominant is None or pb is None:
            pv = "indeterminate"
        elif pb in _BUCKET_CONFIRMS[dominant]:
            pv = "match"
        else:
            pv = "mismatch"
        path_verdicts[name] = {
            "bound": pb, "floor_ms": round(p.get("floor_ms", 0.0), 6),
            "verdict": pv}

    return {
        "per_step_wall_ms": round(wall_ms, 6),
        "threshold": threshold,
        "host_frac_threshold": host_frac,
        "components": components,
        "dominant_bucket": dominant,
        "predicted_bound": predicted,
        "verdict": verdict,
        "paths": path_verdicts,
        "divergences": divergences,
    }


def divergence_events(reconciliation: Dict[str, Any]
                      ) -> List[Dict[str, Any]]:
    """Payloads for the ``reconcile_divergence`` telemetry events — one
    per diverged component, self-describing (component, measured, floor,
    the threshold that tripped)."""
    return [dict(d, event="reconcile_divergence")
            for d in reconciliation.get("divergences", [])]
