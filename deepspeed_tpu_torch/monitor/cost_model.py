"""Roofline cost model over the engine's instrumented step paths (port of
``deepspeed_tpu/monitor/cost_model.py``).

JAX fuses XLA's compiled cost analysis with its jaxpr-walk flops count.
The port has no compiler count: both figures come from the flops
profiler's walk of each path's first call (``OpWalk``, kept by the
recompile sentinel): the flops are the walk's total, the bytes the sum
of each op's operand and output bytes (what XLA's "bytes accessed"
sums), each kernel counted at its declared cost (ops/costs.py). The
payload says so (``bytes_source: "op_walk"``). XLA's bytes come after
its fusion, which removes the intermediate reads and writes that the
op walk counts, so the port's bytes are an upper bound on what a fused
program moves (ROADMAP §3).

Per path it prices the ceilings of the card's peak table (peaks.py):

    t_compute = flops_per_device / bf16_peak
    t_hbm     = bytes_per_device / hbm_bandwidth
    t_comm    = wire_bytes / link_bandwidth        (NVLink)
    t_dcn     = dcn_bytes / network_bandwidth      (0 on one host)

and the verdict is the binding ceiling; the largest of the four is the
analytic floor of the path. Paths add into the step's floor in
sequence. ``mfu`` is the one formula: achieved flops/sec a device over
the bf16 peak.

The walk is the flops of this rank; with data parallelism every rank
runs the same work on its share of the batch, so a path's global flops
are the walk's times ``n_devices``, as JAX's global count is.

Building runs at a report boundary on host data only: no device read.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from .peaks import ChipPeaks, chip_peaks

BOUND_COMPUTE = "compute"
BOUND_HBM = "hbm"
BOUND_INTERCONNECT = "interconnect"
BOUND_DCN = "dcn"


def roofline(flops_per_device: float, hbm_bytes_per_device: float,
             comm_bytes: float, peaks: ChipPeaks,
             dcn_bytes: float = 0.0) -> Dict[str, Any]:
    """Roofline verdict for one path: which ceiling binds, and the
    perfect-overlap analytic time floor."""
    t_compute = flops_per_device / peaks.flops_per_sec
    t_hbm = hbm_bytes_per_device / peaks.hbm_bytes_per_sec
    t_comm = comm_bytes / peaks.ici_bytes_per_sec
    t_dcn = dcn_bytes / peaks.dcn_bytes_per_sec
    times = {BOUND_COMPUTE: t_compute, BOUND_HBM: t_hbm,
             BOUND_INTERCONNECT: t_comm, BOUND_DCN: t_dcn}
    bound = max(times, key=times.get)
    return {
        "t_compute_ms": t_compute * 1e3,
        "t_hbm_ms": t_hbm * 1e3,
        "t_comm_ms": t_comm * 1e3,
        "t_dcn_ms": t_dcn * 1e3,
        "bound": bound,
        "floor_ms": times[bound] * 1e3,
        "intensity_flops_per_byte":
            flops_per_device / max(1.0, hbm_bytes_per_device),
        "machine_balance_flops_per_byte":
            peaks.flops_per_sec / peaks.hbm_bytes_per_sec,
    }


def path_cost(name: str, walk: Any, comm_bytes: float, n_devices: int,
              peaks: ChipPeaks, dcn_bytes: float = 0.0) -> Dict[str, Any]:
    """One path's cost record from its walk (a ``ProfileResult``): this
    rank's flops and bytes, the global flops, the roofline verdict."""
    entry: Dict[str, Any] = {
        "path": name,
        "bytes_source": "op_walk",
        "comm_bytes": int(comm_bytes),
        "dcn_bytes": int(dcn_bytes),
    }
    if walk is None:
        entry["available"] = False
        return entry
    flops_dev = float(walk.total_flops)
    bytes_dev = float(walk.total_bytes)
    entry["analytic_flops"] = int(walk.total_flops) * max(1, n_devices)
    entry["analytic_macs"] = int(walk.total_macs) * max(1, n_devices)
    entry["flops_per_device"] = flops_dev
    entry["hbm_bytes_per_device"] = bytes_dev
    top = [{"module": p, "flops": int(f)}
           for p, f, _ in walk.top_modules(5, depth=1)]
    if top:
        entry["top_modules"] = top
    if walk.kernels:
        entry["kernels"] = {k: {"calls": int(v[0]), "flops": v[1],
                                "bytes": v[2]}
                            for k, v in sorted(walk.kernels.items())}
    entry.update(roofline(flops_dev, bytes_dev, comm_bytes, peaks,
                          dcn_bytes=dcn_bytes))
    entry["available"] = True
    return entry


def mfu(flops_per_step_total: float, step_time_s: float, n_devices: int,
        peaks: ChipPeaks) -> float:
    """Model-FLOPs-utilisation-style fraction: achieved flops/sec per
    device over the card's bf16 peak (the walk's count includes a remat
    re-run where remat is on: an HFU-style figure then)."""
    if step_time_s <= 0 or n_devices <= 0:
        return 0.0
    return flops_per_step_total / n_devices / step_time_s / \
        peaks.flops_per_sec


def build_cost_model(sentinel, comm_bytes_by_path: Dict[str, float],
                     step_paths: Dict[str, float], n_devices: int,
                     peaks: Optional[ChipPeaks] = None,
                     extra_paths: Optional[Dict[str, Any]] = None,
                     dcn_bytes_by_path: Optional[Dict[str, float]] = None
                     ) -> Dict[str, Any]:
    """The engine-facing entry point (JAX's signature).

    - ``sentinel``: the RecompileSentinel whose registry holds each
      instrumented path's walk.
    - ``comm_bytes_by_path`` / ``dcn_bytes_by_path``: per-step wire
      bytes priced on each path (absent: 0).
    - ``step_paths``: {path: invocations per train step}.
    - ``extra_paths``: {name: walk} for paths the sentinel does not
      hold.
    """
    peaks = peaks or chip_peaks()
    t_build0 = time.perf_counter()
    sources: Dict[str, Any] = dict(sentinel.registered_paths())
    for name, w in (extra_paths or {}).items():
        sources.setdefault(name, w)
    paths: Dict[str, Dict[str, Any]] = {}
    for name, w in sources.items():
        paths[name] = path_cost(name, w, comm_bytes_by_path.get(name, 0.0),
                                n_devices, peaks,
                                dcn_bytes=(dcn_bytes_by_path or {})
                                .get(name, 0.0))
    step_flops = 0.0
    step_bytes = 0.0
    step_floor_ms = 0.0
    ceiling_ms = {BOUND_COMPUTE: 0.0, BOUND_HBM: 0.0,
                  BOUND_INTERCONNECT: 0.0, BOUND_DCN: 0.0}
    _ceiling_key = {BOUND_COMPUTE: "t_compute_ms", BOUND_HBM: "t_hbm_ms",
                    BOUND_INTERCONNECT: "t_comm_ms", BOUND_DCN: "t_dcn_ms"}
    missing: List[str] = []
    for name, weight in step_paths.items():
        p = paths.get(name)
        if p is None or not p.get("available"):
            missing.append(name)
            continue
        w = float(weight)
        step_flops += p["analytic_flops"] * w
        step_bytes += p["hbm_bytes_per_device"] * w
        step_floor_ms += p["floor_ms"] * w
        for k in ceiling_ms:
            ceiling_ms[k] += p.get(_ceiling_key[k], 0.0) * w
    step_bound = max(ceiling_ms, key=ceiling_ms.get) if step_floor_ms \
        else None
    return {
        "chip": peaks.as_dict(),
        "n_devices": int(n_devices),
        "bytes_source": "op_walk",
        "paths": paths,
        "step": {
            "paths": {k: float(v) for k, v in step_paths.items()},
            "flops_per_step": step_flops,
            "bytes_per_step_per_device": step_bytes,
            "floor_ms": round(step_floor_ms, 6),
            "bound": step_bound,
            "missing_paths": missing,
        },
        "build_seconds": round(time.perf_counter() - t_build0, 3),
    }


__all__ = ["build_cost_model", "path_cost", "roofline", "mfu",
           "BOUND_COMPUTE", "BOUND_HBM", "BOUND_INTERCONNECT", "BOUND_DCN"]
