"""Device-memory watermarks against the analytic model-state footprint
(port of ``deepspeed_tpu/monitor/memory.py``).

``device_memory_stats`` samples the CUDA caching allocator
(``torch.cuda.memory_stats`` and ``mem_get_info``) on the given cards
under the JAX field names, max and sum across cards; it returns None
where no card reports (the CPU), as the JAX one does on a backend with
no stats. It runs only at report boundaries: the allocator's counters
are host memory, but ``mem_get_info`` is a driver call.

``analytic_state_bytes`` prices the engine's flat state: the tensors it
keeps between steps on this rank (masters, moments, the compute-dtype
copy; a rank's rows of each at dp > 1), from their shapes alone.
``MemoryWatermark`` is the JAX class unchanged: a measured peak above
``analytic * ratio + slack`` (the slack absorbs activations, workspace
and allocator rounding) is a ``memory_watermark`` event.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

_AGG_FIELDS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def device_memory_stats(devices=None) -> Optional[Dict[str, Any]]:
    """Per-card ``bytes_in_use`` (allocated now), ``peak_bytes_in_use``
    (allocated at peak since the last reset) and ``bytes_limit`` (the
    card's total), plus ``<field>_max``/``<field>_sum``. ``devices``:
    CUDA devices (default: every visible card); None where none is a
    CUDA device or CUDA is absent."""
    try:
        import torch
        if not torch.cuda.is_available():
            return None
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
    except Exception:
        return None
    per: List[Dict[str, Any]] = []
    for d in devices:
        if d.type != "cuda":
            continue
        try:
            st = torch.cuda.memory_stats(d)
            total = int(torch.cuda.mem_get_info(d)[1])
        except Exception:
            continue
        per.append({"device": d.index if d.index is not None
                    else torch.cuda.current_device(),
                    "bytes_in_use": int(st.get(
                        "allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": int(st.get(
                        "allocated_bytes.all.peak", 0)),
                    "bytes_limit": total})
    if not per:
        return None
    out: Dict[str, Any] = {"num_devices": len(per), "per_device": per}
    for f in _AGG_FIELDS:
        vals = [p[f] for p in per]
        out[f"{f}_max"] = max(vals)
        out[f"{f}_sum"] = sum(vals)
    return out


def analytic_state_bytes(tensors: Iterable[Any],
                         gather_working_set: int = 0) -> int:
    """Bytes of the state tensors this rank keeps (shape and dtype
    only, no device access), each storage counted once, plus
    ``gather_working_set`` (stage 3's gathered compute-dtype params)."""
    total = int(gather_working_set)
    seen = set()
    for t in tensors:
        if t is None or not hasattr(t, "untyped_storage"):
            continue
        key = (t.untyped_storage().data_ptr(), t.device)
        if t.numel() and key in seen:
            continue
        seen.add(key)
        total += int(t.untyped_storage().nbytes())
    return total


class MemoryWatermark:
    """Report-boundary watermark check against an analytic footprint."""

    def __init__(self, analytic_bytes: int, ratio: float = 2.0,
                 slack_bytes: int = 256 * 2 ** 20,
                 sampler: Callable[[], Optional[Dict[str, Any]]]
                 = device_memory_stats):
        self.analytic_bytes = int(analytic_bytes)
        self.ratio = float(ratio)
        self.slack_bytes = int(slack_bytes)
        self.sampler = sampler
        self.events: List[Dict[str, Any]] = []

    @property
    def threshold_bytes(self) -> int:
        return int(self.analytic_bytes * self.ratio) + self.slack_bytes

    def check(self):
        """Sample and compare. Returns ``(stats_or_None, event_or_None)``;
        the event is also appended to ``self.events``."""
        stats = self.sampler()
        if stats is None:
            return None, None
        peak = int(stats.get("peak_bytes_in_use_max", 0))
        if peak <= self.threshold_bytes:
            return stats, None
        event = {
            "peak_bytes_in_use_max": peak,
            "analytic_state_bytes": self.analytic_bytes,
            "threshold_bytes": self.threshold_bytes,
            "ratio": round(peak / max(1, self.analytic_bytes), 3),
            "watermark_ratio": self.ratio,
            "watermark_slack_bytes": self.slack_bytes,
        }
        self.events.append(event)
        return stats, event


__all__ = ["MemoryWatermark", "analytic_state_bytes",
           "device_memory_stats"]
