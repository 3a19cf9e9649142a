"""monitor/ — the telemetry subsystem of the port (the JAX package's
``deepspeed_tpu/monitor``): per-step records in a ring drained to JSONL
at report boundaries with no added host sync, host Chrome-trace spans,
the recompile sentinel, device-memory watermarks against the analytic
state footprint, the goodput ledger, health taps with NaN provenance,
the hang watchdog, the crash flight recorder, and the roofline cost
model with per-step MFU on the card's peaks. Serving's aggregator and
SLO tracker live here too; serving telemetry (request traces) is not
ported yet (ROADMAP queue 1 item 3)."""
from .cost_model import (BOUND_COMPUTE, BOUND_HBM, BOUND_INTERCONNECT,
                         build_cost_model, mfu, roofline)
from .flight import FlightRecorder
from .goodput import BUCKETS as GOODPUT_BUCKETS
from .goodput import GoodputLedger
from .health import (EwmaDetector, HangWatchdog, HealthMonitor, TapSpec,
                     leaf_sq_taps)
from .hostinfo import process_identity, resolve_writer, shard_path
from .memory import (MemoryWatermark, analytic_state_bytes,
                     device_memory_stats)
from .peaks import ChipPeaks, chip_peaks
from .recompile import RecompileError, RecompileSentinel
from .serving import ServingAggregator, percentile
from .serving_slo import SERVING_BUCKETS, ServingGoodputLedger, SLOTracker
from .telemetry import JsonlSink, Telemetry
from .trace import ProfilerWindow, TraceWriter

__all__ = [
    "Telemetry", "JsonlSink", "TraceWriter", "ProfilerWindow",
    "RecompileSentinel", "RecompileError", "MemoryWatermark",
    "analytic_state_bytes", "device_memory_stats",
    "GoodputLedger", "GOODPUT_BUCKETS", "ServingAggregator", "percentile",
    "ServingGoodputLedger", "SLOTracker", "SERVING_BUCKETS",
    "HealthMonitor", "EwmaDetector", "HangWatchdog", "TapSpec",
    "leaf_sq_taps", "FlightRecorder",
    "process_identity", "resolve_writer", "shard_path",
    "build_cost_model", "roofline", "mfu",
    "BOUND_COMPUTE", "BOUND_HBM", "BOUND_INTERCONNECT",
    "ChipPeaks", "chip_peaks",
]
