"""monitor/ — the telemetry subsystem of the port (the JAX package's
``deepspeed_tpu/monitor``): per-step records in a ring drained to JSONL
at report boundaries with no added host sync, host Chrome-trace spans,
the recompile sentinel, device-memory watermarks against the analytic
state footprint, the goodput ledger, health taps with NaN provenance,
the hang watchdog, the crash flight recorder, and the roofline cost
model with per-step MFU on the card's peaks, and the measured half of
the roofline story: a ``torch.profiler`` capture window
(``trace.ProfilerWindow``) ingested into a bucketed per-step wall
decomposition (``profile_ingest``) reconciled against the analytic
floors (``reconcile``). Serving's aggregator, SLO tracker and request
traces (``request_trace.py``: per-request span timelines drained as
``request_trace`` events and Perfetto spans) live here too."""
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
from .profile_ingest import (ingest, ingest_from_telemetry,
                             parse_trace_events)
from .recompile import RecompileError, RecompileSentinel
from .reconcile import reconcile
from .request_trace import ROUTER_LANE, RequestTrace, validate_timeline
from .serving import ServingAggregator, percentile
from .serving_slo import SERVING_BUCKETS, ServingGoodputLedger, SLOTracker
from .telemetry import JsonlSink, Telemetry
from .trace import ProfilerWindow, TraceWriter

__all__ = [
    "Telemetry", "JsonlSink", "TraceWriter", "ProfilerWindow",
    "RecompileSentinel", "RecompileError", "MemoryWatermark",
    "RequestTrace", "validate_timeline", "ROUTER_LANE",
    "analytic_state_bytes", "device_memory_stats",
    "GoodputLedger", "GOODPUT_BUCKETS", "ServingAggregator", "percentile",
    "ServingGoodputLedger", "SLOTracker", "SERVING_BUCKETS",
    "HealthMonitor", "EwmaDetector", "HangWatchdog", "TapSpec",
    "leaf_sq_taps", "FlightRecorder",
    "process_identity", "resolve_writer", "shard_path",
    "build_cost_model", "roofline", "mfu",
    "ingest", "ingest_from_telemetry", "parse_trace_events", "reconcile",
    "BOUND_COMPUTE", "BOUND_HBM", "BOUND_INTERCONNECT",
    "ChipPeaks", "chip_peaks",
]
