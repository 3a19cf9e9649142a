"""Device-trace ingestion: per-op records and step wall decomposition
(port of ``deepspeed_tpu/monitor/profile_ingest.py``; same buckets,
priority and output keys).

Parses a capture of ``monitor/trace.py::ProfilerWindow`` (the Chrome-trace
JSON that ``torch.profiler``'s ``export_chrome_trace`` writes as
``<capture_dir>/<host>.<pid>.trace.json``), a ``jax.profiler`` capture
(``<dir>/plugins/profile/<timestamp>/<host>.trace.json.gz``), or any
trace-event JSON, including ``monitor/trace.py::TraceWriter``'s
incremental array form, into structured :class:`OpRecord` rows, then
classifies every device op into one of the measurement buckets:

``gemm``
    Matrix-unit work: cuBLAS/CUTLASS kernels (``nvjet_*``,
    ``sm90_xmma_gemm_*``, ``cutlass*``, ``*gemm*``), ``aten::mm`` and its
    kin on a CPU trace, and the XLA vocabulary's ``dot``/``convolution``
    HLOs and fusions rooted in them.
``pallas``
    The port's hand-written kernels (every ``__global__`` entry of
    ``deepspeed_tpu_torch/csrc/*.cu``, :data:`CUDA_KERNEL_NAMES`) and the
    JAX package's Pallas kernels, by kernel name, under the family of
    the Pallas kernel each ports (fused LN/GELU, flash attention
    fwd/bwd, grouped-GEMM MoE, paged attention, fused optimizer update,
    sparse flash). The bucket keeps JAX's name so both packages' reports
    read alike.
``collective_ici`` / ``collective_dcn``
    Cross-device collectives (NCCL kernels, gloo calls, XLA collective
    HLOs), split by tier with the JAX package's axis vocabulary: an op
    naming a DCN axis (``DCN_AXES``, e.g. ``slice``) or an explicit dcn
    channel marker is DCN wire; every other collective is ICI (NVLink
    on the card).
``host``
    Host transfers and host-visible stalls: ``Memcpy HtoD``/``DtoH`` and
    pinned/pageable copies, infeed/outfeed, blocking host waits.
``unattributed``
    Device-lane busy time we could not classify (``Memcpy DtoD``,
    ``Memset`` and PyTorch's own elementwise kernels among it).
    Surfaced as its own bucket — never clamped, never folded into the
    others — so a decomposition that fails to explain the wall says so.

plus the derived ``idle`` gap (window wall not covered by any device-lane
op). The decomposition is a sweep line over the merged device-lane
intervals with a fixed bucket priority (dcn > ici > host > pallas > gemm
> unattributed), so buckets + idle partition the profiled window span
exactly; the per-step wall is the window span divided by the number of
profiled steps.

A torch.profiler trace differs from an XLA one in three ways, each
handled here as data: its device lanes are the CUDA streams (events of
``cat`` ``kernel``/``gpu_memcpy``/``gpu_memset``, threads named ``stream
N``); its scaffold spans (the ``Trace`` span covering the window, user
annotations and ``ProfilerStep#N``) are dropped before attribution; and
its ``pid``/``tid`` may be strings (``"Spans"``). A CPU-only trace has no
device lane, so its ops (the host thread's ``aten::`` calls) are the
records, as JAX's CPU captures' ops are.

Pure host-side parsing: no device work.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "OpRecord", "BUCKETS", "BUCKET_PRIORITY", "PALLAS_KERNEL_PATTERNS",
    "CUDA_KERNEL_NAMES", "find_trace_files", "parse_trace_events",
    "load_trace_events", "classify_op", "ingest_events", "ingest",
    "ingest_from_telemetry",
]

# The DCN axes of the JAX package's factored mesh
# (deepspeed_tpu/parallel/axis_algebra.py::DCN_AXES), kept here as the
# port's own copy.
DCN_AXES: Tuple[str, ...] = ("slice",)

# Decomposition buckets, in sweep-line priority order: when two device
# ops overlap in time, the higher-priority bucket owns the overlap (a
# collective overlapping a GEMM is deliberate comm/compute overlap — the
# wire time is the scarce resource being measured).
BUCKET_PRIORITY: Tuple[str, ...] = (
    "collective_dcn", "collective_ici", "host", "pallas", "gemm",
    "unattributed",
)
BUCKETS: Tuple[str, ...] = BUCKET_PRIORITY + ("idle",)

# The port's CUDA kernels: every __global__ entry of csrc/*.cu, under the
# family of the Pallas kernel it ports (tests/test_torch_profile_ingest.py
# reads the sources and holds each entry to exactly one family).
CUDA_KERNEL_NAMES: Dict[str, Tuple[str, ...]] = {
    "fused_ln": ("ln_fwd_kernel", "ln_bwd_kernel", "ln_bwd_colsum_kernel"),
    "fused_gelu": ("bias_gelu_kernel", "bias_gelu_bwd_kernel",
                   "bias_gelu_bwd_colsum_kernel"),
    "sparse_flash": ("sparse_fwd_kernel", "sparse_dq_kernel",
                     "sparse_dkv_kernel", "sparse_fused_bwd_kernel",
                     "sparse_dq_reduce_kernel"),
    "flash_attention": ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                        "flash_bwd_dkv_kernel", "flash_bwd_fused_kernel"),
    "grouped_gemm": ("grouped_gemm_wgmma_kernel", "grouped_gemm_f32_kernel"),
    "paged_attention": ("paged_attn_mma_kernel", "paged_attn_fma_kernel",
                        "paged_combine_kernel"),
    "fused_update": ("fused_adam_kernel", "sqnorm_kernel"),
}

# The JAX package's Pallas kernel names, by family.
_JAX_PALLAS_PATTERNS: Dict[str, str] = {
    "fused_ln": r"_ln_(fwd|bwd)_kernel|fused_layer_norm",
    "fused_gelu": r"_gelu_(fwd|bwd)_kernel|fused_gelu",
    "sparse_flash": (r"_sfwd_kernel|_sdq_kernel|_sdkv_kernel"
                     r"|_sfused_bwd_kernel|sparse_flash"),
    "flash_attention": (r"flash|_fwd_kernel|_bwd_dq_kernel|_bwd_dkv_kernel"
                        r"|_bwd_fused_kernel"),
    "grouped_gemm": r"_gg_kernel|grouped_gemm",
    "paged_attention": r"_pattn_kernel|paged_att",
    "fused_update": r"_fused_adam_kernel|_sqnorm_kernel|fused_update",
}
# Kernel names matched against the op/kernel name; keys are the friendly
# family names that show up in reports. The port's entry names lead each
# pattern, and the families are tried in this order, so an entry the
# JAX names would misfile (``ln_fwd_kernel`` under flash's
# ``_fwd_kernel``) is claimed by its own family first; ``sparse_flash``
# precedes ``flash_attention`` for the same reason.
PALLAS_KERNEL_PATTERNS: Dict[str, str] = {
    fam: r"\b(?:" + "|".join(CUDA_KERNEL_NAMES[fam]) + r")\b|" + pat
    for fam, pat in _JAX_PALLAS_PATTERNS.items()}
_PALLAS_RE = {k: re.compile(v) for k, v in PALLAS_KERNEL_PATTERNS.items()}

# HLO/op-name classifiers. Order matters only within classify_op below.
_GEMM_RE = re.compile(r"^(dot|convolution|cublas|gemm)\b|\bdot_general\b")
_COLLECTIVE_RE = re.compile(
    r"all-reduce|all_reduce|allreduce|all-gather|all_gather|allgather"
    r"|reduce-scatter|reduce_scatter|all-to-all|all_to_all|alltoall"
    r"|collective-permute|collective_permute|ppermute|psum\b|pmean\b")
_HOST_RE = re.compile(
    r"\bcopy[-_ ]?(start|done)?\b|d2h|h2d|device[-_ ]?to[-_ ]?host"
    r"|host[-_ ]?to[-_ ]?device|infeed|outfeed|transfer"
    r"|TfrtCpuBuffer::Await|BlockHostUntilReady|SyncAllActivity",
    re.IGNORECASE)
# Runtime container spans that wrap whole programs/regions rather than
# naming one op (XLA:CPU's executor scaffolding, pjit python frames).
# Counting them as busy time would double-cover every real op below
# them, so an otherwise-unclassifiable event matching this is dropped
# from attribution — the real ops it contains are attributed directly.
_SCAFFOLD_RE = re.compile(
    r"TaskDispatcher|ThunkExecutor|ExecuteHelper|TfrtCpuExecutable"
    r"|ExecuteOnStream|XlaModule|PjitFunction|jit_|ProgramRegion"
    r"|ThreadpoolListener|RunToCompletion")
# Markers that put a collective on the DCN tier: an explicit dcn tag or
# any DCN axis name in the op name / args.
_DCN_MARKER_RE = re.compile(
    r"\bdcn\b|" + "|".join(rf"\b{re.escape(a)}\b" for a in DCN_AXES),
    re.IGNORECASE)

# torch.profiler (Kineto) vocabulary.
# Device lanes: the CUDA streams, which carry these event categories.
_KINETO_DEVICE_CATS = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))
# Scaffold: spans over whole regions (the profiler's own "Trace" span
# covers the window; annotations wrap real ops), dropped whatever their
# name would classify as.
_KINETO_SCAFFOLD_CATS = frozenset(("Trace", "gpu_user_annotation",
                                   "user_annotation"))
_KINETO_SCAFFOLD_RE = re.compile(r"^ProfilerStep#\d+$")
# NCCL kernels (ncclDevKernel_ReduceScatter_*, *_SendRecv_*, ...).
_KINETO_COLLECTIVE_RE = re.compile(r"nccl", re.IGNORECASE)
# Copies between host and card; Memcpy DtoD and Memset are device work
# and stay unattributed.
_KINETO_HOST_RE = re.compile(
    r"^Memcpy (HtoD|DtoH|HtoH)\b|\b(Pinned|Pageable)\b")
# cuBLAS/CUTLASS kernels on Hopper, and the CPU trace's matmul ops.
_KINETO_GEMM_RE = re.compile(
    r"nvjet|gemm|cutlass|cublas|splitKreduce"
    r"|^aten::(mm|addmm|bmm|baddbmm|matmul|linear)$", re.IGNORECASE)


@dataclass
class OpRecord:
    """One complete (``ph == "X"``) trace event, bucket-classified."""
    name: str
    bucket: str
    pid: Any
    tid: Any
    ts_us: float
    dur_us: float
    kernel_family: Optional[str] = None  # set for bucket == "pallas"
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def end_us(self) -> float:
        return self.ts_us + self.dur_us


# --------------------------------------------------------------------- #
# Trace discovery + parsing
# --------------------------------------------------------------------- #
def find_trace_files(trace_dir: str) -> List[str]:
    """All trace-event JSON files under ``trace_dir``, newest profile
    session first. Understands the ``jax.profiler`` layout
    (``plugins/profile/<ts>/*.trace.json.gz``) and bare ``*.json`` /
    ``*.json.gz`` drops (a ProfilerWindow capture, a TraceWriter host
    trace)."""
    if not trace_dir or not os.path.isdir(trace_dir):
        return []
    hits: List[str] = []
    for pat in ("plugins/profile/*/*.trace.json.gz",
                "plugins/profile/*/*.trace.json",
                "*.trace.json.gz", "*.trace.json", "*.json.gz", "*.json"):
        hits.extend(glob.glob(os.path.join(trace_dir, pat)))
    # De-dup, newest mtime first so the latest capture wins.
    uniq = sorted(set(hits), key=lambda p: (-os.path.getmtime(p), p))
    return uniq


def parse_trace_events(text: str) -> List[Dict[str, Any]]:
    """Parse trace-event JSON in any of the forms we produce or consume:

    * dict form ``{"traceEvents": [...], ...}`` (torch.profiler,
      jax.profiler),
    * strict JSON array ``[...]`` (closed TraceWriter file),
    * unterminated array form ``[\\n{...},\\n{...},\\n`` (TraceWriter
      before ``close()`` — the crash-tolerant form Perfetto accepts).
    """
    text = text.strip()
    if not text:
        return []
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        # Unterminated array form: strip the trailing comma, close it.
        repaired = text.rstrip().rstrip(",")
        if not repaired.startswith("["):
            raise
        doc = json.loads(repaired + "]")
    if isinstance(doc, dict):
        events = doc.get("traceEvents", [])
    elif isinstance(doc, list):
        events = doc
    else:
        raise ValueError(f"unrecognized trace JSON root: {type(doc).__name__}")
    return [e for e in events if isinstance(e, dict)]


def load_trace_events(path: str) -> List[Dict[str, Any]]:
    """Read one trace file (gzip-aware) into a raw event list."""
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return parse_trace_events(f.read())
    with open(path) as f:
        return parse_trace_events(f.read())


# --------------------------------------------------------------------- #
# Classification
# --------------------------------------------------------------------- #
def _pallas_family(text: str) -> Optional[str]:
    for family, rx in _PALLAS_RE.items():
        if rx.search(text):
            return family
    return None


def classify_op(name: str, args: Optional[Dict[str, Any]] = None
                ) -> Tuple[str, Optional[str]]:
    """Map an op/event name (+ args) to ``(bucket, kernel_family)``.

    The HLO op name (``args["hlo_op"]``, e.g. ``dot.5``) is preferred
    over the event display name when present — fusions keep the root
    op's identity there.
    """
    args = args or {}
    hlo_op = str(args.get("hlo_op", "") or "")
    probe = f"{name} {hlo_op} {args.get('hlo_module', '')}"
    low = probe.lower()
    collective = _COLLECTIVE_RE.search(low) is not None or \
        _KINETO_COLLECTIVE_RE.search(name) is not None
    fam = _pallas_family(probe)
    # Kernels are recognized by name alone (unless the name also looks
    # like a collective, which wins).
    if fam is not None and not collective:
        return "pallas", fam
    if collective:
        tier = "dcn" if _DCN_MARKER_RE.search(probe) else "ici"
        return f"collective_{tier}", None
    if _HOST_RE.search(probe) or _KINETO_HOST_RE.search(name):
        return "host", None
    target = hlo_op or name
    if _GEMM_RE.search(target) or _GEMM_RE.search(
            target.split("(")[0].strip()):
        return "gemm", None
    if target.startswith("fusion") and "dot" in low:
        return "gemm", None
    if _KINETO_GEMM_RE.search(name):
        return "gemm", None
    return "unattributed", None


def _lane_id(v: Any) -> Any:
    """A pid/tid as an int where it is one (JAX's traces), else its
    string (torch.profiler's ``"Spans"`` lane)."""
    try:
        return int(v)
    except (TypeError, ValueError):
        return str(v)


def _lane(e: Dict[str, Any]) -> Tuple[Any, Any]:
    return _lane_id(e.get("pid", 0)), _lane_id(e.get("tid", 0))


def _thread_meta(events: Iterable[Dict[str, Any]]
                 ) -> Dict[Tuple[Any, Any], str]:
    """(pid, tid) → thread name from the metadata (``ph == "M"``) events."""
    names: Dict[Tuple[Any, Any], str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            names[_lane(e)] = str((e.get("args") or {}).get("name", ""))
    return names


def _device_lanes(events: List[Dict[str, Any]],
                  thread_names: Dict[Tuple[Any, Any], str]) -> set:
    """Lanes carrying device-op execution: any (pid, tid) with at least
    one complete event bearing an ``hlo_op``/``hlo_module`` arg or a
    CUDA stream's category (kernel, memcpy, memset), plus lanes whose
    thread name marks a device stream."""
    lanes = set()
    for e in events:
        if e.get("ph") != "X":
            continue
        a = e.get("args") or {}
        if "hlo_op" in a or "hlo_module" in a or \
                e.get("cat") in _KINETO_DEVICE_CATS:
            lanes.add(_lane(e))
    dev_re = re.compile(r"(?i)xla|tpu|/device:|stream|tensorflow ops")
    for key, nm in thread_names.items():
        if dev_re.search(nm) and "python" not in nm.lower():
            lanes.add(key)
    return lanes


def _is_scaffold(e: Dict[str, Any], name: str) -> bool:
    return e.get("cat") in _KINETO_SCAFFOLD_CATS or \
        _KINETO_SCAFFOLD_RE.match(name) is not None


# --------------------------------------------------------------------- #
# Decomposition
# --------------------------------------------------------------------- #
_PRIO = {b: i for i, b in enumerate(BUCKET_PRIORITY)}


def _sweep(records: List[OpRecord]) -> Dict[str, float]:
    """Sweep-line attribution: for every elementary time segment inside
    the window, the highest-priority active bucket owns it. Returns
    per-bucket microseconds (no idle — the caller derives it from the
    window span). Buckets partition covered time exactly by construction.
    """
    walls = {b: 0.0 for b in BUCKET_PRIORITY}
    if not records:
        return walls
    # Boundary events: (+1 at start, -1 at end) per bucket.
    points: List[Tuple[float, int, int]] = []  # (t, delta, prio)
    for r in records:
        if r.dur_us <= 0:
            continue
        p = _PRIO[r.bucket]
        points.append((r.ts_us, +1, p))
        points.append((r.end_us, -1, p))
    if not points:
        return walls
    points.sort(key=lambda t: (t[0], -t[1]))
    active = [0] * len(BUCKET_PRIORITY)
    prev_t = points[0][0]
    for t, delta, prio in points:
        if t > prev_t:
            seg = t - prev_t
            for i, b in enumerate(BUCKET_PRIORITY):
                if active[i] > 0:
                    walls[b] += seg
                    break
            prev_t = t
        active[prio] += delta
    return walls


def ingest_events(events: List[Dict[str, Any]], n_steps: int = 1,
                  top_k: int = 12) -> Dict[str, Any]:
    """Classify + decompose one raw event list. See :func:`ingest`."""
    thread_names = _thread_meta(events)
    lanes = _device_lanes(events, thread_names)
    records: List[OpRecord] = []
    n_span_events = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        n_span_events += 1
        key = _lane(e)
        if lanes and key not in lanes:
            continue
        args = e.get("args") or {}
        name = str(e.get("name", ""))
        if _is_scaffold(e, name):
            continue
        bucket, fam = classify_op(name, args)
        if bucket == "unattributed" and _SCAFFOLD_RE.search(name):
            continue
        records.append(OpRecord(
            name=name, bucket=bucket, pid=key[0], tid=key[1],
            ts_us=float(e.get("ts", 0.0)), dur_us=float(e.get("dur", 0.0)),
            kernel_family=fam, args=args))
    if records:
        t0 = min(r.ts_us for r in records)
        t1 = max(r.end_us for r in records)
        wall_us = max(0.0, t1 - t0)
    else:
        wall_us = 0.0
    walls_us = _sweep(records)
    covered_us = sum(walls_us.values())
    idle_us = max(0.0, wall_us - covered_us)
    n = max(1, int(n_steps))

    buckets_ms = {b: round(v / 1e3, 6) for b, v in walls_us.items()}
    buckets_ms["idle"] = round(idle_us / 1e3, 6)
    per_step_ms = {b: round(v / n, 6) for b, v in buckets_ms.items()}
    # Explained fraction: buckets + idle vs the window wall. With a
    # non-degenerate window this is 1.0 by construction (the sweep
    # partitions covered time; idle is the complement); the residual
    # only moves when records are empty or clocks are inconsistent.
    total_ms = round(sum(buckets_ms.values()), 6)
    wall_ms = round(wall_us / 1e3, 6)

    by_bucket_count: Dict[str, int] = {b: 0 for b in BUCKET_PRIORITY}
    op_dur: Dict[Tuple[str, str], float] = {}
    fam_dur: Dict[str, float] = {}
    for r in records:
        by_bucket_count[r.bucket] += 1
        base = re.sub(r"[.\d]+$", "", r.args.get("hlo_op", r.name)
                      if isinstance(r.args.get("hlo_op"), str) else r.name)
        k = (r.bucket, base or r.name)
        op_dur[k] = op_dur.get(k, 0.0) + r.dur_us
        if r.kernel_family:
            fam_dur[r.kernel_family] = (fam_dur.get(r.kernel_family, 0.0)
                                        + r.dur_us)
    top_ops = [
        {"bucket": b, "op": op, "total_ms": round(us / 1e3, 6)}
        for (b, op), us in sorted(op_dur.items(), key=lambda kv: -kv[1])
    ][:top_k]
    return {
        "n_events": n_span_events,
        "n_device_ops": len(records),
        "n_device_lanes": len(lanes),
        "steps": n,
        "wall_ms": wall_ms,
        "per_step_wall_ms": round(wall_ms / n, 6),
        "buckets_ms": buckets_ms,
        "per_step_ms": per_step_ms,
        "pallas_families_ms": {k: round(v / 1e3, 6)
                               for k, v in sorted(fam_dur.items())},
        "bucket_op_counts": by_bucket_count,
        "top_ops": top_ops,
        "sum_check": {
            "decomposed_ms": total_ms,
            "wall_ms": wall_ms,
            "explained_frac": round(total_ms / wall_ms, 6) if wall_ms else 1.0,
            "unattributed_ms": buckets_ms["unattributed"],
        },
    }


def ingest(trace_dir: str, n_steps: int = 1, top_k: int = 12
           ) -> Dict[str, Any]:
    """Ingest every trace file of the newest capture under ``trace_dir``.

    Returns the decomposition summary (see :func:`ingest_events`) with a
    ``trace_files`` listing; multiple hosts' shards from the same
    ``plugins/profile/<ts>`` session are merged into one timeline
    (profiler timestamps share one clock per session).
    """
    files = find_trace_files(trace_dir)
    if not files:
        return {"error": f"no trace files under {trace_dir!r}",
                "trace_files": [], "n_device_ops": 0}
    # Keep only files from the newest jax.profiler session when the
    # plugins/ layout is present; otherwise take the newest file.
    sessions = [f for f in files if os.sep + "plugins" + os.sep in f]
    if sessions:
        newest_dir = os.path.dirname(sessions[0])
        chosen = [f for f in sessions if os.path.dirname(f) == newest_dir]
    else:
        chosen = [files[0]]
    events: List[Dict[str, Any]] = []
    for f in chosen:
        events.extend(load_trace_events(f))
    out = ingest_events(events, n_steps=n_steps, top_k=top_k)
    out["trace_files"] = [os.path.relpath(f, trace_dir) for f in chosen]
    out["trace_dir"] = trace_dir
    return out


def ingest_from_telemetry(jsonl_path: str, top_k: int = 12
                          ) -> Dict[str, Any]:
    """Locate the capture from the telemetry JSONL alone: read the
    ``profile_window`` event (written by ``ProfilerWindow``) for the
    trace path and step range, then :func:`ingest` it."""
    win: Optional[Dict[str, Any]] = None
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if (rec.get("kind") == "event"
                    and rec.get("event") == "profile_window"
                    and rec.get("phase") == "stop"):
                # Telemetry events splat their payload into the record.
                win = {k: rec[k] for k in ("phase", "path", "start_step",
                                           "stop_step", "ok", "reason")
                       if k in rec}
    if win is None:
        return {"error": "no completed profile_window event in "
                         f"{jsonl_path!r}", "n_device_ops": 0}
    if not win.get("ok", False):
        return {"error": "profile window failed: "
                         f"{win.get('reason', 'unknown')}",
                "profile_window": win, "n_device_ops": 0}
    n_steps = max(1, int(win.get("stop_step", 1)) - int(
        win.get("start_step", 0)))
    out = ingest(win["path"], n_steps=n_steps, top_k=top_k)
    out["profile_window"] = win
    return out
