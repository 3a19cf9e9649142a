"""The port's device-trace ingestion and reconciliation
(``deepspeed_tpu_torch/monitor/profile_ingest.py``, ``reconcile.py``)
against the JAX package's, on the CPU.

- JAX's vocabulary: the names, event lists, trace files and
  decompositions of tests/test_profile_ingest.py, and event lists drawn
  from that vocabulary with numpy seeds, go through both packages'
  ``classify_op``, ``ingest_events``, the three parse forms, ``ingest``,
  ``ingest_from_telemetry``, ``reconcile`` and ``divergence_events``:
  the results are equal, key for key.
- A real ``jax.profiler`` capture of a tiny jitted function on the CPU
  ingests to the same dict in both packages (every number within 1e-9
  ms).
- A torch.profiler (Kineto)-shaped trace built here (``stream N`` lanes,
  the ``Trace`` span, a ``gpu_user_annotation``, ``ProfilerStep#N``,
  cuBLAS and NCCL kernels, the port's kernels, ``Memcpy HtoD``/``DtoD``
  and ``Memset``) decomposes into the walls computed by hand.
- Every ``__global__`` entry of ``deepspeed_tpu_torch/csrc/*.cu`` is
  claimed by exactly one kernel family, read from the sources: a kernel
  added without a family fails here.
"""
import glob
import gzip
import importlib
import json
import os
import re

import numpy as np
import pytest

from deepspeed_tpu.monitor import profile_ingest as jpi
from deepspeed_tpu.monitor.trace import ProfilerWindow as JWindow
from deepspeed_tpu_torch.monitor import cost_model as tcm
from deepspeed_tpu_torch.monitor import profile_ingest as tpi

# (each package's monitor/__init__ re-exports the function under the
# module's name)
jrec = importlib.import_module("deepspeed_tpu.monitor.reconcile")
trec = importlib.import_module("deepspeed_tpu_torch.monitor.reconcile")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "deepspeed_tpu_torch", "csrc")
REAL_CAPTURE_ATOL_MS = 1e-9


def _ev(name, ts, dur, pid=1, tid=1, **args):
    """tests/test_profile_ingest.py's event: one complete trace event
    carrying an hlo_op arg (so its lane is a device lane)."""
    return {"name": name, "ph": "X", "pid": pid, "tid": tid,
            "ts": float(ts), "dur": float(dur),
            "args": dict({"hlo_op": name}, **args)}


def _both(fn_name, *args, **kwargs):
    return (getattr(tpi, fn_name)(*args, **kwargs),
            getattr(jpi, fn_name)(*args, **kwargs))


def assert_close_dicts(got, want, atol):
    """Equal keys and structure; numbers within ``atol``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (sorted(got), sorted(want))
        for k in want:
            assert_close_dicts(got[k], want[k], atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_close_dicts(g, w, atol)
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, abs=atol)
    else:
        assert got == want


# --------------------------------------------------------------------- #
# JAX's vocabulary: equal results
# --------------------------------------------------------------------- #
JAX_NAMES = [
    # tests/test_profile_ingest.py's names
    ("dot.5", None), ("convolution.2", None),
    ("fusion.12", {"hlo_op": "dot.3"}),
    ("all-reduce.1", None), ("reduce-scatter.4", None),
    ("all-reduce.1", {"hlo_module": "dcn"}), ("all-gather.2 slice", None),
    ("TfrtCpuBuffer::Await", None), ("infeed.1", None),
    ("copy-start.3", None), ("_ln_fwd_kernel", None),
    ("_gelu_bwd_kernel", None), ("_fwd_kernel", None), ("_gg_kernel", None),
    ("_pattn_kernel", None), ("_fused_adam_kernel", None),
    ("_sfwd_kernel", None), ("_sdkv_kernel", None),
    ("all_to_all_grouped_gemm", None), ("transpose.7", None),
    ("mystery_op.9", None), ("ThunkExecutor::Execute", None),
    # more of XLA's vocabulary
    ("fusion.3", None), ("fusion.4", {"hlo_op": "fusion.4"}),
    ("copy.9", None), ("custom-call.2", None), ("reduce.5", None),
    ("dynamic-update-slice.1", None), ("collective-permute.1", None),
    ("all-to-all.3", None), ("psum", None), ("pmean", None),
    ("outfeed.2", None), ("BlockHostUntilReady", None),
    ("dot_general", None), ("gemm.1", None), ("cublas.3", None),
    ("_bwd_dkv_kernel", None), ("_sqnorm_kernel", None),
    ("_sdq_kernel", None), ("_sfused_bwd_kernel", None),
    ("paged_attention", None), ("fused_layer_norm", None),
    ("ppermute dcn", None), ("jit_train_step", None),
    ("PjitFunction(step)", None), ("XlaModule:#hlo_module=jit_f#", None),
]


@pytest.mark.parametrize("name,args", JAX_NAMES,
                         ids=[f"{i}-{n}" for i, (n, _) in
                              enumerate(JAX_NAMES)])
def test_classify_op_matches_jax(name, args):
    got, want = _both("classify_op", name, args)
    assert got == want


DECOMPOSITIONS = {
    "overlap": [_ev("dot.1", 0, 100), _ev("all-reduce.1", 50, 100)],
    "sum_to_wall": [_ev("dot.1", 0, 10), _ev("all-reduce.2", 30, 20),
                    _ev("transpose.3", 90, 10)],
    "unattributed": [_ev("mystery_op.9", 0, 50)],
    "scaffold": [_ev("dot.1", 10, 20),
                 {"name": "ThunkExecutor::Execute", "ph": "X", "pid": 1,
                  "tid": 1, "ts": 0.0, "dur": 100.0}],
    "pallas": [_ev("_gg_kernel", 0, 40), _ev("_pattn_kernel", 40, 10)],
    "host_stall": [_ev("dot.1", 0, 2000),
                   _ev("TfrtCpuBuffer::Await", 2000, 8000)],
    "empty": [],
    "thread_named_lanes": [
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 5,
         "args": {"name": "/device:TPU:0 stream"}},
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 6,
         "args": {"name": "python main"}},
        {"name": "fusion.1", "ph": "X", "pid": 2, "tid": 5, "ts": 0.0,
         "dur": 30.0},
        {"name": "PyFunc", "ph": "X", "pid": 2, "tid": 6, "ts": 0.0,
         "dur": 90.0},
        _ev("dot.2", 40, 10, pid=1, tid=1)],
}


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("case", sorted(DECOMPOSITIONS))
def test_ingest_events_matches_jax_on_its_cases(case, n_steps):
    got, want = _both("ingest_events", DECOMPOSITIONS[case],
                      n_steps=n_steps)
    assert got == want


def _seeded_events(seed, n=40):
    """Events drawn from JAX's vocabulary: random names, lanes (two
    device lanes carrying hlo_op args, one host lane without), starts
    and durations, scaffold spans among them."""
    rng = np.random.default_rng(seed)
    names = [n for n, _ in JAX_NAMES]
    out = []
    for _ in range(n):
        name = names[int(rng.integers(len(names)))]
        pid, tid = [(1, 1), (1, 2), (3, 9)][int(rng.integers(3))]
        ts = float(np.round(rng.uniform(0, 5000), 3))
        dur = float(np.round(rng.exponential(200), 3))
        if pid == 3:
            out.append({"name": name, "ph": "X", "pid": pid, "tid": tid,
                        "ts": ts, "dur": dur})
        else:
            out.append(_ev(name, ts, dur, pid=pid, tid=tid))
    out.append({"name": "step", "ph": "i", "pid": 1, "tid": 1, "ts": 0.0})
    return out


@pytest.mark.parametrize("seed", range(8))
def test_ingest_events_matches_jax_on_seeded_traces(seed):
    events = _seeded_events(seed)
    got, want = _both("ingest_events", events, n_steps=1 + seed % 3,
                      top_k=1 + seed)
    assert got == want


PARSE_FORMS = {
    "dict": json.dumps({"traceEvents": [_ev("dot.1", 0, 1)]}),
    "strict_array": json.dumps([_ev("a", 0, 1)]),
    "unterminated": "[\n" + json.dumps(_ev("a", 0, 1)) + ",\n"
                    + json.dumps(_ev("b", 1, 1)) + ",\n",
    "empty": "   ",
}


@pytest.mark.parametrize("form", sorted(PARSE_FORMS))
def test_parse_forms_match_jax(form):
    got, want = _both("parse_trace_events", PARSE_FORMS[form])
    assert got == want


def test_garbage_raises_in_both():
    for mod in (tpi, jpi):
        with pytest.raises(json.JSONDecodeError):
            mod.parse_trace_events("not json at all")


def _window_jsonl(path, trace_dir, ok=True, reason=None):
    rec = {"kind": "event", "event": "profile_window", "phase": "stop",
           "path": str(trace_dir), "start_step": 4, "stop_step": 6,
           "ok": ok, "step": 6, "ts": 0.0}
    if reason:
        rec["reason"] = reason
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "meta"}) + "\n")
        f.write(json.dumps(rec) + "\n")
    return str(path)


@pytest.mark.parametrize("layout", ["gz", "plugins", "bare_json"])
def test_ingest_and_ingest_from_telemetry_match_jax(tmp_path, layout):
    trace_dir = tmp_path / "cap"
    doc = {"traceEvents": [_ev("dot.1", 0, 100),
                           _ev("all-reduce.1", 100, 50)]}
    if layout == "gz":
        os.makedirs(trace_dir)
        with gzip.open(trace_dir / "host.trace.json.gz", "wt") as f:
            f.write(json.dumps(doc))
    elif layout == "plugins":
        sess = trace_dir / "plugins" / "profile" / "2026_01_01"
        os.makedirs(sess)
        for host in ("h0", "h1"):
            with gzip.open(sess / f"{host}.trace.json.gz", "wt") as f:
                f.write(json.dumps(doc))
    else:
        os.makedirs(trace_dir)
        (trace_dir / "x.json").write_text(json.dumps(doc["traceEvents"]))
    got, want = _both("ingest", str(trace_dir), n_steps=2)
    assert got == want and got["n_device_ops"] > 0
    jsonl = _window_jsonl(tmp_path / "run.jsonl", trace_dir)
    got, want = _both("ingest_from_telemetry", jsonl)
    assert got == want and got["steps"] == 2


@pytest.mark.parametrize("case", ["failed", "missing", "empty_dir"])
def test_ingest_errors_match_jax(tmp_path, case):
    if case == "failed":
        got, want = _both("ingest_from_telemetry", _window_jsonl(
            tmp_path / "run.jsonl", tmp_path / "nope", ok=False,
            reason="boom"))
    elif case == "missing":
        path = tmp_path / "empty.jsonl"
        path.write_text(json.dumps({"kind": "meta"}) + "\n")
        got, want = _both("ingest_from_telemetry", str(path))
    else:
        got, want = _both("ingest", str(tmp_path / "missing"))
    assert got == want and "error" in got


# --------------------------------------------------------------------- #
# reconcile / divergence_events: equal results
# --------------------------------------------------------------------- #
def _cost_model(bound=tcm.BOUND_HBM, t_compute=1.0, t_hbm=2.0, t_comm=0.5,
                t_dcn=0.0, extra_path=False):
    path = {"available": True, "t_compute_ms": t_compute,
            "t_hbm_ms": t_hbm, "t_comm_ms": t_comm, "t_dcn_ms": t_dcn,
            "floor_ms": max(t_compute, t_hbm) + t_comm + t_dcn,
            "bound": bound}
    cm = {"paths": {"train_step": path},
          "step": {"paths": {"train_step": 1}, "bound": bound}}
    if extra_path:
        cm["paths"]["eval_step"] = {"available": False}
    return cm


def _decomp(gemm=0.0, pallas=0.0, ici=0.0, dcn=0.0, host=0.0,
            unattributed=0.0, idle=0.0):
    per_step = {"gemm": gemm, "pallas": pallas, "collective_ici": ici,
                "collective_dcn": dcn, "host": host,
                "unattributed": unattributed, "idle": idle}
    return {"per_step_ms": per_step,
            "per_step_wall_ms": sum(per_step.values())}


RECONCILE_CASES = {
    "match": (_decomp(gemm=4.0, ici=0.6), _cost_model(), {}),
    "wire_mismatch": (_decomp(gemm=0.5, ici=6.0), _cost_model(), {}),
    "dcn": (_decomp(dcn=5.0, gemm=1.0),
            _cost_model(tcm.BOUND_DCN, t_dcn=2.0), {}),
    "ratio": (_decomp(gemm=5.0, unattributed=1.0), _cost_model(),
              {"threshold": 10.0}),
    "ici_diverged": (_decomp(ici=5.0, gemm=2.5),
                     _cost_model(tcm.BOUND_INTERCONNECT), {"threshold": 3.0}),
    "unavailable": (_decomp(gemm=1.0), _cost_model(extra_path=True), {}),
    "idle_only": (_decomp(idle=3.0), _cost_model(), {}),
    "host_frac": (_decomp(gemm=1.0, host=1.0), _cost_model(),
                  {"host_frac": 0.25}),
}


@pytest.mark.parametrize("case", sorted(RECONCILE_CASES))
def test_reconcile_matches_jax(case):
    decomp, cm, kw = RECONCILE_CASES[case]
    got, want = trec.reconcile(decomp, cm, **kw), \
        jrec.reconcile(decomp, cm, **kw)
    assert got == want
    assert trec.divergence_events(got) == jrec.divergence_events(want)


@pytest.mark.parametrize("seed", range(6))
def test_reconcile_matches_jax_on_seeded_inputs(seed):
    rng = np.random.default_rng(100 + seed)
    vals = rng.exponential(2.0, size=7) * (rng.random(7) < 0.7)
    decomp = _decomp(*[float(v) for v in vals])
    bound = [tcm.BOUND_COMPUTE, tcm.BOUND_HBM, tcm.BOUND_INTERCONNECT,
             tcm.BOUND_DCN][int(rng.integers(4))]
    cm = _cost_model(bound, *[float(v) for v in rng.exponential(1.0, 4)],
                     extra_path=bool(seed % 2))
    kw = {"threshold": float(rng.uniform(1, 4)),
          "host_frac": float(rng.uniform(0.05, 0.5))}
    got, want = trec.reconcile(decomp, cm, **kw), \
        jrec.reconcile(decomp, cm, **kw)
    assert got == want
    assert trec.divergence_events(got) == jrec.divergence_events(want)


def test_seeded_host_stall_end_to_end_matches_jax():
    """JAX's acceptance seed through both packages' real ingest path: a
    host stall lands in ``host`` and fires ``reconcile_divergence``."""
    events = [_ev("dot.1", 0, 2000), _ev("TfrtCpuBuffer::Await", 2000, 8000)]
    got, want = _both("ingest_events", events, n_steps=1)
    assert got == want
    rt = trec.reconcile(got, _cost_model())
    assert rt == jrec.reconcile(want, _cost_model())
    assert [e["component"] for e in trec.divergence_events(rt)] == ["host"]


# --------------------------------------------------------------------- #
# A real jax.profiler capture
# --------------------------------------------------------------------- #
def test_real_jax_capture_ingests_alike(tmp_path):
    import jax
    import jax.numpy as jnp
    events = []
    w = JWindow(0, 1, str(tmp_path / "cap"),
                on_event=lambda k, p: events.append(p))
    w.tick(0)
    f = jax.jit(lambda x: (x @ x).sum())
    for _ in range(3):
        f(jnp.ones((64, 64))).block_until_ready()
    w.tick(1)
    assert [p["phase"] for p in events] == ["start", "stop"]
    assert glob.glob(os.path.join(events[-1]["path"], "plugins", "profile",
                                  "*", "*.trace.json.gz"))
    got, want = _both("ingest", events[-1]["path"], n_steps=1)
    assert want["n_device_ops"] > 0
    assert_close_dicts(got, want, REAL_CAPTURE_ATOL_MS)


# --------------------------------------------------------------------- #
# A torch.profiler (Kineto)-shaped trace
# --------------------------------------------------------------------- #
def _kineto(name, ts, dur, cat="kernel", pid=0, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": 1.7e12 + ts, "dur": float(dur),
            "args": {"device": 0, "stream": tid, "correlation": 1}}


def kineto_trace():
    """Two CUDA streams (7: compute, 21: NCCL), the host thread, the
    profiler's span and annotations. Times in us from 1.7e12."""
    return {"schemaVersion": 1, "traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "python"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7 "}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 21,
         "args": {"name": "stream 21 "}},
        {"ph": "M", "name": "thread_name", "pid": 4321, "tid": 4321,
         "args": {"name": "thread 4321 (python)"}},
        # host-side events: not on a device lane
        _kineto("aten::mm", 0, 500, cat="cpu_op", pid=4321, tid=4321),
        _kineto("cudaLaunchKernel", 10, 5, cat="cuda_runtime", pid=4321,
                tid=4321),
        _kineto("ProfilerStep#3", 0, 900, cat="user_annotation", pid=4321,
                tid=4321),
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "pid": "Spans", "tid": "PyTorch Profiler", "ts": 1.7e12,
         "dur": 10000.0, "args": {"Op count": 0}},
        # scaffold on the device lane: dropped
        _kineto("train_step", 100, 900, cat="gpu_user_annotation"),
        # device work
        _kineto("Memcpy HtoD (Pageable -> Device)", 20, 30,
                cat="gpu_memcpy"),
        _kineto("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", 100, 200),
        _kineto("void ln_fwd_kernel<__nv_bfloat16, true>(__nv_bfloat16 "
                "const*, __nv_bfloat16 const*, float const*)", 300, 50),
        _kineto("void flash_fwd_kernel<64, true>(Args)", 350, 100),
        _kineto("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL("
                "ncclDevKernelArgsStorage<4096ul>)", 400, 150, tid=21),
        _kineto("Memcpy DtoD (Device -> Device)", 450, 20, cat="gpu_memcpy"),
        _kineto("Memset (Device)", 470, 5, cat="gpu_memset"),
        _kineto("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"
                "_warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas",
                600, 100),
        _kineto("void at::native::vectorized_elementwise_kernel<4, "
                "at::native::FillFunctor<float> >(int, at::native::"
                "FillFunctor<float>)", 700, 10),
        _kineto("Memcpy DtoH (Device -> Pinned)", 720, 5, cat="gpu_memcpy"),
        {"ph": "s", "id": 1, "pid": 4321, "tid": 4321, "ts": 1.7e12 + 10,
         "cat": "ac2g", "name": "ac2g"},
        {"ph": "f", "id": 1, "pid": 0, "tid": 7, "ts": 1.7e12 + 100,
         "cat": "ac2g", "name": "ac2g", "bp": "e"},
    ]}


def test_kineto_trace_decomposes_as_computed_by_hand(tmp_path):
    trace_dir = tmp_path / "step_3_5"
    os.makedirs(trace_dir)
    (trace_dir / "host.4321.trace.json").write_text(
        json.dumps(kineto_trace()))
    out = tpi.ingest(str(trace_dir), n_steps=2)
    # Device lanes: the two streams. Records: stream events but the
    # annotation. Walls by hand (us), priority dcn > ici > host > pallas
    # > gemm > unattributed:
    #   host  [20,50) 30 + [720,725) 5
    #   gemm  nvjet [100,300) 200 + xmma [600,700) 100
    #   pallas ln [300,350) 50 + flash [350,400) 50 (ICI owns [400,450))
    #   ici   NCCL [400,550) 150 (DtoD and Memset fall under it)
    #   unattributed fill [700,710) 10
    #   idle  [50,100) 50 + [550,600) 50 + [710,720) 10
    assert out["n_device_lanes"] == 2
    assert out["n_device_ops"] == 10
    assert out["n_events"] == 15
    b = out["buckets_ms"]
    want = {"collective_dcn": 0.0, "collective_ici": 0.150, "host": 0.035,
            "pallas": 0.100, "gemm": 0.300, "unattributed": 0.010,
            "idle": 0.110}
    assert b == pytest.approx(want, abs=1e-9)
    assert out["wall_ms"] == pytest.approx(0.705, abs=1e-9)
    assert out["per_step_wall_ms"] == pytest.approx(0.3525, abs=1e-9)
    assert out["per_step_ms"]["gemm"] == pytest.approx(0.150, abs=1e-9)
    assert out["sum_check"]["explained_frac"] == pytest.approx(1.0)
    assert out["pallas_families_ms"] == pytest.approx(
        {"flash_attention": 0.100, "fused_ln": 0.050}, abs=1e-9)
    assert out["bucket_op_counts"] == {
        "collective_dcn": 0, "collective_ici": 1, "host": 2, "pallas": 2,
        "gemm": 2, "unattributed": 3}


@pytest.mark.parametrize("name,bucket", [
    ("Memcpy HtoD (Pinned -> Device)", "host"),
    ("Memcpy DtoH (Device -> Pageable)", "host"),
    ("Memcpy DtoD (Device -> Device)", "unattributed"),
    ("Memset (Device)", "unattributed"),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
     "collective_ici"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "collective_ici"),
    ("ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "collective_ici"),
    ("gloo:all_reduce", "collective_ici"),
    ("nvjet_hsh_256x128_64x4_2x1_v_bz_coopB_TNT", "gemm"),
    ("cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_"
     "16x16_128x2_tn_align8>(cutlass_80_wmma_tensorop_bf16_s161616gemm_"
     "bf16_16x16_128x2_tn_align8::Params)", "gemm"),
    ("void splitKreduce_kernel<32, 16, int, float, __nv_bfloat16, float, "
     "__nv_bfloat16, true, false, false>(cublasSplitKParams<float>)",
     "gemm"),
    ("aten::mm", "gemm"), ("aten::addmm", "gemm"), ("aten::bmm", "gemm"),
    ("aten::linear", "gemm"), ("aten::matmul", "gemm"),
    ("aten::baddbmm", "gemm"), ("aten::layer_norm", "unattributed"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>",
     "unattributed"),
])
def test_kineto_names(name, bucket):
    assert tpi.classify_op(name)[0] == bucket


def test_kineto_scaffold_is_dropped_on_a_cpu_trace():
    """A CPU-only capture has no device lane: its ops are the records,
    and the profiler's window-long ``Trace`` span and annotations are
    dropped, not turned into busy time."""
    ev = kineto_trace()["traceEvents"]
    cpu = [e for e in ev if e.get("pid") in (4321, "Spans")]
    out = tpi.ingest_events(cpu)
    assert out["n_device_lanes"] == 0
    assert out["n_device_ops"] == 2            # aten::mm, cudaLaunchKernel
    assert out["wall_ms"] == pytest.approx(0.5)
    assert out["buckets_ms"]["gemm"] == pytest.approx(0.5)


# --------------------------------------------------------------------- #
# Every CUDA kernel has exactly one family
# --------------------------------------------------------------------- #
def _balanced_skip(src, i):
    """Index just past the parenthesized group that opens at src[i]."""
    depth = 0
    for j in range(i, len(src)):
        if src[j] == "(":
            depth += 1
        elif src[j] == ")":
            depth -= 1
            if depth == 0:
                return j + 1
    raise ValueError("unbalanced parentheses")


def global_entry_names():
    """Every ``__global__`` function name in csrc/*.cu (past the return
    type and an optional ``__launch_bounds__(...)``)."""
    names = []
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        with open(path) as f:
            src = re.sub(r"//[^\n]*", "", f.read())
        for m in re.finditer(r"__global__\s+void\s+", src):
            i = m.end()
            if src.startswith("__launch_bounds__", i):
                i = _balanced_skip(src, src.index("(", i))
            names.append((os.path.basename(path),
                          re.match(r"\s*(\w+)", src[i:]).group(1)))
    return names


ENTRIES = global_entry_names()


def test_the_sources_have_the_kernels():
    assert len(ENTRIES) >= 20, ENTRIES
    assert {n for _, n in ENTRIES} == {
        n for names in tpi.CUDA_KERNEL_NAMES.values() for n in names}


@pytest.mark.parametrize("src,name", ENTRIES,
                         ids=[n for _, n in ENTRIES])
def test_every_cuda_kernel_has_exactly_one_family(src, name):
    # As the profiler prints it: demangled, with its template arguments.
    shown = f"void {name}<__nv_bfloat16, 64>(Args)"
    claims = [fam for fam, names in tpi.CUDA_KERNEL_NAMES.items()
              if re.search(r"\b(?:" + "|".join(names) + r")\b", shown)]
    assert len(claims) == 1, (name, claims)
    assert tpi.classify_op(shown) == ("pallas", claims[0])
    assert tpi.classify_op(name) == ("pallas", claims[0])
