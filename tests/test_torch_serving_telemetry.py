"""The port's serving telemetry against the JAX package's: the request
trace (``monitor/request_trace.py``) and the serving step spine (the
engine's ``step``/``report`` records and events, the scheduler's and
router's traces), on gpt2-tiny in fp32 with the same weights.

- ``RequestTrace``: the same marks on an injected clock give the same
  timelines, events and summaries (abort paths and ring caps included):
  equal but for the span durations, which the port takes as differences
  of offsets (within 1e-9 ms of JAX's; ROADMAP F9), and
  ``validate_timeline`` the same verdicts. F9: marks whose JAX timeline
  fails ``validate_timeline`` by an ulp give a port timeline that
  passes, and no port timeline of 2000 random ones fails.
- Served streams with telemetry on, through the scheduler and through a
  2-replica router: the JSONL stream's record kinds in order, its event
  sequence (kind, rid, reason), every ``request_trace`` event's phase
  structure and counts, the Perfetto trace's request spans and flow
  arrows, and the report's ``trace`` and ``recompiles`` keys are EQUAL
  across the two engines; greedy streams equal with telemetry on and
  off; on the port, telemetry adds no host read (``device_sync_count``
  and the dispatched ``_local_scalar_dense`` reads equal on and off).
- F8: ``InferenceEngine.profile_window`` is None with telemetry off and
  raises naming ROADMAP item 9 with telemetry on.

The JAX engines run on a one-device mesh with ``paged_kernel: false``
(ROADMAP R2)."""
import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import ReplicaRouter as JRouter
from deepspeed_tpu.inference import scheduler as jsched
from deepspeed_tpu.models.gpt2 import GPT2_CONFIGS as JCONFIGS
from deepspeed_tpu.models.gpt2 import gpt2_init as jgpt2_init
from deepspeed_tpu.monitor import request_trace as jrt
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu_torch.inference import InferenceEngine as TEngine
from deepspeed_tpu_torch.inference import ReplicaRouter as TRouter
from deepspeed_tpu_torch.inference import scheduler as tsched
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS
from deepspeed_tpu_torch.monitor import request_trace as trt
from deepspeed_tpu_torch.utils import timer as ttimer

JCFG = dataclasses.replace(JCONFIGS["gpt2-tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32)
INF = {"max_slots": 4, "max_seq_len": 64, "prefill_chunk": 8,
       "block_size": 8}
TOOLS = Path(__file__).resolve().parent.parent / "tools"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread for this module (both engines
    serve here; parallel workers' intra-op teams would contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# RequestTrace (host code): the same marks, the same records
# --------------------------------------------------------------------- #
class _Sink:
    """A telemetry stand-in: records events, and spans and flows on a
    stand-in tracer."""
    enabled = True

    def __init__(self):
        self.events = []
        self.tracer = self

    def event(self, kind, payload):
        self.events.append((kind, dict(payload)))

    def add_span(self, name, t, dur, tid=None, args=None):
        self.events.append(("span", name, round(t, 9), round(dur, 9), tid,
                            args))

    def flow(self, name, fid, phase, t, tid=0):
        self.events.append(("flow", name, fid, phase, round(t, 9), tid))


def _lifecycle(mod, sink):
    tr = mod.RequestTrace(clock=lambda: 99.0)
    tr.enqueue(7, t=100.0)
    tr.route(7, 1, [{"replica": 0, "score": -1.0},
                    {"replica": 1, "score": 0.5, "label": "r1"}],
             t=100.001)
    first = tr.admit_reject(7, reason="reservation", t=100.002)
    again = tr.admit_reject(7, reason="reservation", t=100.003)
    tr.admit(7, slot=2, t=100.01, replica="r1")
    tr.prefill(7, 0.02, tokens=16, chunks=2, cached_tokens=8,
               cow_fork=True)
    tr.first_token(7, t=100.03)
    tr.tick(7, 3, 1, t=100.05)
    tr.tick(7, 3, 4, proposed=4, accepted=3, t=100.09)
    tr.enqueue(8)                       # the injected clock's 99.0
    tr.admit(8, slot=0)
    tr.first_token(8)
    tr.complete(8, telemetry=sink)
    tl = tr.complete(7, t=100.09, telemetry=sink)
    return (first, again, tl, tr.summary(), tr.completed)


def _aborts(mod, sink):
    tr = mod.RequestTrace()
    tr.enqueue(1, t=10.0)
    tr.admit(1, slot=0, t=10.01, replica="r0")
    tr.abort(1, "max_wall", t=10.05, telemetry=sink)
    tr.enqueue(2, t=20.0)
    tr.abort(2, "starved", t=20.5, telemetry=sink)
    tr.enqueue(3, t=30.0)
    tr.admit(3, slot=1, t=30.5, replica="r0")
    tr.first_token(3, t=30.75)
    tr.abort(3, t=31.0, telemetry=sink)
    return (tr.summary(), tr.completed, tr.abort(99, telemetry=sink))


def _ring(mod, sink):
    tr = mod.RequestTrace(capacity=2, tick_capacity=3)
    for rid in range(4):
        tr.enqueue(rid, t=float(rid))
    tr.admit(0, slot=0, t=0.01, replica="r0")
    tr.first_token(0, t=0.02)
    for i in range(5):
        tr.tick(0, 1, 1, t=0.03 + i * 0.01)
    tr.complete(0, t=0.1, telemetry=sink)
    for rid in (1, 2):
        tr.enqueue(rid + 10, t=1.0)
        tr.admit(rid, slot=1, t=1.5)
        tr.first_token(rid, t=1.75)
        tr.complete(rid, t=2.0, telemetry=sink)
    return (tr.summary(), tr.completed)


def _same(a, b):
    """Equal structure and values, floats within 1e-9 (the span
    durations' F9 difference)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and \
            all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= 1e-9
    return a == b


@pytest.mark.parametrize("scenario", [_lifecycle, _aborts, _ring],
                         ids=["lifecycle", "aborts", "ring_caps"])
def test_request_trace_matches_jax(scenario):
    ts, js = _Sink(), _Sink()
    assert _same(scenario(trt, ts), scenario(jrt, js))
    assert _same(ts.events, js.events)
    for kind, *rest in ts.events:
        if kind == "request_trace":
            assert trt.validate_timeline(rest[0]) == []
    assert trt.ROUTER_LANE == jrt.ROUTER_LANE


def _timeline(mod, t0, t_admit, t_first, t_end):
    sink = _Sink()
    tr = mod.RequestTrace()
    tr.enqueue(1, t=t0)
    tr.admit(1, slot=0, t=t_admit)
    tr.first_token(1, t=t_first)
    tr.complete(1, t=t_end, telemetry=sink)
    return sink.events[0][1]


def test_timelines_tile_exactly_f9():
    """F9: a span's duration taken as a difference of instants can miss
    the next offset by an ulp; the port's durations are differences of
    offsets, so its timelines always validate."""
    marks = (112.65946158500232, 113.86226945176692, 113.90006263694994,
             114.08141443109461)
    assert jrt.validate_timeline(_timeline(jrt, *marks)) == \
        ["last span does not end at total_ms"]
    assert trt.validate_timeline(_timeline(trt, *marks)) == []
    rng = np.random.default_rng(0)
    for _ in range(2000):
        t0 = float(rng.uniform(100, 5000))
        a = t0 + float(rng.uniform(0, 2))
        b = a + float(rng.uniform(0, 0.05))
        c = b + float(rng.uniform(0, 1))
        assert trt.validate_timeline(_timeline(trt, t0, a, b, c)) == []


def test_validate_timeline_matches_jax():
    good = _lifecycle(trt, _Sink())[2]
    cases = [good, {"spans": []},
             dict(good, spans=[dict(good["spans"][0], t_ms=1.0)]
                  + good["spans"][1:]),
             dict(good, spans=[good["spans"][0], dict(
                 good["spans"][1], t_ms=good["spans"][1]["t_ms"] + 1)]
                 + good["spans"][2:]),
             dict(good, spans=good["spans"][:2], total_ms=1e9),
             dict(good, ttft_ms=None, service_ttft_ms=1.0)]
    for tl in cases:
        assert trt.validate_timeline(tl) == jrt.validate_timeline(tl)
    assert trt.validate_timeline(good) == []
    assert all(trt.validate_timeline(tl) for tl in cases[1:])


# --------------------------------------------------------------------- #
# Served streams with telemetry on, on both engines
# --------------------------------------------------------------------- #
def _params_np():
    """JAX init with the matmul weights scaled up, so greedy streams vary
    token to token (as tests/test_torch_serving.py does)."""
    p = jax.tree_util.tree_map(np.asarray,
                               jgpt2_init(jax.random.PRNGKey(3), JCFG))
    for name in list(p["blocks"]):
        if name.endswith("_kernel"):
            p["blocks"][name] = p["blocks"][name] * 6
    p["wte"], p["wpe"] = p["wte"] * 6, p["wpe"] * 6
    return p


@pytest.fixture(scope="module")
def params_np():
    return _params_np()


def _config(out, job, telemetry=True, **inf):
    cfg = {"inference": dict(INF, **inf)}
    if telemetry:
        cfg["telemetry"] = {"enabled": True, "output_path": str(out),
                            "job_name": job, "report_steps": 4,
                            "trace_path": str(out / f"{job}.trace.json"),
                            "fail_on_recompile": True}
    return cfg


def _engine(side, tree, cfg):
    if side == "jax":
        cfg = dict(cfg, inference=dict(cfg["inference"],
                                       paged_kernel=False))
        return JEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, tree),
                       config=cfg, mesh=build_mesh(devices=jax.devices()[:1]))
    return TEngine(TCFG, convert.from_jax_params(tree), config=cfg,
                   device="cpu")


def _stream(mod, n=9):
    # 9 saturation arrivals on 4 slots: the queue's head is refused
    # while every slot is busy (admission_rejected events).
    return mod.shared_prefix_requests(n, prefix_len=16, tail_len=(0, 6),
                                      max_new_tokens=6, vocab_size=512,
                                      seed=0)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _trace_shape(tl):
    """A request_trace event's clock-free content."""
    spans = []
    for sp in tl["spans"]:
        spans.append({k: v for k, v in sp.items()
                      if k not in ("t_ms", "dur_ms", "wall_ms")})
    route = tl.get("route")
    if route is not None:
        route = {"chosen": route["chosen"],
                 "candidates": [{k: c[k] for k in ("replica", "label",
                                                   "queue_depth",
                                                   "affinity_tokens",
                                                   "occupancy")
                                 if k in c} for c in route["candidates"]]}
    keys = sorted(k for k in tl if k not in ("ticks", "t0_s"))
    return (tl["rid"], tl["outcome"], tl.get("replica"), spans,
            tl["admission_attempts"], tl["new_tokens"], route,
            [(m["occupancy"], m["emitted"], m.get("proposed"),
              m.get("accepted")) for m in tl.get("ticks", [])], keys)


def _stream_view(recs):
    kinds = [r["kind"] for r in recs]
    events = [(r["event"], r.get("rid"), r.get("reason"),
               r.get("queue_depth"), r.get("replica")) for r in recs
              if r["kind"] == "event"]
    traces = sorted((_trace_shape(r) for r in recs
                     if r.get("event") == "request_trace"),
                    key=lambda t: t[0])
    steps = [(r["step"], r["active_slots"], r["tokens"],
              r.get("spec_accepted")) for r in recs if r["kind"] == "step"]
    return kinds, events, traces, steps


def _trace_file_view(path):
    """The request spans and flow arrows of a Perfetto trace: (name,
    phase, lane), sorted."""
    text = Path(path).read_text().rstrip().rstrip(",")
    evs = json.loads(text if text.endswith("]") else text + "]")
    return sorted((e["name"], e["ph"], e["tid"]) for e in evs
                  if e["name"].startswith("req"))


def _serve_sched(side, tree, out):
    eng = _engine(side, tree, _config(out, f"sched_{side}"))
    mod = jsched if side == "jax" else tsched
    rep = eng.serve(_stream(mod))
    eng.close()
    return rep


def _serve_router(side, tree, out, spec_k=2):
    engs = [_engine(side, tree, _config(out, f"router_{side}_{i}",
                                        replica=f"r{i}", spec_k=spec_k))
            for i in range(2)]
    router = (JRouter if side == "jax" else TRouter)(engs)
    mod = jsched if side == "jax" else tsched
    rep = router.serve(_stream(mod, 11))
    for e in engs:
        e.close()
    return rep, router


@pytest.fixture(scope="module")
def sched_runs(params_np, tmp_path_factory):
    out = tmp_path_factory.mktemp("sched")
    return {side: _serve_sched(side, params_np, out)
            for side in ("port", "jax")}, out


@pytest.fixture(scope="module")
def router_runs(params_np, tmp_path_factory):
    out = tmp_path_factory.mktemp("router")
    return {side: _serve_router(side, params_np, out)
            for side in ("port", "jax")}, out


def test_scheduler_stream_matches_jax(sched_runs):
    reps, out = sched_runs
    t, j = reps["port"], reps["jax"]
    assert [r["tokens"] for r in t["requests"]] == \
        [r["tokens"] for r in j["requests"]]
    assert set(t) == set(j)
    assert t["recompiles"] == j["recompiles"] == 0
    assert t["trace"] == j["trace"]
    assert t["trace"]["completed"] == 9 and t["trace"]["in_flight"] == 0
    tv = _stream_view(_records(out / "sched_port.jsonl"))
    jv = _stream_view(_records(out / "sched_jax.jsonl"))
    assert tv == jv
    kinds, events, traces, steps = tv
    assert len(steps) == t["iterations"] > 0
    assert kinds[0] == "meta" and kinds[-1] == "final"
    assert {"step", "report", "event"} <= set(kinds)
    assert [e[0] for e in events].count("request_complete") == 9
    assert any(e[0] == "admission_rejected" and e[2] == "no_slot"
               for e in events)
    assert [tr[0] for tr in traces] == list(range(9))
    for rec in _records(out / "sched_port.jsonl"):
        if rec.get("event") == "request_trace":
            assert trt.validate_timeline(rec) == []
    spans = _trace_file_view(out / "sched_port.trace.json")
    assert spans == _trace_file_view(out / "sched_jax.trace.json")
    assert {ph for _, ph, _ in spans} >= {"X", "s", "t", "f"}


def test_scheduler_meta_and_reports_match_jax(sched_runs):
    _, out = sched_runs
    trecs = _records(out / "sched_port.jsonl")
    jrecs = _records(out / "sched_jax.jsonl")
    tmeta, jmeta = trecs[0], jrecs[0]
    for key in ("mode", "max_slots", "max_seq_len", "prefill_chunk",
                "block_size", "num_blocks", "spec_k", "replica",
                "quantize", "precision", "param_bytes", "kv_cache_bytes",
                "attend_flops_per_token", "attend_hbm_bytes_per_token"):
        assert tmeta[key] == jmeta[key], key
    treps = [r for r in trecs if r["kind"] == "report"]
    jreps = [r for r in jrecs if r["kind"] == "report"]
    assert [sorted(r) for r in treps] == [sorted(r) for r in jreps]
    assert [r["serving"]["completed"] for r in treps] == \
        [r["serving"]["completed"] for r in jreps]


def test_router_stream_matches_jax(router_runs):
    runs, out = router_runs
    (t, trouter), (j, jrouter) = runs["port"], runs["jax"]
    assert [(r["replica"], r["tokens"]) for r in t["requests"]] == \
        [(r["replica"], r["tokens"]) for r in j["requests"]]
    assert set(t) == set(j)
    assert t["recompiles"] == j["recompiles"] == 0
    assert t["trace"] == j["trace"] and t["trace"]["completed"] == 11
    assert t["router"] == j["router"]
    for i in range(2):
        tv = _stream_view(_records(out / f"router_port_{i}.jsonl"))
        jv = _stream_view(_records(out / f"router_jax_{i}.jsonl"))
        assert tv == jv
        traces = tv[2]
        assert traces and all(tr[2] == f"r{i}" for tr in traces)
        # every route decision rode its trace, with every candidate
        assert all(len(tr[6]["candidates"]) == 2 for tr in traces)
        assert any(m[2] == 2 for tr in traces for m in tr[7])
    # the chosen candidate is the argmax of the recorded scores
    for d in trouter.decisions:
        scores = [c["score"] for c in d["candidates"]]
        assert d["chosen"] == int(np.argmax(scores))


def _count_host_reads(fn):
    class Reads(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                Reads.n += 1
            return func(*args, **(kwargs or {}))
    before = ttimer.device_sync_count()
    with Reads():
        out = fn()
    return out, Reads.n, ttimer.device_sync_count() - before


@pytest.mark.parametrize("spec_k", [0, 2])
def test_telemetry_adds_no_host_read_and_keeps_streams(params_np, tmp_path,
                                                       spec_k):
    """The same stream with telemetry on and off: equal greedy streams,
    equal host reads (dispatched ``_local_scalar_dense``) and
    ``device_sync_count``, on the port."""
    runs = {}
    for on in (False, True):
        eng = _engine("port", params_np,
                      _config(tmp_path, f"sync_{on}", telemetry=on,
                              spec_k=spec_k))
        eng.serve(_stream(tsched, 3))          # the cold calls
        eng.reset_serving_stats()
        runs[on] = _count_host_reads(lambda: eng.serve(_stream(tsched)))
        eng.close()
    (off, off_reads, off_syncs), (on, on_reads, on_syncs) = \
        runs[False], runs[True]
    assert [r["tokens"] for r in on["requests"]] == \
        [r["tokens"] for r in off["requests"]]
    assert on_reads == off_reads and on_syncs == off_syncs == 0
    assert on["iterations"] == off["iterations"]
    assert "trace" in on and "trace" not in off


def test_report_tool_reads_the_serving_stream(sched_runs):
    """``tools/telemetry_report.py`` reads the port's stream: the serving
    section, the traces, and a worst-request exemplar with its spans."""
    _, out = sched_runs
    sys.path.insert(0, str(TOOLS))
    try:
        from telemetry_report import summarize
    finally:
        sys.path.remove(str(TOOLS))
    summary = summarize(str(out / "sched_port.jsonl"))
    ss = summary["serving_slo"]
    assert ss["available"] and ss["ledger"]["consistent"]
    assert ss["traces"]["recorded"] == 9
    assert ss["traces"]["contiguity_violations"] == 0
    worst = ss["traces"]["worst_ttft"]
    assert worst and worst[0]["spans"]
    assert summary["serving"]["queue_wait_ms"]["n"] == 9


def test_profile_window_f8(params_np, tmp_path):
    """F8: the port's serving engine has ``profile_window``: None with
    telemetry off (as in JAX), and with telemetry on it raises naming
    ROADMAP queue 1 item 9 (the capture window is not ported)."""
    off = _engine("port", params_np, _config(tmp_path, "f8", telemetry=False))
    assert off.profile_window(3) is None
    assert off.profile_window(2, start_step=5) is None
    jeng = _engine("jax", params_np, _config(tmp_path, "f8j",
                                             telemetry=False))
    assert jeng.profile_window(3) is None
    on = _engine("port", params_np, _config(tmp_path, "f8on"))
    with pytest.raises(NotImplementedError, match="item 9"):
        on.profile_window(3)
    on.close()
    assert os.path.exists(tmp_path / "f8on.jsonl")
