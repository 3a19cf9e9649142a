"""The port's capture window (``deepspeed_tpu_torch/monitor/trace.py::
ProfilerWindow`` on ``torch.profiler``) and its wiring into telemetry and
both engines, on the CPU.

- The window: JAX's ``TestProfilerWindow`` cases (the ``step_<start>_
  <stop>`` directory, a failed start and a failed stop as structured
  ``profile_window`` events, the duplicate and non-empty directory
  refusals) on the port's window; the failed start's event equals the
  JAX window's on the same inputs.
- A real capture: a window over a few torch ops writes
  ``<host>.<pid>.trace.json`` in its capture dir, which ingests with the
  matmuls under ``gemm`` and buckets + idle equal to the wall; a window
  whose first tick comes mid-range still captures.
- Round trips at gpt2-tiny: the training engine with a
  ``telemetry.profile`` block and the serving engine's
  ``profile_window(2)`` each write a ``profile`` event into the JSONL,
  ``ingest_from_telemetry`` finds the capture from the JSONL alone, the
  decomposition sums to the window's wall within 5%, the training
  window is reconciled with a verdict for every cost-model path, and
  ``tools/telemetry_report.py`` has a ``profile`` section; a window
  still open at ``close`` is stopped and ingested.
"""
import dataclasses
import importlib.util
import json
import os
import socket

import numpy as np
import pytest
import torch

from deepspeed_tpu.monitor.trace import ProfilerWindow as JWindow
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.inference.scheduler import synthetic_requests
from deepspeed_tpu_torch.models.gpt2 import (GPT2_CONFIGS, gpt2_init,
                                             gpt2_loss_fn)
from deepspeed_tpu_torch.monitor.profile_ingest import (ingest,
                                                        ingest_from_telemetry)
from deepspeed_tpu_torch.monitor.trace import ProfilerWindow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32)
SUM_TOLERANCE = 0.05            # tools/profile_check.py's


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """gpt2-tiny's ops are small: one intra-op thread keeps parallel
    test workers from contending."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def load_report_tool():
    spec = importlib.util.spec_from_file_location(
        "telemetry_report", os.path.join(REPO, "tools",
                                         "telemetry_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# --------------------------------------------------------------------- #
# The window (JAX's TestProfilerWindow cases)
# --------------------------------------------------------------------- #
def _window(tmp_path, start=4, n=2, sub="w", cls=ProfilerWindow):
    events = []
    w = cls(start, n, str(tmp_path / sub),
            on_event=lambda k, p: events.append((k, p)))
    return w, events


def test_capture_dir_carries_step_range(tmp_path):
    w, _ = _window(tmp_path, start=4, n=2)
    assert w.capture_dir.endswith("step_4_6")
    assert w.trace_file == os.path.join(
        w.capture_dir, f"{socket.gethostname()}.{os.getpid()}.trace.json")
    jw, _ = _window(tmp_path, start=4, n=2, cls=JWindow)
    assert (w.start_step, w.stop_step, w.capture_dir) == \
        (jw.start_step, jw.stop_step, jw.capture_dir)


def test_failed_start_emits_structured_event(tmp_path):
    # out_dir is a FILE: the capture dir cannot be created.
    blocker = tmp_path / "blocked"
    blocker.write_text("x")
    got, want = [], []
    w = ProfilerWindow(4, 2, str(blocker),
                       on_event=lambda k, p: got.append((k, p)))
    jw = JWindow(4, 2, str(blocker),
                 on_event=lambda k, p: want.append((k, p)))
    w.tick(4)
    jw.tick(4)
    assert w.failed
    assert got == want
    kind, p = got[-1]
    assert kind == "profile_window"
    assert p["phase"] == "start" and p["ok"] is False
    assert "reason" in p and p["start_step"] == 4
    # A failed window stays failed — no retry storm on later ticks.
    w.tick(5)
    assert len(got) == 1


def test_failed_stop_emits_structured_event(tmp_path):
    class GoneProfiler:
        def stop(self):
            raise RuntimeError("profiler backend gone")

    w, events = _window(tmp_path)
    w._active = True         # simulate an armed window
    w._prof = GoneProfiler()
    w.stop()
    kind, p = events[-1]
    assert p["phase"] == "stop" and p["ok"] is False
    assert "profiler backend gone" in p["reason"]
    assert w.failed


def test_duplicate_capture_dir_refused(tmp_path):
    w1, _ = _window(tmp_path, sub="shared")
    w1._claim_dir()
    w2, _ = _window(tmp_path, sub="shared")
    with pytest.raises(RuntimeError, match="duplicate"):
        w2._claim_dir()
    # Through tick(): the refusal surfaces as a failed-start event,
    # never a silent overwrite.
    w3, events3 = _window(tmp_path, sub="shared")
    w3.tick(4)
    assert w3.failed
    assert events3[-1][1]["ok"] is False
    assert "duplicate" in events3[-1][1]["reason"]


def test_nonempty_dir_on_disk_refused(tmp_path):
    w, _ = _window(tmp_path, sub="prior")
    os.makedirs(w.capture_dir)
    with open(os.path.join(w.capture_dir, "old.trace.json"), "w") as f:
        f.write("[]")
    with pytest.raises(RuntimeError, match="not empty"):
        w._claim_dir()


# --------------------------------------------------------------------- #
# A real torch.profiler capture on the CPU
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("first_tick", [0, 1])
def test_real_capture_ingests(tmp_path, first_tick):
    """Ticks from ``first_tick`` (1: a run resumed inside the window
    still captures what is left of it) to the stop."""
    events = []
    w = ProfilerWindow(0, 2, str(tmp_path / "cap"),
                       on_event=lambda k, p: events.append(p),
                       device=torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 64)).astype(np.float32))
    for step in range(first_tick, 3):
        w.tick(step)
        for _ in range(3):
            (x @ x).relu().sum()
    assert [p["phase"] for p in events] == ["start", "stop"]
    assert all(p["ok"] for p in events)
    assert events[0]["armed_at_step"] == first_tick
    assert os.listdir(w.capture_dir) == [os.path.basename(w.trace_file)]
    out = ingest(events[-1]["path"], n_steps=2)
    assert out["n_device_ops"] > 0 and out["n_device_lanes"] == 0
    assert out["buckets_ms"]["gemm"] > 0
    assert out["sum_check"]["explained_frac"] == pytest.approx(
        1.0, abs=SUM_TOLERANCE)


# --------------------------------------------------------------------- #
# Round trips through the engines
# --------------------------------------------------------------------- #
def _train_engine(out, profile=None):
    tel = {"enabled": True, "output_path": str(out), "job_name": "run",
           "report_steps": 4}
    if profile is not None:
        tel["profile"] = profile
    return initialize(
        model=gpt2_loss_fn(CFG),
        model_params=gpt2_init(CFG, torch.Generator().manual_seed(0),
                               "cpu"),
        config={"train_batch_size": 4, "gradient_accumulation_steps": 2,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "telemetry": tel},
        device="cpu", rng=0)[0]


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, CFG.vocab_size, (4, 33)))
            for _ in range(n)]


def _check_profile(jsonl, want_steps):
    recs = read_jsonl(jsonl)
    windows = [r for r in recs if r.get("event") == "profile_window"]
    assert [w["phase"] for w in windows] == ["start", "stop"]
    assert all(w["ok"] for w in windows)
    prof = [r for r in recs if r.get("event") == "profile"]
    assert len(prof) == 1 and "error" not in prof[0]
    d = prof[0]["decomposition"]
    assert d["steps"] == want_steps and d["n_device_ops"] > 0
    assert abs(d["sum_check"]["explained_frac"] - 1.0) <= SUM_TOLERANCE
    found = ingest_from_telemetry(jsonl)
    assert found["profile_window"]["path"] == windows[-1]["path"]
    assert abs(found["sum_check"]["explained_frac"] - 1.0) <= SUM_TOLERANCE
    summary = load_report_tool().summarize(jsonl)
    assert summary["profile"]["available"]
    assert summary["profile"]["steps"] == want_steps
    return prof[0], summary


def test_training_engine_round_trip(tmp_path):
    eng = _train_engine(tmp_path, {"start_step": 2, "window_steps": 2})
    for b in _batches(8):
        eng.train_batch(b)
    eng.close()
    prof, summary = _check_profile(str(tmp_path / "run.jsonl"), 2)
    assert prof["window"]["path"] == str(
        tmp_path / "torch_trace" / "step_2_4")
    recon = prof["reconciliation"]
    assert recon["verdict"] in ("match", "mismatch")
    assert set(recon["paths"]) == set(summary["roofline"]["paths"])
    assert summary["profile"]["reconciliation"]["verdict"] == \
        recon["verdict"]
    assert prof["decomposition"]["per_step_ms"]["gemm"] > 0


def test_window_open_at_close_is_ingested(tmp_path):
    eng = _train_engine(tmp_path)
    eng.train_batch(_batches(1)[0])
    path = eng.profile_window(10)
    for b in _batches(2, seed=1):
        eng.train_batch(b)
    eng.close()
    recs = read_jsonl(tmp_path / "run.jsonl")
    prof = [r for r in recs if r.get("event") == "profile"]
    assert len(prof) == 1 and prof[0]["window"]["path"] == path
    assert prof[0]["decomposition"]["n_device_ops"] > 0
    assert recs[-1]["kind"] == "final"


def test_serving_engine_round_trip(tmp_path):
    eng = InferenceEngine(CFG, gpt2_init(
        CFG, torch.Generator().manual_seed(0), "cpu"), config={
        "inference": {"max_slots": 4, "max_seq_len": 64,
                      "prefill_chunk": 8, "block_size": 8},
        "telemetry": {"enabled": True, "output_path": str(tmp_path),
                      "job_name": "serve", "report_steps": 4}},
        device="cpu")
    path = eng.profile_window(2)
    assert path == str(tmp_path / "torch_trace" / "step_1_3")
    rep = eng.serve(synthetic_requests(4, prompt_len=(4, 8),
                                       max_new_tokens=6, vocab_size=512))
    assert rep["completed"] == 4
    eng.close()
    prof, _ = _check_profile(str(tmp_path / "serve.jsonl"), 2)
    assert prof["window"]["path"] == path
