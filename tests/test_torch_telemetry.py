"""The port's training telemetry (``deepspeed_tpu_torch/monitor``, the
engine's wiring) against the JAX package's, on the CPU.

- Config: every key of the ``telemetry`` block (its ``health`` and
  ``profile`` blocks, the ``tensorboard`` alias) and of
  ``flops_profiler`` parses to JAX's value; every block JAX refuses
  raises the same ``DeepSpeedConfigError`` with the same message in the
  port (the seven blocks of fault F6 among them).
- The stream: the two engines run one ds_config (gpt2-tiny, bf16, gas 2,
  clip 1.0, dropout 0) for 12 steps with ``report_steps`` 4. The record
  kinds come in the same order; ``meta`` agrees in dp, zero stage,
  precision, wire bytes and analytic state bytes; the step records'
  loss, lr, loss_scale, overflow and grad_norm agree within the bf16
  training tolerance of tests/test_torch_training.py (1e-2 relative);
  ``tools/telemetry_report.py`` summaries agree in steps_recorded,
  dropped_records, wire_bytes_per_step and recompiles. Telemetry leaves
  the port's losses bit-equal to a telemetry-off engine's.
- Lifecycle: ring overflow reported, a disabled block inert, the
  sentinel catching an induced shape change, ``fail_on_recompile``
  raising after the step's state was stored, a profile window armed
  over JAX's step range and ingested into a ``profile`` event, one
  batched host copy a drain.
- Goodput: a slow dataset, fp16 overflow skips and a trailing checkpoint
  land in the same goodput buckets as JAX's (a two-layer MLP on both
  sides), each window summing to its wall within 1%.
- Health: a NaN put into one leaf's grad gives an anomaly event naming
  the same leaf path and layer as JAX's; the tap's norms are unscaled.

The JAX engines run on a one-device mesh (dense attention,
``fused_kernels=False``: tests/test_torch_training.py holds the
kernels).
"""
import copy
import dataclasses
import importlib.util
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.monitor import GOODPUT_BUCKETS
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.monitor import telemetry as ttel
from deepspeed_tpu_torch.monitor.recompile import RecompileError
from deepspeed_tpu_torch.runtime import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_RTOL = 1e-2          # tests/test_torch_training.py's bf16 tolerance


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """gpt2-tiny's ops are small: one intra-op thread keeps parallel
    test workers from contending (and the CPU sums in one order)."""
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


def read_jsonl(path, job="run"):
    with open(os.path.join(str(path), f"{job}.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _vars(obj):
    """The public attributes of a config object, nested blocks too."""
    out = {}
    for k, v in vars(obj).items():
        if k.startswith("_"):
            continue
        out[k] = _vars(v) if hasattr(v, "__dict__") and \
            not isinstance(v, (int, float, str, bool)) else v
    return out


# --------------------------------------------------------------------- #
# Config (F6)
# --------------------------------------------------------------------- #
BASE = {"train_batch_size": 8}


@pytest.mark.parametrize("extra", [
    {},
    {"telemetry": {"enabled": True}},
    {"telemetry": {"enabled": True, "output_path": "/x", "job_name": "j",
                   "report_steps": 7, "buffer_size": 32,
                   "trace_path": "/t.json", "fail_on_recompile": True,
                   "recompile_warmup_calls": 3, "memory_watermarks": False,
                   "watermark_ratio": 1.5, "watermark_slack_bytes": 1024,
                   "cost_model": False, "per_host_shards": True,
                   "profile_start_step": 3, "profile_num_steps": 4,
                   "profile_dir": "/p"}},
    {"telemetry": {"enabled": True, "health": {
        "enabled": False, "grad_taps": False, "z_threshold": 3.0,
        "ewma_alpha": 0.5, "warmup_steps": 4, "watchdog": True,
        "watchdog_factor": 2.0, "watchdog_min_s": 5.0,
        "flight_recorder": False, "flight_path": "/f.json",
        "flight_window": 8}}},
    {"telemetry": {"enabled": True, "profile": {
        "start_step": 2, "window_steps": 3, "out_dir": "/o",
        "divergence_threshold": 2.0, "host_frac": 0.2}}},
    {"tensorboard": {"enabled": True, "output_path": "/tb",
                     "job_name": "tbj"}},
    {"tensorboard": {"enabled": True}, "telemetry": {"enabled": False}},
    {"flops_profiler": {"enabled": True, "profile_step": 3,
                        "module_depth": 2, "top_modules": 4,
                        "detailed": False}},
], ids=["defaults", "enabled", "every_key", "health", "profile_block",
        "tensorboard_alias", "explicit_off_wins", "flops_profiler"])
def test_every_key_parses_as_jax(extra):
    ds = dict(BASE, **copy.deepcopy(extra))
    j = jconfig.DeepSpeedConfig(copy.deepcopy(ds), world_size=1)
    t = tconfig.DeepSpeedConfig(copy.deepcopy(ds), world_size=1)
    assert _vars(t.telemetry_config) == _vars(j.telemetry_config)
    assert _vars(t.flops_profiler_config) == _vars(j.flops_profiler_config)
    assert _vars(t.tensorboard_config) == _vars(j.tensorboard_config)
    assert t.telemetry_enabled == j.telemetry_config.enabled


@pytest.mark.parametrize("bad", [
    # The seven blocks of F6 (tests/test_telemetry.py's and
    # test_health.py's invalid cases), then the rest of the validation.
    {"buffer_size": 0}, {"buffer_size": "big"}, {"report_steps": -1},
    {"recompile_warmup_calls": -2}, {"watermark_ratio": 0},
    {"health": {"z_threshold": -1}}, {"profile": {"window_steps": -1}},
    {"cost_model": "yes"}, {"per_host_shards": 1},
    {"health": {"enabled": "yes"}}, {"health": {"ewma_alpha": 0}},
    {"health": {"warmup_steps": -1}}, {"health": {"watchdog_factor": 0}},
    {"health": {"flight_window": 0}}, {"profile": {"start_step": "x"}},
    {"profile": {"host_frac": 0}}, {"profile": {"out_dir": 3}},
])
def test_invalid_telemetry_blocks_raise_as_in_jax(bad):
    ds = dict(BASE, telemetry=bad)
    with pytest.raises(jconfig.DeepSpeedConfigError) as je:
        jconfig.DeepSpeedConfig(copy.deepcopy(ds), world_size=1)
    with pytest.raises(tconfig.DeepSpeedConfigError) as te:
        tconfig.DeepSpeedConfig(copy.deepcopy(ds), world_size=1)
    assert str(te.value) == str(je.value)


def test_telemetry_and_flops_profiler_are_ported():
    c = tconfig.DeepSpeedConfig(dict(
        BASE, telemetry={"enabled": True},
        flops_profiler={"enabled": True}), world_size=1)
    assert c.unported_features() == []


# --------------------------------------------------------------------- #
# The stream against JAX's (gpt2-tiny)
# --------------------------------------------------------------------- #
def _gpt2_ds(out, **tel):
    return {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
            "bf16": {"enabled": True},
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_num_steps": 4, "warmup_max_lr": 1e-3}},
            "telemetry": dict({"enabled": True, "output_path": str(out),
                               "job_name": "run", "report_steps": 4},
                              **tel)}


def _gpt2_cfgs():
    off = dict(hidden_dropout=0.0, attn_dropout=0.0)
    return (dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"], **off),
            dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"],
                                fused_kernels=False, **off))


def _gpt2_batches(n=12):
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, (4, 33)).astype(np.int32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def gpt2_streams(tmp_path_factory):
    """12 steps of the JAX engine, the port's with telemetry, and the
    port's without: (jax records, port records, port losses, off
    losses, the two report summaries, the port engine)."""
    tcfg, jcfg = _gpt2_cfgs()
    params = jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0), jcfg))
    jdir = tmp_path_factory.mktemp("jax")
    tdir = tmp_path_factory.mktemp("port")
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params),
        config=_gpt2_ds(jdir), mesh=build_mesh(devices=jax.devices()[:1]))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg),
        model_params=convert.from_jax_params(params),
        config=_gpt2_ds(tdir), device="cpu", rng=0)
    ds_off = _gpt2_ds(tdir)
    ds_off["telemetry"] = {"enabled": False}
    toff, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg),
        model_params=convert.from_jax_params(params), config=ds_off,
        device="cpu", rng=0)
    tl, off = [], []
    for b in _gpt2_batches():
        jeng.train_batch(b)
        tl.append(float(teng.train_batch(b)))
        off.append(float(toff.train_batch(b)))
    jeng.telemetry.close()
    teng.close()
    tool = load_report_tool()
    jrep = tool.summarize(os.path.join(str(jdir), "run.jsonl"))
    trep = tool.summarize(os.path.join(str(tdir), "run.jsonl"))
    # JAX's fused-Adam moments are padded to its V-layout at dp 1; the
    # port's are the flat groups themselves.
    pad = sum(int(m.size) for m in jeng.state.opt_state.m) - \
        sum(int(np.prod(s)) for s in teng._leaf_shapes)
    return (read_jsonl(jdir), read_jsonl(tdir), tl, off, jrep, trep, teng,
            pad)


def _kinds(recs):
    return [r["kind"] if r["kind"] != "event" else f"event:{r['event']}"
            for r in recs]


def test_stream_kinds_and_meta_match_jax(gpt2_streams):
    jrecs, trecs = gpt2_streams[:2]
    assert _kinds(trecs) == _kinds(jrecs)
    assert _kinds(trecs) == (["meta", "cost_model"] +
                             (["step"] * 4 + ["report"]) * 3 + ["final"])
    jm, tm = jrecs[0], trecs[0]
    for key in ("dp", "zero_stage", "precision", "wire_bytes_per_step",
                "train_batch_size", "gradient_accumulation_steps",
                "cpu_offload", "grad_sync_mode", "emits_final",
                "health_enabled"):
        assert tm[key] == jm[key], key
    # The same state, but for the padding of JAX's two fp32 moments
    # (ROADMAP §3: a settled difference; 45568 elements here).
    pad = gpt2_streams[7]
    assert 0 < pad < 0.1 * sum(int(np.prod(s))
                               for s in gpt2_streams[6]._leaf_shapes)
    assert tm["analytic_state_bytes"] == \
        jm["analytic_state_bytes"] - 2 * 4 * pad


def test_step_records_match_jax(gpt2_streams):
    jrecs, trecs = gpt2_streams[:2]
    js = [r for r in jrecs if r["kind"] == "step"]
    ts = [r for r in trecs if r["kind"] == "step"]
    assert [r["step"] for r in ts] == [r["step"] for r in js] == \
        list(range(1, 13))
    for key in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in ts],
                                   [r[key] for r in js], rtol=BF16_RTOL,
                                   err_msg=key)
    for key in ("loss_scale", "overflow", "wire_bytes", "samples"):
        assert [r[key] for r in ts] == [r[key] for r in js], key
    # The grad tap stays out of the step records; every record has MFU.
    assert all("health_leaf_sq" not in r and r["mfu"] > 0 for r in ts)


def test_report_summaries_match_jax(gpt2_streams):
    jrep, trep = gpt2_streams[4:6]
    for key in ("steps_recorded", "dropped_records", "wire_bytes_per_step"):
        assert trep[key] == jrep[key], key
    assert trep["recompiles"]["count"] == jrep["recompiles"]["count"] == 0
    assert trep["truncated"] is False
    assert trep["roofline"]["available"] and \
        trep["roofline"]["chip"]["name"] == "h100-sxm"


def test_telemetry_leaves_the_losses_bit_equal(gpt2_streams):
    tl, off = gpt2_streams[2:4]
    assert tl == off


def test_cost_model_record(gpt2_streams):
    trecs, teng = gpt2_streams[1], gpt2_streams[6]
    cm = next(r for r in trecs if r["kind"] == "cost_model")
    path = cm["paths"]["train_step"]
    assert cm["bytes_source"] == path["bytes_source"] == "op_walk"
    assert cm["step"]["missing_paths"] == [] and cm["step"]["bound"]
    assert cm["step"]["flops_per_step"] == path["analytic_flops"] > 0
    # The per-step mfu is the shared formula at the walked flops.
    from deepspeed_tpu_torch.monitor.cost_model import mfu
    from deepspeed_tpu_torch.monitor.peaks import ChipPeaks
    peaks = ChipPeaks(**cm["chip"])
    for r in (r for r in trecs if r["kind"] == "step"):
        want = mfu(cm["step"]["flops_per_step"], r["wall_ms"] / 1e3, 1,
                   peaks)
        assert r["mfu"] == float(f"{want:.4g}")


# --------------------------------------------------------------------- #
# Lifecycle (the port's engine on a small MLP)
# --------------------------------------------------------------------- #
def mlp_params(seed=0, dim=8, hidden=16, classes=4):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.standard_normal((dim, hidden)) * 0.1)
            .astype(np.float32),
            "b1": np.zeros(hidden, np.float32),
            "w2": (rng.standard_normal((hidden, classes)) * 0.1)
            .astype(np.float32),
            "b2": np.zeros(classes, np.float32)}


def jax_mlp_loss(params, batch, rng):
    """tests/simple_model.simple_loss_fn plus sum(w2 * c): a NaN in c
    puts a NaN into w2's grad alone."""
    x, y, c = batch
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    logits = h @ params["w2"] + params["b2"]
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    onehot = jax.nn.one_hot(y, logits.shape[-1])
    return -jnp.mean(jnp.sum(onehot * logp, axis=-1)) + \
        jnp.sum(params["w2"] * c[0])


def port_mlp_loss(params, batch, rng):
    x, y, c = batch
    dt = params["w1"].dtype          # (the fp16 block casts the params)
    h = torch.tanh(x.to(dt) @ params["w1"] + params["b1"])
    logits = h @ params["w2"] + params["b2"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = torch.nn.functional.one_hot(y.long(), logits.shape[-1])
    return -torch.mean(torch.sum(onehot * logp, dim=-1)) + \
        torch.sum(params["w2"] * c[0].to(dt))


def mlp_batch(n=16, seed=0, nan=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = ((x.sum(axis=1) > 0).astype(np.int32) % 4)
    c = np.zeros((n, 16, 4), np.float32)
    if nan:
        c[0, 3, 1] = np.nan
    return x, y, c


def mlp_ds(out, tel=None, **extra):
    ds = {"train_batch_size": 16, "gradient_accumulation_steps": 1,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
          "steps_per_print": 1000,
          "telemetry": dict({"enabled": True, "output_path": str(out),
                             "job_name": "run"}, **(tel or {}))}
    ds.update(extra)
    return ds


def port_mlp(out, tel=None, training_data=None, **extra):
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=port_mlp_loss,
        model_params={k: torch.from_numpy(v) for k, v in
                      mlp_params().items()},
        config=mlp_ds(out, tel, **extra), device="cpu", rng=0,
        training_data=training_data)
    return eng


def jax_mlp(out, tel=None, training_data=None, **extra):
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    return DeepSpeedEngine(
        model=jax_mlp_loss,
        model_params={k: jnp.asarray(v) for k, v in mlp_params().items()},
        config=mlp_ds(out, tel, **extra), training_data=training_data,
        mesh=build_mesh(devices=jax.devices()[:1]))


def test_ring_overflow_is_reported(tmp_path):
    eng = port_mlp(tmp_path, {"report_steps": 5, "buffer_size": 2})
    for _ in range(5):
        eng.train_batch(mlp_batch())
    eng.close()
    recs = read_jsonl(tmp_path)
    steps = [r for r in recs if r["kind"] == "step"]
    rep = next(r for r in recs if r["kind"] == "report")
    assert [s["step"] for s in steps] == [4, 5]      # oldest dropped
    assert rep["records"] == 2 and rep["dropped_records"] == 3


def test_disabled_block_is_inert(tmp_path):
    eng = port_mlp(tmp_path, {"enabled": False,
                              "trace_path": str(tmp_path / "t.json")})
    eng.train_batch(mlp_batch())
    eng.close()
    tl = eng.telemetry
    assert not tl.enabled and tl.sink is None and tl.sentinel is None
    # No wrapping: the step path is the engine's own function.
    assert eng._step_fn is type(eng)._train_step
    assert "health_leaf_sq" not in eng.last_metrics
    assert os.listdir(tmp_path) == []


def test_sentinel_catches_an_induced_shape_change(tmp_path):
    eng = port_mlp(tmp_path, {"report_steps": 100})
    for _ in range(3):
        eng.train_batch(mlp_batch())
    assert eng.telemetry.recompile_count == 0
    eng.train_batch(mlp_batch(n=32))          # new shape after warmup
    assert eng.telemetry.recompile_count == 1
    ev = eng.telemetry.sentinel.events[0]
    assert ev["fn"] == "train_step"
    assert any("float32[16,8] -> float32[32,8]" in d
               for d in ev["signature_delta"])
    eng.close()
    recs = read_jsonl(tmp_path)
    assert [r["event"] for r in recs if r["kind"] == "event"] == \
        ["recompile"]


def test_fail_on_recompile_raises_after_the_state_is_stored(tmp_path):
    eng = port_mlp(tmp_path, {"report_steps": 100,
                              "fail_on_recompile": True})
    for _ in range(3):
        eng.train_batch(mlp_batch())
    with pytest.raises(RecompileError, match="train_step"):
        eng.train_batch(mlp_batch(n=32))
    # The step ran and was stored: the engine counts it and goes on.
    assert eng.global_steps == 4
    eng.train_batch(mlp_batch(n=32))
    eng.close()


def test_profile_window_is_refused(tmp_path):
    """``profile_window`` arms a window (it was refused, naming ROADMAP
    queue 1 item 9, until the window was ported): the same step range
    as JAX's for the same call, a second arm refused (None) on both,
    and the captured steps land in the JSONL as a ``profile`` event
    whose buckets and idle sum to the window's wall. A config window
    builds too; telemetry off, None."""
    eng = port_mlp(tmp_path / "port")
    jeng = jax_mlp(tmp_path / "jax")
    for e in (eng, jeng):
        e.train_batch(mlp_batch())
    got, want = eng.profile_window(2), jeng.profile_window(2)
    assert os.path.basename(got) == os.path.basename(want) == "step_2_4"
    assert got == str(tmp_path / "port" / "torch_trace" / "step_2_4")
    assert eng.profile_window(2) is None and jeng.profile_window(2) is None
    jeng.telemetry.close()
    for _ in range(4):
        eng.train_batch(mlp_batch())
    eng.close()
    recs = read_jsonl(tmp_path / "port")
    prof = [r for r in recs if r.get("event") == "profile"]
    assert len(prof) == 1 and "error" not in prof[0]
    assert prof[0]["window"]["path"] == got
    assert prof[0]["decomposition"]["sum_check"]["explained_frac"] == \
        pytest.approx(1.0, abs=0.05)
    cfg = port_mlp(tmp_path / "cfg", {"profile": {"start_step": 1}})
    assert cfg.telemetry.profiler.start_step == 1
    cfg.close()
    off = port_mlp(tmp_path, {"enabled": False})
    assert off.profile_window(2) is None


def test_a_drain_is_one_batched_copy(tmp_path, monkeypatch):
    calls = []
    real = ttel._fetch

    def counted(values):
        calls.append(len(values))
        return real(values)

    monkeypatch.setattr(ttel, "_fetch", counted)
    eng = port_mlp(tmp_path, {"report_steps": 3})
    for _ in range(6):
        eng.train_batch(mlp_batch())
    assert len(calls) == 2 and all(n > 3 * 6 for n in calls)
    eng.close()


def test_trace_spans_and_flight_recorder(tmp_path):
    eng = port_mlp(tmp_path, {"report_steps": 2,
                              "trace_path": str(tmp_path / "trace.json")})
    for _ in range(2):
        eng.train_batch(mlp_batch())
    loss = eng.forward(mlp_batch())
    eng.backward(loss)
    eng.step()
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    eng.load_checkpoint(str(tmp_path / "ckpt"))
    eng.close()
    names = [e["name"] for e in json.load(open(tmp_path / "trace.json"))]
    for span in ("train_batch", "step_dispatch", "data_prep",
                 "grad_compute", "optimizer_apply", "checkpoint_save",
                 "checkpoint_load", "trace_end"):
        assert span in names, span
    flight = json.load(open(tmp_path / "FLIGHT.json"))
    assert flight["reason"] == "close" and flight["closed_clean"]
    assert flight["final_step"] == 3


# --------------------------------------------------------------------- #
# Goodput: the same buckets as JAX's
# --------------------------------------------------------------------- #
class SlowDataset:
    """tests/test_telemetry.py's injected data stall."""

    def __init__(self, n=64, delay_s=0.002):
        self.x, self.y, self.c = mlp_batch(n)
        self.delay_s = delay_s

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        time.sleep(self.delay_s)
        return self.x[i], self.y[i], self.c[i]


def _assert_sums_to_wall(window):
    """Buckets sum to the window's wall within 1% (JAX's identity)."""
    total = sum(window[f"{b}_s"] for b in GOODPUT_BUCKETS)
    assert abs(total - window["window_s"]) <= \
        0.01 * window["window_s"] + 1e-9
    assert window["consistent"]


def _goodput_run(make, out, scenario):
    if scenario == "slow_dataset":
        eng = make(out, {"report_steps": 5},
                   training_data=SlowDataset())
        for _ in range(5):
            eng.train_batch()
    elif scenario == "overflow":
        eng = make(out, {"report_steps": 4},
                   fp16={"enabled": True, "initial_scale_power": 8,
                         "hysteresis": 1})
        good = mlp_batch()
        bad = tuple(np.full_like(a, np.nan) if i == 0 else a
                    for i, a in enumerate(good))
        for b in (good, bad, bad, good):
            eng.train_batch(b)
    else:                                      # trailing checkpoint
        eng = make(out, {"report_steps": 2})
        for _ in range(2):
            eng.train_batch(mlp_batch())
        eng.save_checkpoint(str(out / "ckpt"))
    eng.telemetry.close()
    recs = read_jsonl(out)
    return [r["goodput"] for r in recs if r["kind"] == "report"], \
        [r for r in recs if r["kind"] == "step"]


@pytest.mark.parametrize("scenario", ["slow_dataset", "overflow",
                                      "trailing_checkpoint"])
def test_goodput_buckets_match_jax(tmp_path, scenario):
    jw, js = _goodput_run(jax_mlp, tmp_path / "jax", scenario)
    tw, ts = _goodput_run(port_mlp, tmp_path / "port", scenario)
    assert len(tw) == len(jw)
    assert [s["overflow"] for s in ts] == [s["overflow"] for s in js]
    for a, b in zip(tw, jw):
        _assert_sums_to_wall(a)
        assert a["steps"] == b["steps"]
        # The same buckets hold time (window walls are each side's own).
        for bucket in ("data_stall", "overflow_skipped", "checkpoint",
                       "offload_exposed"):
            assert (a[f"{bucket}_s"] > 0) == (b[f"{bucket}_s"] > 0), \
                (bucket, a, b)
    if scenario == "slow_dataset":
        assert tw[0]["data_stall_s"] >= 5 * 16 * 0.002
    if scenario == "overflow":
        want = sum(s["wall_ms"] for s in ts if s["overflow"]) / 1e3
        assert tw[0]["overflow_skipped_s"] == pytest.approx(
            want, rel=1e-3, abs=1e-6)
    if scenario == "trailing_checkpoint":
        assert tw[-1]["steps"] == 0 and tw[-1]["checkpoint_s"] > 0


# --------------------------------------------------------------------- #
# Health: NaN provenance names JAX's leaf
# --------------------------------------------------------------------- #
def _nan_run(make, out):
    eng = make(out, {"report_steps": 50},
               fp16={"enabled": True, "initial_scale_power": 4})
    for i in range(5):
        eng.train_batch(mlp_batch(nan=(i == 3)))
    eng.telemetry.close()
    recs = read_jsonl(out)
    return [r for r in recs if r.get("event") == "anomaly"
            and r["anomaly"] == "nonfinite_grad"], recs


def test_nan_provenance_names_the_leaf_jax_names(tmp_path):
    jev, _ = _nan_run(jax_mlp, tmp_path / "jax")
    tev, trecs = _nan_run(port_mlp, tmp_path / "port")
    assert len(tev) == len(jev) == 1
    for key in ("first_nonfinite_leaf", "first_nonfinite_layer",
                "nonfinite_leaves", "num_leaves", "anomaly_step",
                "overflow"):
        assert tev[0][key] == jev[0][key], key
    assert tev[0]["first_nonfinite_leaf"] == "['w2']"
    assert tev[0]["layer_grad_norms"]["w2"] == "non-finite"
    for s in (r for r in trecs if r["kind"] == "step"):
        assert "health_leaf_sq" not in s
    flight = json.load(open(tmp_path / "port" / "FLIGHT.json"))
    assert flight["anomalies"]["counts"]["nonfinite_grad"] == 1


def test_tap_norms_are_unscaled_under_fp16(tmp_path):
    """sqrt(sum(tap)) is the step's (unscaled) grad_norm at a 2^12 loss
    scale, within fp32 rounding (1e-5 relative: a per-leaf norm and the
    flat sum add in other orders)."""
    eng = port_mlp(tmp_path, {"report_steps": 50},
                   fp16={"enabled": True, "initial_scale_power": 12},
                   gradient_clipping=1.0)
    eng.train_batch(mlp_batch())
    m = eng.last_metrics
    tap = m["health_leaf_sq"]
    assert tap.shape == (4,)
    np.testing.assert_allclose(float(tap.sum()) ** 0.5,
                               float(m["grad_norm"]), rtol=1e-5)
    eng.close()


@pytest.mark.parametrize("enabled", [False, True])
def test_a_deleted_engine_is_freed_without_a_collection(tmp_path, enabled):
    """The engine holds its instrumented step paths but no reference to
    itself through them: deleting it frees its state at once, with the
    garbage collector off (a cycle would keep the card's memory until
    the next collection)."""
    import gc
    import weakref
    eng = port_mlp(tmp_path, {"enabled": enabled})
    eng.train_batch(mlp_batch())
    eng.close()
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()
