"""The port's training config, LR schedules, loss scaling and host-side
runtime modules against the JAX package, and the guards of its training
entry points.

- The same ds_config dicts solve to the same batch triple and parse to
  the same precision/optimizer/scheduler/clipping/ZeRO fields, and bad
  input is rejected with the same exception type and message.
- The four LR schedules give the same values over 100 steps: exactly on
  Python ints; within 1e-6 relative on int32 device tensors (the JAX
  traced branch, fp32 on both sides).
- The dynamic loss-scale machine gives the same (scale, growth count,
  hysteresis) sequence over a seeded overflow pattern, exactly, and so
  do the host-side ``DynamicLossScaler`` classes.
- ``runtime/utils`` (overflow test, global norm, clipping) within 1e-6
  relative; the data loaders yield equal batches; the timers count their
  fences; stochastic rounding to bf16 is unbiased (mean within 1e-3 of
  the distance between the two bf16 neighbours over 20000 draws) and
  passes inf/nan through.
- Guards: the training modules import no JAX; ``initialize()`` without
  CUDA and without ``device`` raises; every feature the port does not
  run yet raises ``NotImplementedError`` (the cases of features ported
  since, each a build-and-train case now); the ``tensorboard`` block is
  telemetry's alias, ``mesh.slices`` parses, and
  ``zero_optimization.dcn_compression`` on one slice raises JAX's
  ``ValueError``, each as the JAX package reads it.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime import utils as jutils
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
import deepspeed_tpu_torch
from deepspeed_tpu_torch.ops.stochastic_rounding import stochastic_round_bf16
from deepspeed_tpu_torch.runtime import dataloader as tdl
from deepspeed_tpu_torch.runtime import utils as tutils
from deepspeed_tpu_torch.utils import timer as ttimer
from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS, gpt2_init, \
    gpt2_loss_fn
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls

REPO = Path(__file__).resolve().parent.parent
CFG = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32,
                          hidden_dropout=0.0, attn_dropout=0.0)

CONFIGS = [
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4}, 1),
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4}, 2),
    ({"train_batch_size": 32, "gradient_accumulation_steps": 4}, 1),
    ({"train_micro_batch_size_per_gpu": 4,
      "gradient_accumulation_steps": 2}, 1),
    ({"train_batch_size": 16}, 1),
    ({"train_micro_batch_size_per_gpu": 3}, 1),
    ({}, 1),
    ({"train_batch_size": 10, "train_micro_batch_size_per_gpu": 4,
      "gradient_accumulation_steps": 2}, 1),
    ({"train_batch_size": 8, "fp16": {"enabled": True},
      "bf16": {"enabled": True}}, 1),
    ({"train_batch_size": 8, "bf16": {"stochastic_rounding": True}}, 1),
    ({"train_batch_size": 8, "amp": {"enabled": True},
      "fp16": {"enabled": True}}, 1),
    ({"train_batch_size": 8, "amp": {"enabled": True, "opt_level": "O1"}},
     1),
    ({"train_batch_size": 8, "zero_optimization": {"stage": 4}}, 1),
    ({"train_batch_size": 8, "zero_optimization": {"grad_sync": "eager"}},
     1),
    ({"train_batch_size": 8, "zero_optimization": True}, 1),
    ({"train_batch_size": 8, "zero_optimization": {
        "stage": 3, "reduce_scatter": False}}, 1),
    ({"train_batch_size": 8, "zero_optimization": {
        "stage": 2, "prefetch_depth": -1}}, 1),
    ({"train_batch_size": 64, "train_micro_batch_size_per_gpu": 8,
      "gradient_clipping": 1.0, "steps_per_print": 5,
      "wall_clock_breakdown": True,
      "optimizer": {"type": "AdamW", "params": {
          "lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}},
      "scheduler": {"type": "WarmupDecayLR", "params": {
          "warmup_num_steps": 10, "total_num_steps": 100}},
      "fp16": {"enabled": True, "initial_scale_power": 16,
               "loss_scale_window": 500, "hysteresis": 3,
               "min_loss_scale": 2},
      "zero_optimization": {"stage": 2, "overlap_comm": True}}, 1),
    ({"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {
        "lr": 1e-3, "fused": False}}, "bf16": {
            "enabled": True, "stochastic_rounding": True}}, 1),
]
FIELDS = ("train_batch_size", "train_micro_batch_size_per_gpu",
          "gradient_accumulation_steps", "steps_per_print",
          "gradient_clipping", "fp16_enabled", "fp16_loss_scale",
          "fp16_initial_scale_power", "fp16_loss_scale_window",
          "fp16_hysteresis", "fp16_min_loss_scale", "bf16_enabled",
          "bf16_stochastic_rounding", "amp_enabled", "amp_params",
          "optimizer_name", "optimizer_params", "optimizer_fused",
          "scheduler_name", "scheduler_params", "wall_clock_breakdown",
          "zero_optimization_stage", "zero_enabled", "precision_dtype")


def _parse(mod, d, world):
    try:
        c = mod.DeepSpeedConfig(json.loads(json.dumps(d)),
                                world_size=world)
    except Exception as e:                      # noqa: BLE001
        return ("error", type(e).__name__, str(e))
    out = {f: getattr(c, f) for f in FIELDS}
    out["zero"] = {k: v for k, v in vars(c.zero_config).items()}
    return ("ok", out)


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_config_parity(i):
    d, world = CONFIGS[i]
    assert _parse(tconfig, d, world) == _parse(jconfig, d, world)


SPARSE_SECTIONS = [
    None,
    {},
    {"mode": "nonsense"},
    {"mode": "fixed", "block": 128},
    {"mode": "fixed", "block": 128, "num_local_blocks": 4,
     "num_global_blocks": 1, "attention": "unidirectional"},
    {"mode": "fixed", "num_random_blocks": 2},
    {"mode": "dense", "block": 64},
    {"mode": "dense", "different_layout_per_head": True},
    {"mode": "variable", "local_window_blocks": [2, 4],
     "global_block_end_indices": [2]},
    {"mode": "bigbird", "num_random_blocks": 2,
     "different_layout_per_head": True},
    {"mode": "bigbird", "attention": "unidirectional"},
    {"mode": "bslongformer", "global_block_indices": [0, 4]},
    {"mode": "bslongformer", "bogus": 1},
]


@pytest.mark.parametrize("i", range(len(SPARSE_SECTIONS)))
def test_sparse_attention_section_parity(i):
    """The ``sparse_attention`` section: the same normalized dict (mode
    defaults filled in) or the same error as the JAX package's."""
    d = {"train_batch_size": 8}
    if SPARSE_SECTIONS[i] is not None:
        d["sparse_attention"] = SPARSE_SECTIONS[i]

    def parse(mod):
        try:
            return ("ok", mod.DeepSpeedConfig(
                json.loads(json.dumps(d))).sparse_attention)
        except Exception as e:                  # noqa: BLE001
            return ("error", type(e).__name__, str(e))
    assert parse(tconfig) == parse(jconfig)


def test_duplicate_keys_rejected_alike(tmp_path):
    p = tmp_path / "ds.json"
    p.write_text('{"train_batch_size": 8, "train_batch_size": 16}')
    errs = []
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError) as e:
            mod.DeepSpeedConfig(str(p), world_size=1)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


SCHEDULES = [
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 30}),
    ("WarmupLR", {"warmup_max_lr": 6e-4, "warmup_num_steps": 50,
                  "warmup_type": "linear"}),
    ("WarmupDecayLR", {"warmup_max_lr": 1e-3, "warmup_num_steps": 20,
                       "total_num_steps": 80}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 30, "cycle_second_step_size": 40,
                  "decay_lr_rate": 0.01, "decay_step_size": 5}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 7,
                     "lr_range_test_step_rate": 2.0,
                     "lr_range_test_staircase": True}),
]


@pytest.mark.parametrize("i", range(len(SCHEDULES)))
def test_lr_schedule_parity(i):
    name, params = SCHEDULES[i]
    ts, js = tlr.get_lr_schedule(name, params), \
        jlr.get_lr_schedule(name, params)
    steps = range(100)
    assert [ts.lr_at(s) for s in steps] == [js.lr_at(s) for s in steps]
    got = ts.lr_at(torch.arange(100, dtype=torch.int32))
    want = np.asarray(js.lr_at(jnp.arange(100, dtype=jnp.int32)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    for sched in (ts, js):
        sched.step(41)
    assert ts.get_lr() == js.get_lr()
    with pytest.raises(ValueError, match="Unknown lr schedule"):
        tlr.get_lr_schedule("Cosine", {})


def test_loss_scale_sequence_parity():
    kw = dict(initial_scale=2.0 ** 16, dynamic=True, scale_window=10,
              min_scale=2.0, hysteresis=2)
    ts, js = tls.make_loss_scale_state(**kw), jls.make_loss_scale_state(**kw)
    overflow = np.random.default_rng(0).random(300) < 0.3
    overflow[100:160] = True                 # drive the scale to its floor
    overflow[200:240] = False                # and let it grow back
    for k, o in enumerate(overflow):
        ts = tls.update_loss_scale(ts, torch.tensor(bool(o)))
        js = jls.update_loss_scale(js, jnp.asarray(bool(o)))
        got = (float(ts.loss_scale), int(ts.growth_count),
               int(ts.hysteresis))
        assert got == (float(js.loss_scale), int(js.growth_count),
                       int(js.hysteresis)), k


def test_host_loss_scaler_classes_match_jax():
    kw = dict(init_scale=2.0 ** 10, scale_window=4, min_scale=1.0,
              delayed_shift=2)
    ts, js = tls.DynamicLossScaler(**kw), jls.DynamicLossScaler(**kw)
    for o in np.random.default_rng(1).random(60) < 0.4:
        ts.update_scale(bool(o))
        js.update_scale(bool(o))
        assert (ts.loss_scale, ts.cur_hysteresis) == \
            (js.loss_scale, js.cur_hysteresis)
    assert tls.LossScaler(8.0).loss_scale == jls.LossScaler(8.0).loss_scale


def test_runtime_utils_match_jax():
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": [rng.standard_normal(7).astype(np.float32)]}
    tt = {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(tree["b"][0])]}
    jt = {"a": jnp.asarray(tree["a"]), "b": [jnp.asarray(tree["b"][0])]}
    for ord_ in (1, 2, 3):
        np.testing.assert_allclose(float(tutils.global_norm(tt, ord_)),
                                   float(jutils.global_norm(jt, ord_)),
                                   rtol=1e-6)
    clipped, norm = tutils.clip_grad_norm_(tt, 0.5)
    jclipped, jnorm = jutils.clip_grad_norm_(jt, 0.5)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(clipped["a"].numpy(),
                               np.asarray(jclipped["a"]), rtol=1e-6)
    np.testing.assert_allclose(float(tutils.clip_coefficient(norm, 0.5)),
                               float(jutils.clip_coefficient(jnorm, 0.5)),
                               rtol=1e-6)
    assert not bool(tutils.tree_has_inf_or_nan(tt))
    tt["b"][0][3] = float("nan")
    assert bool(tutils.tree_has_inf_or_nan(tt))


def test_data_loaders_match_jax():
    x = np.arange(46 * 3).reshape(46, 3)
    y = np.arange(46)
    for kw in (dict(shuffle=False), dict(shuffle=True, seed=5),
               dict(drop_last=False)):
        tl = tdl.DeepSpeedDataLoader(tdl.ArrayDataset(x, y), 4, **kw)
        jl = jdl.DeepSpeedDataLoader(jdl.ArrayDataset(x, y), 4,
                                     data_parallel_world_size=1,
                                     data_parallel_rank=0, **kw)
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    it = tdl.RepeatingLoader([1, 2])
    assert [next(it) for _ in range(5)] == [1, 2, 1, 2, 1]


def test_engine_pulls_micro_batches_from_training_data():
    tokens = np.random.default_rng(3).integers(0, 512, (12, 17))
    eng, _, loader, _ = _init(dict(BASE, train_batch_size=4,
                                   gradient_accumulation_steps=2),
                              training_data=tdl.ArrayDataset(tokens))
    assert len(loader) == 6
    first = float(eng.train_batch())
    ref = _init(dict(BASE, train_batch_size=4,
                     gradient_accumulation_steps=2))[0]
    assert first == float(ref.train_batch(tokens[:4]))
    assert eng.global_steps == 1 and eng.global_samples == 4


def test_timers_count_their_fences():
    before = ttimer.device_sync_count()
    t = ttimer.SynchronizedWallClockTimer()
    t("step").start()
    t("step").stop()
    assert t("step").count == 1 and t("step").elapsed() >= 0.0
    tp = ttimer.ThroughputTimer(batch_size=8, start_step=1,
                                steps_per_output=2)
    for _ in range(5):
        tp.start()
        tp.stop()
    assert tp.has_samples() and tp.avg_samples_per_sec() > 0
    # two for the wall-clock timer; the throughput timer fences where a
    # window opens (the 2nd, 3rd and 5th start) and where one closes (the
    # 2nd and 4th stop)
    assert ttimer.device_sync_count() - before == 2 + 3 + 2


def test_stochastic_round_bf16_is_unbiased():
    lo = torch.tensor(1.0, dtype=torch.bfloat16).float()
    hi = torch.nextafter(torch.tensor(1.0, dtype=torch.bfloat16),
                         torch.tensor(2.0, dtype=torch.bfloat16)).float()
    x = torch.full((20000,), float(lo + 0.3 * (hi - lo)))
    out = stochastic_round_bf16(x, torch.Generator().manual_seed(0))
    assert out.dtype == torch.bfloat16
    assert set(out.float().unique().tolist()) == {float(lo), float(hi)}
    assert abs((out.float().mean() - x[0]) / (hi - lo)) < 1e-2
    special = torch.tensor([float("inf"), float("-inf"), float("nan")])
    got = stochastic_round_bf16(special, torch.Generator().manual_seed(1))
    assert torch.isinf(got[:2]).all() and torch.isnan(got[2])


def test_training_modules_import_no_jax():
    code = ("import sys, deepspeed_tpu_torch.runtime.engine, "
            "deepspeed_tpu_torch.ops.cross_entropy, "
            "deepspeed_tpu_torch.ops.stochastic_rounding, "
            "deepspeed_tpu_torch.runtime.dataloader, "
            "deepspeed_tpu_torch.utils.timer\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'deepspeed_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


BASE = {"train_batch_size": 2, "steps_per_print": 10 ** 9,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}


def _init(ds=None, cfg=CFG, device="cpu", **kw):
    params = gpt2_init(CFG, torch.Generator().manual_seed(0), "cpu")
    return deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(cfg), model_params=params,
        config=ds or BASE, device=device, **kw)


def test_initialize_without_cuda_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _init(device=None)


def test_stage3_config_is_accepted():
    """ZeRO stage 3 is ported: on one card it runs as stage 2 (nothing
    to partition), and a step gives the stage-2 engine's loss and
    params bit for bit."""
    from deepspeed_tpu_torch.ops.fused_update import tree_flatten
    batch = np.random.default_rng(0).integers(0, 512, (2, 33))
    out = []
    for stage in (2, 3):
        eng = _init(dict(BASE, zero_optimization={"stage": stage}))[0]
        assert eng.zero_optimization_stage() == stage
        loss = float(eng.train_batch(batch))
        out.append((loss, [t.detach().clone() for t in
                           tree_flatten(eng.state.params)[0]]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("extra, match", [
    ({"zero_optimization": {"stage": 2, "cpu_offload": True}},
     "cpu_offload"),
    ({"optimizer": {"type": "OnebitAdam", "params": {}}}, "OnebitAdam"),
    ({"sparse_gradients": True}, "sparse_gradients"),
    ({"pipeline": {"stages": 2}}, "pipeline"),
    ({"mesh": {"model_parallel_size": 2}}, "tensor/sequence"),
    ({"moe": {"num_experts": 4, "expert_parallel_size": 2}}, "moe"),
    ({"progressive_layer_drop": {"enabled": True}},
     "progressive_layer_drop"),
    ({"telemetry": {"enabled": True}}, "telemetry"),
    ({"optimizer": {"type": "AdamW", "params": {"fused": False}}},
     "fused: false"),
    ({"optimizer": {"type": "SGD", "params": {}}}, "'sgd' is not ported"),
    ({"optimizer": {"type": "Lamb", "params": {}}}, "'lamb' is not ported"),
    ({"elasticity": {"enabled": True, "max_train_batch_size": 2,
                     "micro_batch_sizes": [1, 2], "min_gpus": 1,
                     "max_gpus": 1, "ignore_non_elastic_batch_info": True}},
     "elasticity"),
    ({"tensorboard": {"enabled": True, "output_path": "tb"}},
     "tensorboard block"),
    ({"tensorboard": {"enabled": True}, "telemetry": {"enabled": False}},
     "telemetry off wins"),
    ({"mesh": {"slices": 2}}, "mesh.slices"),
    ({"zero_optimization": {"stage": 2, "dcn_compression": True}},
     "dcn_compression"),
])
def test_unported_config_raises(extra, match, tmp_path, monkeypatch):
    if match in ("telemetry", "tensorboard block"):
        # Training telemetry is ported (its tensorboard alias too): the
        # block builds an engine that trains and writes its stream
        # (tests/test_torch_telemetry*.py hold it against JAX).
        monkeypatch.chdir(tmp_path)
        eng = _init(dict(BASE, **extra))[0]
        assert eng.telemetry.enabled
        loss = eng.train_batch(np.random.default_rng(0).integers(
            0, 512, (2, 33)))
        assert np.isfinite(float(loss)) and eng.global_steps == 1
        eng.close()
        out = tmp_path / ("tb" if match == "tensorboard block" else "runs")
        kinds = [json.loads(line)["kind"] for line in
                 (out / "DeepSpeedJobName.jsonl").read_text().splitlines()]
        assert kinds[0] == "meta" and kinds[-1] == "final" and \
            kinds.count("step") == 1
        return
    if match in ("fused: false", "'sgd' is not ported",
                 "'lamb' is not ported", "elasticity"):
        # The unfused Adam chain, SGD, Lamb and batch-size elasticity are
        # ported: the config builds an engine that trains
        # (tests/test_torch_optimizers.py and tests/test_torch_
        # elasticity.py hold them against JAX).
        eng = _init(dict(BASE, **extra))[0]
        loss = eng.train_batch(np.random.default_rng(0).integers(
            0, 512, (2, 33)))
        assert np.isfinite(float(loss)) and eng.global_steps == 1
        if match == "elasticity":
            assert eng.config.elasticity_enabled
            assert eng.train_micro_batch_size_per_gpu() == 2
        else:
            assert type(eng.optimizer).__name__ == {
                "fused: false": "AdamChain", "'sgd' is not ported": "SGD",
                "'lamb' is not ported": "Lamb"}[match]
        return
    if match == "cpu_offload":
        # ZeRO-Offload is ported: the config builds an offload engine
        # that trains (tests/test_torch_offload.py holds it against JAX).
        eng = _init(dict(BASE, **extra))[0]
        assert eng._offload is not None
        loss = eng.train_batch(np.random.default_rng(0).integers(
            0, 512, (2, 33)))
        assert np.isfinite(float(loss)) and eng._offload.step_count == 1
        return
    if match == "progressive_layer_drop":
        # Progressive layer drop is ported: the block builds an engine
        # that hands theta to the loss and trains
        # (tests/test_torch_pld.py holds it against JAX).
        eng = _init(dict(BASE, **extra))[0]
        assert eng.progressive_layer_drop is not None and eng._accepts_pld
        loss = eng.train_batch(np.random.default_rng(0).integers(
            0, 512, (2, 33)))
        assert np.isfinite(float(loss)) and eng.global_steps == 1
        return
    if match == "OnebitAdam":
        # 1-bit Adam is ported: the config builds an engine whose own
        # train step trains (tests/test_torch_onebit.py holds it against
        # JAX).
        eng = _init(dict(BASE, **extra))[0]
        assert eng._onebit and type(eng.optimizer).__name__ == "OnebitAdam"
        loss = eng.train_batch(np.random.default_rng(0).integers(
            0, 512, (2, 33)))
        assert np.isfinite(float(loss)) and \
            int(eng.state.opt_state.step) == 1
        return
    if match == "sparse_gradients":
        # Sparse gradients are ported: the config marks wte and, at dp 1,
        # trains on the main path as JAX does (tests/test_torch_sparse_
        # grads.py and test_torch_onebit_sparse_dp.py hold the CSR
        # exchange at dp > 1 against JAX).
        eng = _init(dict(BASE, **extra))[0]
        assert eng._sparse_names == ["['wte']"]
        loss = eng.train_batch(np.random.default_rng(0).integers(
            0, 512, (2, 33)))
        assert np.isfinite(float(loss)) and eng.sparse_comm_stats == {}
        return
    if match == "telemetry off wins":
        # (F1) an explicit telemetry key wins over its tensorboard alias
        eng = _init(dict(BASE, **extra))[0]
        assert eng.config.tensorboard_enabled and \
            not eng.config.telemetry_enabled
        return
    if match == "pipeline":
        # The pipeline is ported (tests/test_torch_pipe*.py hold it
        # against JAX): a plain loss_fn model under a pipeline of 2
        # stages is refused, naming the pipelined model it needs; a
        # PipeSpec builds the PipelineEngine, which trains; a pipeline
        # block that is not a dict is refused at parse time.
        with pytest.raises(ValueError, match="pipeline parallelism"):
            _init(dict(BASE, **extra))
        from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipe_spec
        spec = gpt2_pipe_spec(CFG, torch.Generator().manual_seed(0),
                              device="cpu")
        eng = deepspeed_tpu_torch.initialize(
            model=spec, config=dict(BASE, pipeline={"schedule": "1f1b"}),
            device="cpu")[0]
        assert type(eng).__name__ == "PipelineEngine"
        loss = eng.train_batch(np.random.default_rng(0).integers(
            0, 512, (2, 33)))
        assert np.isfinite(float(loss)) and eng.global_steps == 1
        from deepspeed_tpu_torch.runtime.config import (
            DeepSpeedConfig, DeepSpeedConfigError)
        with pytest.raises(DeepSpeedConfigError, match="dict"):
            DeepSpeedConfig(dict(BASE, pipeline=2), world_size=1)
        return
    if match == "tensor/sequence":
        # Tensor and sequence parallelism are ported: the mesh block no
        # longer names an unported feature; a world of one refuses mp 2
        # with JAX's mesh error; a world of two trains a step through it
        # (tests/test_torch_tensor_parallel.py holds it against JAX).
        from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
        ds = dict(BASE, **extra)
        assert DeepSpeedConfig(ds, world_size=1).unported_features() == []
        with pytest.raises(ValueError, match="not divisible by mp"):
            _init(ds)
        import torch_dp_worker as W
        from test_torch_dp import load, save_params, wait
        save_params({k: v.numpy() if not isinstance(v, dict) else
                     {n: t.numpy() for n, t in v.items()}
                     for k, v in gpt2_init(
                         CFG, torch.Generator().manual_seed(0),
                         "cpu").items()}, str(tmp_path / "p.npz"))
        np.save(tmp_path / "b.npy", np.random.default_rng(0).integers(
            0, 512, (1, 4, 33)).astype(np.int32))
        wait(W.spawn_forked(tmp_path, 2, [dict(
            name="mp2", precision="fp32", stage=0, mesh={"mp": 2},
            batches=str(tmp_path / "b.npy"),
            out=str(tmp_path / "mp2"))], "w2", str(tmp_path / "p.npz")))
        for r in load(str(tmp_path / "mp2"), 2):
            assert np.isfinite(r["loss"]).all() and len(r["loss"]) == 1
        return
    if match == "dcn_compression":
        # (F3) the JAX engine's refusal on a single slice
        with pytest.raises(ValueError, match="zero_optimization."
                           "dcn_compression requires a multi-slice mesh"):
            _init(dict(BASE, **extra))
        return
    with pytest.raises(NotImplementedError, match=match) as err:
        _init(dict(BASE, **extra))
    if match == "mesh.slices":
        # (F2) queue 1 item 7's multislice
        assert "item 7" in str(err.value)


@pytest.mark.parametrize("d", [
    {}, {"tensorboard": {"enabled": True}},
    {"tensorboard": {"enabled": True, "output_path": "x", "job_name": "j"}},
    {"tensorboard": {"enabled": True}, "telemetry": {"enabled": False}},
    {"tensorboard": {"enabled": False}, "telemetry": {"enabled": True}},
    {"mesh": {"slices": 2}}, {"mesh": {"slices": 1}}])
def test_telemetry_alias_and_slices_parse_as_jax(d):
    """F1/F2: ``telemetry.enabled`` defaults to ``tensorboard.enabled``
    (an explicit telemetry key wins) and ``mesh.slices`` parses, as the
    JAX ``TelemetryConfig`` and ``MeshConfig`` read them."""
    ds = dict(BASE, **d)
    j = jconfig.DeepSpeedConfig(json.loads(json.dumps(ds)), world_size=1)
    t = tconfig.DeepSpeedConfig(json.loads(json.dumps(ds)), world_size=1)
    assert t.telemetry_enabled == j.telemetry_config.enabled
    assert t.tensorboard_enabled == j.tensorboard_config.enabled
    assert t.tensorboard_output_path == j.tensorboard_config.output_path
    assert t.tensorboard_job_name == j.tensorboard_config.job_name
    assert t.mesh_num_slices == j.mesh_config.num_slices
    for bad in (0, "2"):
        ds = dict(BASE, mesh={"slices": bad})
        with pytest.raises(Exception) as je:
            jconfig.DeepSpeedConfig(json.loads(json.dumps(ds)), world_size=1)
        with pytest.raises(Exception) as te:
            tconfig.DeepSpeedConfig(json.loads(json.dumps(ds)), world_size=1)
        assert type(te.value).__name__ == type(je.value).__name__
        assert str(te.value) == str(je.value)


def test_unported_engine_paths_raise(monkeypatch):
    # Activation recomputation is ported: remat_policy "full" trains
    # (tests/test_torch_remat.py holds every policy against JAX).
    eng = _init(cfg=dataclasses.replace(CFG, remat_policy="full"))[0]
    assert np.isfinite(float(eng.train_batch(
        np.random.default_rng(0).integers(0, 512, (2, 33)))))
    # Client optimizers are ported: a torch.optim class trains; any
    # other object raises a TypeError (tests/test_torch_optimizers.py).
    with pytest.raises(TypeError, match="optimizer must be"):
        _init(optimizer=object())
    eng = _init(optimizer=torch.optim.SGD)[0]
    assert np.isfinite(float(eng.train_batch(
        np.random.default_rng(0).integers(0, 512, (2, 33)))))
    with pytest.raises(NotImplementedError, match="no CUDA path"):
        _init(cfg=dataclasses.replace(CFG, fused_kernels=False),
              device="cuda")
    # The forward/backward/step trio is ported: one window of gas 1
    # takes a step (tests/test_torch_engine_api.py holds it against JAX).
    eng = _init()[0]
    loss = eng.forward(np.random.default_rng(0).integers(0, 512, (2, 33)))
    eng.backward(loss)
    eng.step()
    assert np.isfinite(float(loss)) and eng.global_steps == 1
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="call deepspeed_tpu_torch."
                       "init_distributed"):
        _init()
