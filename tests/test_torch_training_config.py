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
  run yet raises ``NotImplementedError``.
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


@pytest.mark.parametrize("extra, match", [
    ({"zero_optimization": {"stage": 3}}, "stage 3"),
    ({"zero_optimization": {"stage": 2, "cpu_offload": True}},
     "cpu_offload"),
    ({"optimizer": {"type": "OnebitAdam", "params": {}}}, "OnebitAdam"),
    ({"sparse_gradients": True}, "sparse_gradients"),
    ({"pipeline": {"stages": 2}}, "pipeline"),
    ({"mesh": {"model_parallel_size": 2}}, "tensor/sequence"),
    ({"moe": {"num_experts": 4, "expert_parallel_size": 2}}, "moe"),
    ({"progressive_layer_drop": {"enabled": True}},
     "progressive_layer_drop"),
    ({"checkpoint": {"async": True}}, "checkpoint"),
    ({"optimizer": {"type": "AdamW", "params": {"fused": False}}},
     "fused: false"),
    ({"optimizer": {"type": "SGD", "params": {}}}, "'sgd' is not ported"),
    ({"optimizer": {"type": "Lamb", "params": {}}}, "'lamb' is not ported"),
    ({"elasticity": {"enabled": True}}, "elasticity"),
])
def test_unported_config_raises(extra, match):
    with pytest.raises(NotImplementedError, match=match):
        _init(dict(BASE, **extra))


def test_unported_engine_paths_raise(monkeypatch):
    with pytest.raises(NotImplementedError, match="remat"):
        _init(cfg=dataclasses.replace(CFG, remat_policy="full"))
    with pytest.raises(NotImplementedError, match="client optimizer"):
        _init(optimizer=object())
    with pytest.raises(NotImplementedError, match="no CUDA path"):
        _init(cfg=dataclasses.replace(CFG, fused_kernels=False),
              device="cuda")
    eng = _init()[0]
    for call in (eng.forward, eng.backward, eng.step):
        with pytest.raises(NotImplementedError, match="forward/backward"):
            call()
    for call in (eng.save_checkpoint, eng.load_checkpoint):
        with pytest.raises(NotImplementedError, match="checkpoint"):
            call("ckpt")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="more than one card"):
        _init()
