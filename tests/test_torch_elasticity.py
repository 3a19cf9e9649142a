"""The port's batch-size elasticity (``deepspeed_tpu_torch/elasticity/``
and the ``DeepSpeedConfig`` pre-pass) against the JAX package's, on
``tests/test_elastic.py``'s cases: the same candidates, valid device
counts, batch sizes and micro-batches, the same exceptions, and the same
batch triple from ``DeepSpeedConfig`` at every world size the elastic
config allows; an elastic ds_config builds an engine that trains.
"""
import numpy as np
import pytest
import torch

from deepspeed_tpu.elasticity import (compute_elastic_config as jcompute,
                                      get_candidate_batch_sizes as jcands,
                                      get_valid_gpus as jvalid)
from deepspeed_tpu.elasticity import config as jecfg
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
import deepspeed_tpu_torch
from deepspeed_tpu_torch.elasticity import (compute_elastic_config,
                                            get_candidate_batch_sizes,
                                            get_valid_gpus)
from deepspeed_tpu_torch.elasticity import config as tecfg
from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS, gpt2_init, \
    gpt2_loss_fn
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig


def base_ds_config(**elastic_overrides):
    elastic = {"enabled": True, "max_train_batch_size": 10000,
               "micro_batch_sizes": [8, 12, 16, 17], "min_gpus": 32,
               "max_gpus": 1500, "min_time": 20, "version": 0.1}
    elastic.update(elastic_overrides)
    return {"elasticity": elastic}


@pytest.mark.parametrize("base, max_batch", [([8, 12, 16], 720),
                                             ([2, 3], 24), ([5], 3),
                                             ([8, 12, 16, 17], 10000)])
def test_candidates_match_jax(base, max_batch):
    assert get_candidate_batch_sizes(base, max_batch) == \
        jcands(base, max_batch)


@pytest.mark.parametrize("batch, micro, lo, hi", [
    (24, [2, 3], 1, 12), (720, [8, 12, 16], 1, 100), (7, [2], 1, 8)])
def test_valid_gpus_match_jax(batch, micro, lo, hi):
    assert get_valid_gpus(batch, micro, lo, hi) == \
        jvalid(batch, micro, lo, hi)


@pytest.mark.parametrize("overrides", [
    {}, {"prefer_larger_batch": False}, {"max_train_batch_size": 720},
    {"micro_batch_sizes": [2, 4, 6], "min_gpus": 1, "max_gpus": 64}])
def test_compute_elastic_config_matches_jax(overrides):
    cfg = base_ds_config(**overrides)
    want = jcompute(base_ds_config(**overrides), "0.1.0")
    assert compute_elastic_config(cfg, "0.1.0") == want
    valid = want[1]
    for ws in (valid[0], valid[len(valid) // 2], valid[-1]):
        assert compute_elastic_config(cfg, "0.1.0", world_size=ws) == \
            jcompute(base_ds_config(**overrides), "0.1.0", world_size=ws)


@pytest.mark.parametrize("overrides, exc", [
    ({"version": 0.2}, "ElasticityConfigError"),
    ({"micro_batch_sizes": []}, "ElasticityConfigError"),
    ({"micro_batch_sizes": [-1, 4]}, "ElasticityConfigError"),
    ({"min_gpus": 0}, "ElasticityConfigError")])
def test_bad_configs_raise_as_jax(overrides, exc):
    with pytest.raises(getattr(jecfg, exc)) as j:
        jcompute(base_ds_config(**overrides), "0.1.0")
    with pytest.raises(getattr(tecfg, exc)) as t:
        compute_elastic_config(base_ds_config(**overrides), "0.1.0")
    assert str(t.value) == str(j.value)


def test_incompatible_world_size_raises_as_jax():
    cfg = base_ds_config()
    _, valid, _ = jcompute(base_ds_config(), "0.1.0")
    bad = max(valid) + 1
    while bad in valid:
        bad += 1
    with pytest.raises(jecfg.ElasticityIncompatibleWorldSize) as j:
        jcompute(base_ds_config(), "0.1.0", world_size=bad)
    with pytest.raises(tecfg.ElasticityIncompatibleWorldSize) as t:
        compute_elastic_config(cfg, "0.1.0", world_size=bad)
    assert str(t.value) == str(j.value)


def test_batch_params_conflict_raises_as_jax():
    ds = dict(base_ds_config(), train_batch_size=128)
    with pytest.raises(jecfg.ElasticityConfigError) as j:
        JConfig(dict(ds), world_size=48)
    with pytest.raises(tecfg.ElasticityConfigError) as t:
        DeepSpeedConfig(dict(ds), world_size=48)
    assert str(t.value) == str(j.value)
    # ignore_non_elastic_batch_info: the elastic values win, as in JAX.
    ds = base_ds_config(ignore_non_elastic_batch_info=True)
    ds["train_batch_size"] = 128
    t, j = DeepSpeedConfig(dict(ds), world_size=48), \
        JConfig(dict(ds), world_size=48)
    assert (t.train_batch_size, t.train_micro_batch_size_per_gpu,
            t.gradient_accumulation_steps) == \
        (j.train_batch_size, j.train_micro_batch_size_per_gpu,
         j.gradient_accumulation_steps)


@pytest.mark.parametrize("world", [36, 48, 60, 120, 240, 720, 1080])
def test_config_batch_triple_matches_jax(world):
    t = DeepSpeedConfig(base_ds_config(), world_size=world)
    j = JConfig(base_ds_config(), world_size=world)
    assert t.elasticity_enabled and j.elasticity_enabled
    triple = (t.train_batch_size, t.train_micro_batch_size_per_gpu,
              t.gradient_accumulation_steps)
    assert triple == (j.train_batch_size, j.train_micro_batch_size_per_gpu,
                      j.gradient_accumulation_steps)
    assert t.train_batch_size == t.train_micro_batch_size_per_gpu * \
        t.gradient_accumulation_steps * world
    assert t.elastic_valid_gpus == j.elastic_valid_gpus


@pytest.mark.parametrize("world", [32, 64])
def test_config_invalid_world_raises_as_jax(world):
    with pytest.raises(jecfg.ElasticityIncompatibleWorldSize) as j:
        JConfig(base_ds_config(), world_size=world)
    with pytest.raises(tecfg.ElasticityIncompatibleWorldSize) as t:
        DeepSpeedConfig(base_ds_config(), world_size=world)
    assert str(t.value) == str(j.value)


def test_elastic_config_builds_an_engine_that_trains():
    """At world size 1 the elastic block (micro 2 or 4, up to 8 a step)
    solves micro 4, gas 2, and ``initialize`` trains on it."""
    ds = {"elasticity": {"enabled": True, "max_train_batch_size": 8,
                         "micro_batch_sizes": [2, 4], "min_gpus": 1,
                         "max_gpus": 4},
          "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}},
          "steps_per_print": 10 ** 9}
    cfg = GPT2_CONFIGS["gpt2-tiny"]
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(cfg), model_params=gpt2_init(
            cfg, torch.Generator().manual_seed(0), "cpu"),
        config=ds, device="cpu")
    assert eng.config.elasticity_enabled
    assert (eng.train_batch_size(), eng.train_micro_batch_size_per_gpu(),
            eng.gradient_accumulation_steps()) == (8, 4, 2)
    loss = eng.train_batch(np.random.default_rng(0).integers(0, 512,
                                                             (8, 33)))
    assert np.isfinite(float(loss)) and eng.global_steps == 1
