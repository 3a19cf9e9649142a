"""The reference's training API in the port: the engine's
``forward`` / ``backward`` / ``step`` trio, ``eval_batch``, the helper
methods and the package's API helpers, against the JAX package on
gpt2-tiny (numpy seeds, the JAX engine on a one-device mesh with dense
attention and ``fused_kernels=False``).

- The trio at gas 2 against the JAX trio, dropout 0, fused AdamW with
  WarmupLR and clipping, at ZeRO stages 0 and 2, 5 steps: losses within
  1e-5 relative, params within 1e-5 (fp32); the bf16 trio refreshes the
  cast copy (equal to the masters' cast, as
  ``tests/test_engine.py::TestCastParamsCache`` asks of JAX).
- Within the port, at dropout 0.1: the trio bit-equal to
  ``train_batch`` on the same rows (losses, params, moments), under
  fused AdamW and under Lamb, and under ``remat_policy: full``.
- Boundary gating as ``tests/test_engine.py::TestCompatibilityTrio``;
  ``forward`` twice, ``backward`` first, ``backward`` of another loss,
  ``step`` after a lone ``forward`` and ``train_batch`` inside a window
  raise; the trio under ZeRO-Offload raises (the JAX trio fails there:
  its apply reads a device optimizer state offload does not keep).
- ``eval_batch`` against JAX's on the same params (fp32, 1e-5
  relative; bf16 1e-2) after 2 training steps, counters untouched;
  with dropout its seeds: an int repeats, the default draws anew.
- ``get_lr``, ``is_gradient_accumulation_boundary``,
  ``zero_optimization`` against the JAX engine's; ``initialize``
  returns the engine's optimizer; ``add_config_arguments`` and
  ``lr_schedules.add_tuning_arguments`` parse what JAX's parse;
  ``DeepSpeedConfig`` and ``lr_schedules`` are exported.
"""
import argparse

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.ops.fused_update import tree_flatten
from torch_jax_native import jax_native  # noqa: F401 (autouse)

from test_torch_optimizers import (assert_params, engine_batches,
                                   engine_cfgs, engine_ds, jax_engine,
                                   port_engine)

ADAMW = {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}
LAMB = {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}}
STEPS = 5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread for this module: gpt2-tiny's ops
    are small, and under parallel test workers every worker's intra-op
    team would contend for the cores (the JAX side keeps its own pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params_np():
    return jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0),
                                    engine_cfgs("fp32")[1]))


def trio_steps(eng, batches, micro=2):
    """Each batch as gas trio calls of ``micro`` rows; the losses
    forward returned, per step."""
    out = []
    for b in batches:
        step = []
        for i in range(0, len(b), micro):
            loss = eng.forward(b[i:i + micro])
            eng.backward(loss)
            eng.step()
            step.append(float(loss))
        out.append(step)
    return out


@pytest.mark.parametrize("stage", [0, 2])
def test_trio_matches_jax_trio(stage, params_np):
    ds = dict(engine_ds("fp32", ADAMW), zero_optimization={"stage": stage})
    batches = engine_batches(STEPS)
    jeng = jax_engine("fp32", ds, params_np)
    jl = trio_steps(jeng, batches)
    teng = port_engine("fp32", ds, params_np)
    tl = trio_steps(teng, batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert teng.global_steps == jeng.global_steps == STEPS
    assert teng.micro_steps == jeng.micro_steps == 2 * STEPS
    assert_params("fp32", teng, jeng, 1e-3)


def test_bf16_trio_refreshes_cast_copy(params_np):
    teng = port_engine("bf16", engine_ds("bf16", ADAMW), params_np)
    trio_steps(teng, engine_batches(3))
    for cast, p in zip(tree_flatten(teng.state.cast_params)[0],
                       tree_flatten(teng.state.params)[0]):
        assert torch.equal(cast, p.detach().to(torch.bfloat16))


def _snapshot(eng):
    st = eng.state.opt_state
    bufs = [b.clone() for per in topt.state_buffers(st).values()
            for b in per]
    return [t.detach().clone() for t in tree_flatten(eng.state.params)[0]
            ] + bufs + [st.count.clone()]


@pytest.mark.parametrize("opt, remat", [(ADAMW, "none"), (LAMB, "none"),
                                        (ADAMW, "full")])
def test_trio_bit_equal_to_train_batch_with_dropout(opt, remat, params_np):
    """gas 2, dropout 0.1: the window's generator carries the dropout
    stream from one trio forward to the next as train_batch's
    micro-batches draw it, so every step is the same bits."""
    ds = engine_ds("fp32", opt)
    batches = engine_batches(3)

    def engine():
        return port_engine("fp32", ds, params_np, dropout=0.1, rng=7,
                           model={"remat_policy": remat})
    a, b = engine(), engine()
    for batch in batches:
        la = a.train_batch(batch)
        trio_steps(b, [batch])
        assert torch.equal(la, b.last_metrics["loss"])
        for x, y in zip(_snapshot(a), _snapshot(b)):
            assert torch.equal(x, y)


def test_boundary_gating_and_misuse(params_np):
    eng = port_engine("fp32", engine_ds("fp32", ADAMW), params_np)
    mb = engine_batches(1)[0][:2]
    assert not eng.is_gradient_accumulation_boundary()
    eng(mb)                             # the reference's engine(batch)
    eng.backward(None)
    assert eng.is_gradient_accumulation_boundary()
    eng.step()                          # not at the boundary: a no-op
    assert eng.global_steps == 0 and eng.micro_steps == 1
    loss = eng.forward(mb)
    with pytest.raises(RuntimeError, match="forward\\(\\) twice"):
        eng.forward(mb)
    with pytest.raises(ValueError, match="takes None or the loss"):
        eng.backward(loss * 2)
    with pytest.raises(RuntimeError, match="inside a forward"):
        eng.train_batch(engine_batches(1)[0])
    eng.backward(loss)
    eng.step()
    assert eng.global_steps == 1 and eng.micro_steps == 2
    with pytest.raises(AssertionError, match="before backward"):
        eng.backward()
    with pytest.raises(AssertionError, match="no gradients"):
        eng.step()
    for _ in range(2):
        eng.forward(mb)
        eng.backward()
    eng.forward(mb)           # at the boundary, with a forward pending
    with pytest.raises(RuntimeError, match="has not run"):
        eng.step()


def test_trio_under_offload_raises(params_np):
    ds = dict(engine_ds("fp32", ADAMW),
              zero_optimization={"stage": 2, "cpu_offload": True})
    mb = engine_batches(1)[0][:2]
    jeng = jax_engine("fp32", ds, params_np)
    # The JAX trio's apply reads state.opt_state, which offload leaves
    # empty: it fails rather than running the host step.
    with pytest.raises(TypeError):
        jeng.forward(mb)
        jeng.backward()
        jeng.forward(mb)
        jeng.backward()
        jeng.step()
    teng = port_engine("fp32", ds, params_np)
    with pytest.raises(NotImplementedError, match="trio under offload"):
        teng.forward(mb)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_eval_batch_matches_jax(precision, params_np):
    ds = engine_ds(precision, ADAMW)
    batches = engine_batches(3)
    jeng = jax_engine(precision, ds, params_np)
    teng = port_engine(precision, ds, params_np)
    for b in batches[:2]:
        jeng.train_batch(b)
        teng.train_batch(b)
    rtol = 1e-5 if precision == "fp32" else 1e-2
    j = float(jeng.eval_batch(batches[2]))
    t = float(teng.eval_batch(batches[2]))
    np.testing.assert_allclose(t, j, rtol=rtol)
    assert teng.global_steps == jeng.global_steps == 2
    assert teng.micro_steps == 4 and int(teng.state.step) == 2


def test_eval_batch_seeds(params_np):
    eng = port_engine("fp32", engine_ds("fp32", ADAMW), params_np,
                      dropout=0.1)
    b = engine_batches(1)[0]
    before = [t.detach().clone() for t in tree_flatten(eng.state.params)[0]]
    one, again = eng.eval_batch(b, rng=5), eng.eval_batch(b, rng=5)
    gen = torch.Generator().manual_seed(5)
    assert torch.equal(one, again)
    assert torch.equal(one, eng.eval_batch(b, rng=gen))
    d1, d2 = eng.eval_batch(b), eng.eval_batch(b)
    assert not torch.equal(d1, d2)
    for x, y in zip(before, tree_flatten(eng.state.params)[0]):
        assert torch.equal(x, y)


def test_helper_methods_match_jax(params_np):
    ds = dict(engine_ds("fp32", ADAMW), zero_optimization={"stage": 1})
    jeng = jax_engine("fp32", ds, params_np)
    teng, topt_out, _, sched = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(engine_cfgs("fp32")[0]),
        model_params=convert.from_jax_params(params_np), config=ds,
        device="cpu")
    assert topt_out is teng.optimizer and isinstance(topt_out,
                                                     topt.FusedAdam)
    assert sched is teng.lr_scheduler
    b = engine_batches(2)
    for k in range(2):
        assert teng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-7)
        assert teng.zero_optimization() == jeng.zero_optimization()
        for mb in (b[k][:2], b[k][2:]):
            assert teng.is_gradient_accumulation_boundary() == \
                jeng.is_gradient_accumulation_boundary()
            for e in (teng, jeng):
                e.backward(e.forward(mb))
                e.step()


@pytest.mark.parametrize("argv", [
    [], ["--deepspeed"], ["--deepspeed", "--deepspeed_config", "ds.json"],
    ["--deepscale", "--deepscale_config", "old.json", "--deepspeed_mpi"]])
def test_add_config_arguments_matches_jax(argv):
    j = deepspeed_tpu.add_config_arguments(argparse.ArgumentParser())
    t = deepspeed_tpu_torch.add_config_arguments(argparse.ArgumentParser())
    assert vars(t.parse_args(argv)) == vars(j.parse_args(argv))


@pytest.mark.parametrize("argv", [
    [], ["--lr_schedule", "OneCycle", "--cycle_max_lr", "0.3",
         "--cycle_first_step_size", "7"],
    ["--lr_schedule", "WarmupLR", "--warmup_num_steps", "12",
     "--warmup_type", "linear", "--warmup_max_lr", "2e-3"]])
def test_add_tuning_arguments_matches_jax(argv):
    j = jlr.add_tuning_arguments(argparse.ArgumentParser())
    t = deepspeed_tpu_torch.lr_schedules.add_tuning_arguments(
        argparse.ArgumentParser())
    assert vars(t.parse_args(argv)) == vars(j.parse_args(argv))


def test_package_exports():
    for name in ("add_config_arguments", "DeepSpeedConfig", "lr_schedules",
                 "initialize", "init_distributed"):
        assert name in deepspeed_tpu_torch.__all__
        assert hasattr(deepspeed_tpu_torch, name)
    cfg = deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 8},
                                              world_size=1)
    assert cfg.train_batch_size == 8 and not cfg.elasticity_enabled
