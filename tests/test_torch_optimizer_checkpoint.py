"""Checkpoints of every optimizer of the port's matrix in the JAX layout,
in both directions, on gpt2-tiny (the JAX engine on a one-device mesh,
dense attention, ``fused_kernels=False``; gas 2, clipping, WarmupLR).

The optimizer file of an optax chain is the JAX engine's: the leaves of
its optax state (``tree_leaves``: counts, then each per-parameter
buffer leaf by leaf in tree order, ``EmptyState`` contributing none)
keyed ``"0"``, ``"1"``, ... beside ``__scalars__``. For each optimizer:

- the port's file at step 2 holds the keys, shapes and dtypes of the
  JAX engine's file at step 2 from the same start, its counts and
  scalars equal, and its buffers within ``FILE_RTOL`` of each leaf's
  largest magnitude (fp32 1e-5, fp16 1e-3; bf16 through the resume);
- JAX save → port resume: 3 more steps, losses within 1e-5 relative
  of the JAX engine that kept going, params as ``assert_params``;
- port save → JAX resume: the same against the port engine that kept
  going.

Lamb also in fp16 (from 2^20: skipped steps before the save; equal
scales and skips after, losses 1e-3) and bf16 with fp32 masters (1e-2).
A ``torch.optim`` optimizer (the name fall-through) raises on a save, and
on a load that asks for the optimizer state.
"""
import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.runtime.flax_msgpack import msgpack_restore

from test_torch_optimizers import (ENGINE_OPTIMIZERS, assert_histories,
                                   assert_params, engine_batches,
                                   engine_cfgs, engine_ds, jax_engine,
                                   jax_history, port_engine, port_history)

SAVE_AT, AFTER = 2, 3
CASES = [(name, "fp32") for name in sorted(ENGINE_OPTIMIZERS)] + \
    [("sgd", "fp32"), ("lamb", "fp16"), ("lamb", "bf16")]
OPTIMIZERS = dict(ENGINE_OPTIMIZERS,
                  sgd={"type": "SGD", "params": {"lr": 1e-2}})
OPTIM_FILE = "zero_pp_rank_0_mp_rank_00_optim_states.msgpack"
# A saved buffer against JAX's, relative to the leaf's largest magnitude:
# the training tolerances. bf16's buffers are held through the resume
# alone: they come from bf16 grads that the two programs round at
# different points (2.1e-2 of a leaf's largest second moment measured on
# Lamb after two steps).
FILE_RTOL = {"fp32": 1e-5, "fp16": 1e-3}


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
    from deepspeed_tpu.models import gpt2 as jgpt2
    return jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0),
                                    engine_cfgs("fp32")[1]))


def _optim_blob(path):
    with open(path / "global_step2" / OPTIM_FILE, "rb") as f:
        return msgpack_restore(f.read())


def _as_np(x):
    return x.float().numpy() if hasattr(x, "float") and \
        not isinstance(x, np.ndarray) else np.asarray(x)


@pytest.mark.parametrize("name, precision", CASES)
def test_checkpoint_both_ways(name, precision, params_np, tmp_path):
    opt = OPTIMIZERS[name]
    ds = engine_ds(precision, opt)
    batches = engine_batches(SAVE_AT + AFTER)
    head, tail = batches[:SAVE_AT], batches[SAVE_AT:]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"

    jeng = jax_engine(precision, ds, params_np)
    jax_history(jeng, head)
    jeng.save_checkpoint(str(jdir))
    teng = port_engine(precision, ds, params_np)
    port_history(teng, head)
    teng.save_checkpoint(str(tdir))

    # The files: JAX's leaves, shapes, dtypes; values close.
    jb, tb = _optim_blob(jdir), _optim_blob(tdir)
    assert sorted(jb) == sorted(tb), (sorted(jb), sorted(tb))
    for key in jb:
        if key == "__scalars__":
            assert {k: int(np.asarray(v).view(np.int32)) for k, v in
                    jb[key].items()} == \
                {k: int(np.asarray(v).view(np.int32)) for k, v in
                 tb[key].items()}
            continue
        a, b = _as_np(jb[key]), _as_np(tb[key])
        assert a.shape == b.shape and str(jb[key].dtype) == \
            str(tb[key].dtype), (key, a.shape, b.shape)
        if a.dtype.kind == "i":
            assert np.array_equal(a, b), key
        elif precision in FILE_RTOL:
            scale = max(float(np.abs(a).max()), 1e-30)
            rtol = FILE_RTOL[precision]
            assert np.abs(a - b).max() <= rtol * scale, \
                (key, np.abs(a - b).max(), scale)

    # JAX save → port resume, port save → JAX resume.
    tres = port_engine(precision, ds, params_np)
    assert tres.load_checkpoint(str(jdir))[0] is not None
    jres = jax_engine(precision, ds, params_np)
    assert jres.load_checkpoint(str(tdir))[0] is not None
    jh, th = jax_history(jeng, tail), port_history(teng, tail)
    assert_histories(precision, port_history(tres, tail), jh)
    assert_histories(precision, th, jax_history(jres, tail))
    lr = opt["params"]["lr"]
    assert_params(precision, tres, jeng, lr, sign_flips=name == "lion")
    assert_params(precision, teng, jres, lr, sign_flips=name == "lion")


def test_torch_optim_state_has_no_jax_layout(params_np, tmp_path):
    ds = engine_ds("fp32", {"type": "Adamax", "params": {"lr": 1e-3}})
    eng = port_engine("fp32", ds, params_np)
    eng.train_batch(engine_batches(1)[0])
    with pytest.raises(ValueError, match="JAX checkpoint layout"):
        eng.save_checkpoint(str(tmp_path))
    assert not any(tmp_path.iterdir())
    sd = eng.optimizer.state_dict()
    assert sd["count"] == 1 and sd["optimizer"]["state"]
    # ... which is how it is kept: another engine's takes it back.
    other = port_engine("fp32", ds, params_np)
    other.optimizer.load_state_dict(sd)
    assert other.optimizer.state_dict()["count"] == 1
    assert torch.equal(
        other.optimizer.opt.state_dict()["state"][0]["exp_avg"],
        sd["optimizer"]["state"][0]["exp_avg"])
    jds = engine_ds("fp32", OPTIMIZERS["lamb"])
    jeng = jax_engine("fp32", jds, params_np)
    jeng.save_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="load_optimizer_states=False"):
        eng.load_checkpoint(str(tmp_path))
    assert eng.load_checkpoint(str(tmp_path),
                               load_optimizer_states=False)[0] is not None
    assert eng.global_steps == 0
