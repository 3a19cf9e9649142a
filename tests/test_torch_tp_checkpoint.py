"""Tensor-parallel checkpoints across the frameworks, and
``partition_activations`` across two model ranks.

The port runs gloo worlds of ``tests/torch_dp_worker.py``; the JAX engine
runs in this process on ``build_mesh(mp=2, devices=jax.devices()[:2])``
with ``gpt2_param_shardings``, gpt2-tiny (fp32, dropout 0, the dp tests'
AdamW with clipping and WarmupLR, gas 2).

- a port save at mp 2 after 2 steps (``mp_rank_00``/``mp_rank_01`` model
  files, each JAX's contiguous slice of the split leaves, ``mp_shards``
  in the meta) resumed by JAX: its third step as the port's
  uninterrupted one (losses 1e-5 relative, params 1e-5);
- JAX's save at mp 2 after 2 steps resumed by the port: its third step
  as JAX's; JAX's tag loaded and saved again by the port gives JAX's
  ``mp_rank_XX`` files byte for byte;
- at mp 2 x dp 2 under ZeRO 1 (the moments split over each column's dp
  ranks) a save after 2 steps resumes in the port as the uninterrupted
  run's third step;
- ``partition_activations`` at mp 2: each rank holds its halves of the
  checkpointed call's residuals (the sequence dim of ``[B, S, H]``, dim
  0 of a matrix), gathers them for the re-run, and its grads equal the
  plain call's bit for bit.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.parallel.topology import build_mesh

import torch_dp_worker as W
from test_torch_dp import load, save_params, wait

STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jflat(eng):
    return np.concatenate([
        np.asarray(x, np.float32).reshape(-1)
        for x in jax.tree_util.tree_leaves(jax.device_get(eng.state.params))])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpck"))
    cfg = dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"],
                              dtype=jnp.float32, fused_kernels=False,
                              hidden_dropout=0.0, attn_dropout=0.0)
    params = jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0), cfg))
    pp = os.path.join(d, "p.npz")
    save_params(params, pp)
    batches = np.random.default_rng(3).integers(
        0, 512, (STEPS, W.MICRO * W.GAS, 33)).astype(np.int32)
    np.save(os.path.join(d, "b.npy"), batches)
    np.save(os.path.join(d, "b2.npy"), np.random.default_rng(4).integers(
        0, 512, (STEPS, 2 * W.MICRO * W.GAS, 33)).astype(np.int32))
    jck, pck, rck, zck = (os.path.join(d, n)
                          for n in ("jck", "pck", "rck", "zck"))
    base = dict(precision="fp32", stage=0, mesh={"mp": 2},
                batches=os.path.join(d, "b.npy"))
    jobs = [dict(base, name="whole", save={"dir": pck, "after": 2},
                 out=os.path.join(d, "whole")),
            dict(name="part", partition=True, out=os.path.join(d, "part")),
            dict(base, name="resume", load=jck, first=2, steps=1,
                 wait_for=os.path.join(jck, "latest"),
                 save={"dir": rck, "after": 0},
                 out=os.path.join(d, "resume"))]
    z1 = dict(base, stage=1, batches=os.path.join(d, "b2.npy"))
    jobs4 = [dict(z1, name="z1whole", save={"dir": zck, "after": 2},
                  out=os.path.join(d, "z1whole")),
             dict(z1, name="z1resume", load=zck, first=2, steps=1,
                  out=os.path.join(d, "z1resume"))]
    procs = W.spawn_forked(d, 2, jobs, "w2", pp) + \
        W.spawn_forked(d, 4, jobs4, "w4", pp)
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(cfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params),
        config=W.ds_config("fp32", 1, 0,
                           extra={"mesh": {"model_parallel_size": 2}}),
        mesh=build_mesh(mp=2, devices=jax.devices()[:2]),
        param_shardings=jgpt2.gpt2_param_shardings(cfg))
    jloss = []
    for k, b in enumerate(batches):
        jloss.append(float(eng.train_batch(b)))
        if k == 1:
            eng.save_checkpoint(jck)
    jparams = jflat(eng)
    wait(procs)
    port = {j["name"]: load(os.path.join(d, j["name"]), 2) for j in jobs}
    port.update({j["name"]: load(os.path.join(d, j["name"]), 4)
                 for j in jobs4})
    # JAX resumes the port's save at step 2 (on the engine of its run)
    eng.load_checkpoint(pck)
    resumed = (float(eng.train_batch(batches[2])), jflat(eng))
    return dict(port=port, jax=(np.asarray(jloss), jparams),
                jax_resumed=resumed,
                dirs=(os.path.join(jck, "global_step2"),
                      os.path.join(rck, "global_step2"),
                      os.path.join(pck, "global_step2")))


def test_port_save_resumes_in_jax(runs):
    whole = runs["port"]["whole"][0]
    loss, params = runs["jax_resumed"]
    np.testing.assert_allclose(loss, whole["loss"][2], rtol=1e-5)
    np.testing.assert_allclose(params, whole["params"], atol=1e-5)
    files = sorted(f for f in os.listdir(runs["dirs"][2])
                   if f.startswith("mp_rank"))
    assert files == ["mp_rank_00_model_states.msgpack",
                     "mp_rank_01_model_states.msgpack"]


def test_jax_save_resumes_in_port(runs):
    jloss, jparams = runs["jax"]
    for r in runs["port"]["resume"]:
        np.testing.assert_allclose(r["loss"], jloss[2:], rtol=1e-5)
        np.testing.assert_allclose(r["params"], jparams, atol=1e-5)


@pytest.mark.parametrize("rank", [0, 1])
def test_mp_rank_files_are_jax_bytes(runs, rank):
    jdir, rdir, _ = runs["dirs"]
    name = f"mp_rank_{rank:02d}_model_states.msgpack"
    with open(os.path.join(jdir, name), "rb") as a, \
            open(os.path.join(rdir, name), "rb") as b:
        assert a.read() == b.read()


def test_zero1_save_resumes_at_mp2_dp2(runs):
    whole = runs["port"]["z1whole"]
    for r, w in zip(runs["port"]["z1resume"], whole):
        np.testing.assert_array_equal(r["loss"], w["loss"][2:])
        np.testing.assert_array_equal(r["params"], w["params"])


def test_partition_activations_at_mp2(runs):
    for r in runs["port"]["part"]:
        np.testing.assert_array_equal(r["remat"], r["plain"])
        assert list(r["held"]) == ["(8, 16)", "(8, 2, 16)"]
