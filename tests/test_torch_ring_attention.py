"""The port's ring attention (``ops/ring_attention.py``: sequence
parallelism over the grid's ``seq`` axis) against JAX's
``ring_attention`` on the same mesh.

The port runs gloo worlds of ``tests/torch_dp_worker.py``; the JAX side
runs in this process on ``build_mesh(sp=..., devices=...)``.

- ``ring_attention`` at sp 2 and 4, causal and bidirectional: the
  output within 2e-5 and the grads of ``sum(o * probe)`` within 5e-5 of
  JAX's (JAX's own tolerances); every sequence rank returns the same;
- ``ring_attention_fn`` inside ``apply_blocks`` (2 layers, causal) at
  sp 4, against JAX's ring in its ``apply_blocks`` (2e-4, JAX's);
- gpt2-tiny (fp32, dropout 0) trained 3 steps at sp 2 x dp 2 through
  ``gpt2_loss_fn(cfg, attention_fn=ring_attention_fn(mesh))``, against
  JAX's engine with its ``ring_attention_fn`` on the same mesh: losses
  within 1e-5 relative and params within 1e-5; the sequence ranks' params
  bit-equal.
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
from deepspeed_tpu.models.transformer import (TransformerConfig,
                                              apply_blocks,
                                              init_block_params)
from deepspeed_tpu.ops.ring_attention import ring_attention, ring_attention_fn
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


def inputs():
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q, k, v = (jax.random.normal(key, (2, 32, 2, 16), jnp.float32) * 0.4
               for key in ks)
    probe = jax.random.normal(jax.random.PRNGKey(9), q.shape) * 0.1
    cfg = TransformerConfig(hidden_size=32, num_heads=2, num_layers=2,
                            max_seq_length=32, hidden_dropout=0.0,
                            attn_dropout=0.0, causal=True)
    blocks = init_block_params(jax.random.PRNGKey(0), cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 32, 32), jnp.float32)
    return dict(q=q, k=k, v=v, probe=probe, x=x, blocks=blocks), cfg


def jax_ring(z, cfg, sp):
    mesh = build_mesh(sp=sp, devices=jax.devices()[:sp * 2])
    out = {}
    for causal in (0, 1):
        def loss(q, k, v):
            o = ring_attention(q, k, v, mesh, causal=bool(causal))
            return jnp.sum(o * z["probe"]), o
        (_, o), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(z["q"], z["k"], z["v"])
        out[f"o{causal}"] = np.asarray(o)
        for n, gi in zip("qkv", g):
            out[f"d{n}{causal}"] = np.asarray(gi)
    if sp == 4:
        out["y"] = np.asarray(jax.jit(lambda p, x: apply_blocks(
            p, x, cfg, deterministic=True,
            attention_fn=ring_attention_fn(mesh)))(z["blocks"], z["x"]))
    return out


def jax_train(params, batches, sp=2, dp=2):
    cfg = dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"],
                              dtype=jnp.float32, fused_kernels=False,
                              hidden_dropout=0.0, attn_dropout=0.0)
    mesh = build_mesh(sp=sp, devices=jax.devices()[:sp * dp])
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(cfg, attention_fn=ring_attention_fn(mesh)),
        model_params=jax.tree_util.tree_map(jnp.asarray, params),
        config=W.ds_config("fp32", dp, 1, extra={
            "mesh": {"sequence_parallel_size": sp}}),
        mesh=mesh)
    losses = [float(eng.train_batch(b)) for b in batches]
    flat = np.concatenate([
        np.asarray(x, np.float32).reshape(-1)
        for x in jax.tree_util.tree_leaves(jax.device_get(eng.state.params))])
    return np.asarray(losses), flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ring"))
    z, cfg = inputs()
    zp = os.path.join(d, "ring.npz")
    save_params(jax.tree_util.tree_map(np.asarray, z), zp)
    params = jax.tree_util.tree_map(np.asarray, jgpt2.gpt2_init(
        jax.random.PRNGKey(0), jgpt2.GPT2_CONFIGS["gpt2-tiny"]))
    pp = os.path.join(d, "p.npz")
    save_params(params, pp)
    batches = np.random.default_rng(5).integers(
        0, 512, (STEPS, W.MICRO * W.GAS * 2, 33)).astype(np.int32)
    np.save(os.path.join(d, "b.npy"), batches)
    worlds = {
        2: [dict(name="ring2", ring=zp, out=os.path.join(d, "ring2"))],
        4: [dict(name="ring4", ring=zp, out=os.path.join(d, "ring4")),
            dict(name="sp2dp2", precision="fp32", stage=1,
                 mesh={"sp": 2}, batches=os.path.join(d, "b.npy"),
                 out=os.path.join(d, "sp2dp2"))],
    }
    procs = [W.spawn_forked(d, w, jobs, f"w{w}", pp)
             for w, jobs in worlds.items()]
    jax_out = {sp: jax_ring(z, cfg, sp) for sp in (2, 4)}
    jax_out["train"] = jax_train(params, batches)
    for p in procs:
        wait(p)
    port = {j["name"]: load(os.path.join(d, j["name"]), w)
            for w, jobs in worlds.items() for j in jobs}
    return port, jax_out


@pytest.mark.parametrize("causal", [0, 1])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_matches_jax_ring(runs, sp, causal):
    port, jax_out = runs
    want = jax_out[sp]
    for r in port[f"ring{sp}"]:
        np.testing.assert_allclose(r[f"o{causal}"], want[f"o{causal}"],
                                   rtol=2e-5, atol=2e-5)
        for n in "qkv":
            np.testing.assert_allclose(r[f"d{n}{causal}"],
                                       want[f"d{n}{causal}"],
                                       rtol=5e-5, atol=5e-5, err_msg=f"d{n}")


def test_ring_in_apply_blocks_matches_jax(runs):
    port, jax_out = runs
    for r in port["ring4"]:
        np.testing.assert_allclose(r["y"], jax_out[4]["y"], rtol=2e-4,
                                   atol=2e-4)


def test_gpt2_trains_at_sp2_dp2_as_jax(runs):
    port, jax_out = runs
    losses, params = jax_out["train"]
    rs = port["sp2dp2"]
    for r in rs:
        np.testing.assert_array_equal(r["loss"], rs[0]["loss"])
        np.testing.assert_array_equal(r["params"], rs[0]["params"])
    np.testing.assert_allclose(rs[0]["loss"], losses, rtol=1e-5)
    np.testing.assert_allclose(rs[0]["params"], params, atol=1e-5)
