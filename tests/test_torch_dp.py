"""The port's data-parallel training (ZeRO stages 0-3 over
``torch.distributed``) against the JAX engine on an N-device CPU mesh,
on gpt2-tiny.

The port runs as N gloo processes (``tests/torch_dp_worker.py``, which
imports no JAX) on a ``FileStore`` under the test's tmp dir; the JAX
engine runs in this process on ``jax.devices()[:N]`` with dense
attention and ``fused_kernels=False``. Both start from the same
parameters (JAX's ``gpt2_init``), train 5 steps (gas 2, micro 2 a rank,
dropout 0, AdamW with clipping and WarmupLR) on the same numpy batches,
each rank taking its rows as the JAX engine shards the global batch.

- dp 2 at stages 0, 1, 2 (and 2 with ``reduce_scatter: false``) and 3,
  fp32: losses within 1e-5 relative and the final params within 1e-5
  absolute of JAX (tests/test_torch_training.py's fp32 tolerances);
- port only: stage 3 is bit-identical to stage 2 at dp 2 (fp32 and
  bf16) after one step, after three and after five — params (digests
  each step), losses and moments; dp 2 matches the port's dp 1 on the
  same global batch within 1e-5; every rank holds the same params bit
  for bit after every step of every run; ranks handed different initial
  parameters train bit for bit as if each had rank 0's (the engine
  broadcasts them).

dp 4, fp16, bf16 and master-free are in tests/test_torch_dp_precision.py
(the harness below serves both files and tests/test_torch_dp_checkpoint.py).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.parallel.topology import build_mesh

import torch_dp_worker as W

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 5
JDTYPES = {"fp32": jnp.float32, "fp16": jnp.float16, "bf16": jnp.bfloat16,
           "master_free": jnp.bfloat16}


# --------------------------------------------------------------------- #
# Shared harness (tests/test_torch_dp_precision.py and
# tests/test_torch_dp_checkpoint.py import it)
# --------------------------------------------------------------------- #
def params_np(seed=0):
    jcfg = dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"],
                               dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(seed), jcfg))


def save_params(tree, path):
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}/")
        else:
            flat[prefix[:-1]] = np.asarray(node)
    walk(tree, "")
    np.savez(path, **flat)


def make_batches(world, seed, steps=STEPS):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (steps, W.MICRO * W.GAS * world, 33)) \
        .astype(np.int32)


def spawn(d, world, jobs, tag, params_path):
    """Start ``world`` worker processes on one FileStore; returns them
    (``wait`` collects them)."""
    store = os.path.join(str(d), f"store_{tag}")
    spec = os.path.join(str(d), f"spec_{tag}.json")
    with open(spec, "w") as f:
        json.dump(dict(world=world, store=store, params=params_path,
                       jobs=jobs), f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dp_worker.py"), spec,
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env) for r in range(world)]


def wait(procs, timeout=300):
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append((p.returncode, out.decode(errors="replace")))
    bad = [o for rc, o in outs if rc != 0]
    assert not bad, bad[0][-4000:]


def load(prefix, world):
    return [dict(np.load(f"{prefix}.rank{r}.npz")) for r in range(world)]


def jax_engine(precision, stage, world, params, zero=None, extra=None,
               micro=W.MICRO):
    jcfg = dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"],
                               dtype=JDTYPES[precision],
                               fused_kernels=False, hidden_dropout=0.0,
                               attn_dropout=0.0)
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params),
        config=W.ds_config(precision, world, stage, zero, extra, micro),
        mesh=build_mesh(devices=jax.devices()[:world]))
    return eng


def jax_steps(eng, batches):
    """Per step: the loss, the loss scale the step used, the skipped
    count after it."""
    rec = {"loss": [], "loss_scale": [], "skipped": []}
    for b in batches:
        rec["loss_scale"].append(float(eng.state.loss_scale))
        rec["loss"].append(float(eng.train_batch(b)))
        rec["skipped"].append(int(eng.state.skipped_steps))
    return {k: np.asarray(v) for k, v in rec.items()}


def jax_flat_params(eng):
    return np.concatenate([
        np.asarray(x, np.float32).reshape(-1)
        for x in jax.tree_util.tree_leaves(jax.device_get(eng.state.params))])


# --------------------------------------------------------------------- #
# The runs
# --------------------------------------------------------------------- #
CASES = {  # name: (precision, stage, extra zero keys)
    "s0": ("fp32", 0, None), "s1": ("fp32", 1, None),
    "s2": ("fp32", 2, None), "s3": ("fp32", 3, None),
    "s2_allreduce": ("fp32", 2, {"reduce_scatter": False}),
    "s2_perturbed": ("fp32", 2, None),
    "fp16_s2": ("fp16", 2, None), "bf16_s2": ("bf16", 2, None),
    "bf16_s3": ("bf16", 3, None), "mf_s2": ("master_free", 2, None),
}


def run_cases(d, port_runs, jax_runs):
    """The port's runs (``{world: [case names]}``; world 1 runs the fp32
    recipe with micro 2 * N on the batches of each N in ``port_runs``)
    as one gloo process group a world, all at once, while the JAX
    engine takes ``jax_runs`` (``[(world, name)]``) in this process.
    Returns ``(port, jax)``: ``port[(world, name)]`` a list of the
    ranks' results, ``port[(1, N)]`` the dp 1 run on dp N's batches."""
    pnp = params_np()
    ppath = str(d / "params.npz")
    save_params(pnp, ppath)
    worlds = [w for w in port_runs if w > 1]
    batches = {w: make_batches(w, w - 1) for w in worlds}
    for w, arr in batches.items():
        np.save(str(d / f"b{w}.npy"), arr)

    def job(world, name, micro=W.MICRO, out=None):
        pr, st, z = CASES[name]
        return dict(name=name, precision=pr, stage=st, zero=z, micro=micro,
                    perturb=name.endswith("_perturbed"),
                    batches=str(d / f"b{world}.npy"),
                    out=out or str(d / f"dp{world}_{name}"))
    procs = [spawn(d, w, [job(w, n) for n in port_runs[w]], f"dp{w}",
                   ppath) for w in worlds]
    if 1 in port_runs:
        procs.append(spawn(d, 1, [job(w, "s0", W.MICRO * w,
                                      str(d / f"dp1_b{w}"))
                                  for w in port_runs[1]], "dp1", ppath))
    jres = {}
    for world, name in jax_runs:
        pr, st, z = CASES[name]
        eng = jax_engine(pr, st, world, pnp, zero=z)
        rec = jax_steps(eng, batches[world])
        rec["params"] = jax_flat_params(eng)
        jres[(world, name)] = rec
    for p in procs:
        wait(p)
    port = {(w, n): load(str(d / f"dp{w}_{n}"), w)
            for w in worlds for n in port_runs[w]}
    port.update({(1, w): load(str(d / f"dp1_b{w}"), 1)
                 for w in port_runs.get(1, [])})
    return port, jres


DP2_PORT = ["s0", "s1", "s2", "s3", "s2_allreduce", "s2_perturbed",
            "bf16_s2", "bf16_s3"]
DP2_JAX = ["s0", "s1", "s2", "s2_allreduce", "s3"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("dp"), {2: DP2_PORT, 1: [2]},
                     [(2, n) for n in DP2_JAX])


@pytest.mark.parametrize("name", DP2_JAX)
def test_dp2_fp32_matches_jax(runs, name):
    port, jres = runs
    got, want = port[(2, name)][0], jres[(2, name)]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-5)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_stage3_is_bit_identical_to_stage2(runs, precision):
    port, _ = runs
    pre = "" if precision == "fp32" else "bf16_"
    for r in range(2):
        s2, s3 = port[(2, pre + "s2")][r], port[(2, pre + "s3")][r]
        # one step, three steps, five steps
        assert s2["digest"][0] == s3["digest"][0]
        assert s2["digest"][2] == s3["digest"][2]
        assert list(s2["digest"]) == list(s3["digest"])
        np.testing.assert_array_equal(s2["loss"], s3["loss"])
        np.testing.assert_array_equal(s2["params"], s3["params"])
        for k in s2:
            if k[0] in "mv" and k[1:].isdigit():
                np.testing.assert_array_equal(s2[k], s3[k])


def check_against_dp1(port, world):
    one = port[(1, world)][0]
    for name in ("s2", "s3"):
        got = port[(world, name)][0]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["params"], one["params"], atol=1e-5)


def test_dp2_matches_port_dp1(runs):
    check_against_dp1(runs[0], 2)


def check_ranks_equal(ranks):
    for r in ranks[1:]:
        assert list(r["digest"]) == list(ranks[0]["digest"])
        np.testing.assert_array_equal(r["params"], ranks[0]["params"])
        np.testing.assert_array_equal(r["loss"], ranks[0]["loss"])


@pytest.mark.parametrize("name", DP2_PORT)
def test_every_rank_holds_the_same_params(runs, name):
    check_ranks_equal(runs[0][(2, name)])


def test_every_rank_starts_from_rank0s_params(runs):
    port, _ = runs
    for got, want in zip(port[(2, "s2_perturbed")], port[(2, "s2")]):
        assert list(got["digest"]) == list(want["digest"])
        np.testing.assert_array_equal(got["params"], want["params"])
