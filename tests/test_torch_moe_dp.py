"""The port's MoE at data-parallel sizes above 1 (ep = 1) against the
JAX engine on an N-device CPU mesh, on gpt2-tiny with 8 experts top-2
at capacity factor 1.25 in both blocks (``tests/test_torch_moe.py``'s
model), fp32.

The port runs as N gloo processes (``tests/torch_dp_worker.py``, job key
``moe``); the JAX engine runs in this process on ``jax.devices()[:N]``.
Both start from JAX's ``gpt2_init`` and train 3 steps on the same numpy
batches (micro 2 a rank, dropout 0, AdamW, clipping, WarmupLR).

- ZeRO stages 0 and 3 at dp 2, stages 1 and 2 at dp 4, each dp at gas 1
  and 2: losses, the ``moe_*`` metrics and the final parameters within
  1e-5 (the expert token counts and drop fractions equal). The JAX
  engine routes over the global token list at stages 0-1 (its GSPMD
  program) and over each device's tokens at stages 2-3 (its explicit
  shard_map grads);
  the port follows it (``moe/layer.py``), so each case holds whichever
  routing JAX runs. Every rank ends with the same parameters, bit for
  bit.
- A dp-2 ZeRO-3 checkpoint resumes at dp 4 (stage 1) and in the JAX
  engine at dp 4; both then train 2 steps to the same losses and
  parameters within 1e-5.
- In one process (two threads as two ranks): the global routing of two
  ranks' token lists equals the routing of their concatenation (outputs,
  drops, counts, aux and z losses as the engine reduces them), at a
  capacity factor that drops tokens and at one that drops none.
- The config: MoE at dp > 1 is no longer in ``unported_features``;
  ``expert_parallel_size`` above 1 still is; the gradient-sync wire
  model prices the expert leaves as JAX's engine does.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.parallel.wire_model import grad_sync_wire_model
from deepspeed_tpu_torch.runtime import config as tconfig

import torch_dp_worker as W
from test_torch_dp import load, save_params, spawn, wait
from test_torch_moe import _cfgs, _jax_params

STEPS = 3
MOE = {"num_experts": 8, "top_k": 2, "capacity_factor": 1.25}
METRICS = ("moe_expert_tokens", "moe_drop_fraction", "moe_aux_loss",
           "moe_z_loss")
# (world, stage, gas): every stage, both routings, each dp at gas 1 and 2
CASES = [(2, 0, 2), (2, 3, 1), (4, 1, 1), (4, 2, 2)]


def _name(world, stage, gas):
    return f"dp{world}_s{stage}_gas{gas}"


def _jax_engine(world, stage, gas, params, zero=None):
    _, jcfg = _cfgs()
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params),
        config=W.ds_config("fp32", world, stage, zero, {"moe": MOE},
                           gas=gas),
        mesh=build_mesh(devices=jax.devices()[:world]))
    metrics = []
    record = eng._record_telemetry

    def capture(m, *args):
        metrics.append(jax.device_get(m))
        return record(m, *args)
    eng._record_telemetry = capture
    return eng, metrics


def _jax_run(eng, metrics, batches):
    loss = [float(eng.train_batch(b)) for b in batches]
    rec = {"loss": np.asarray(loss)}
    for k in METRICS:
        rec[k] = np.stack([np.asarray(m[k]) for m in metrics[-len(loss):]])
    rec["params"] = np.concatenate([
        np.asarray(x, np.float32).reshape(-1) for x in
        jax.tree_util.tree_leaves(jax.device_get(eng.state.params))])
    return rec


def _batches(world, gas, seed, steps=STEPS):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (steps, W.MICRO * gas * world, 33)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_dp")
    _, jcfg = _cfgs()
    pnp = _jax_params(jcfg)
    ppath = str(d / "params.npz")
    save_params(pnp, ppath)
    batches = {}
    for world, stage, gas in CASES:
        arr = _batches(world, gas, 10 * world + gas)
        batches[(world, gas)] = arr
        np.save(str(d / f"b{world}_{gas}.npy"), arr)
    resume = _batches(4, 2, 99, steps=2)
    np.save(str(d / "resume.npy"), resume)
    ck = str(d / "ck")

    def job(world, stage, gas):
        return dict(name=_name(world, stage, gas), precision="fp32",
                    stage=stage, gas=gas, moe=MOE,
                    batches=str(d / f"b{world}_{gas}.npy"),
                    out=str(d / _name(world, stage, gas)))
    jobs = {w: [job(*c) for c in CASES if c[0] == w] for w in (2, 4)}
    # the dp-2 save (stage 3, after the last step) resumed at dp 4
    jobs[2][1]["save"] = {"dir": ck, "after": STEPS}
    jobs[4].append(dict(name="resume", precision="fp32", stage=1, gas=2,
                        moe=MOE, batches=str(d / "resume.npy"), load=ck,
                        wait_for=f"{ck}/latest", out=str(d / "resume")))
    procs = [spawn(d, w, jobs[w], f"moe{w}", ppath) for w in (2, 4)]
    jres = {}
    for world, stage, gas in CASES:
        eng, metrics = _jax_engine(world, stage, gas, pnp)
        rec = _jax_run(eng, metrics, batches[(world, gas)])
        rec["wire_bytes"] = eng._grad_wire_bytes()[0]
        jres[_name(world, stage, gas)] = rec
        del eng
    for p in procs:
        wait(p, timeout=400)
    port = {_name(*c): load(str(d / _name(*c)), c[0]) for c in CASES}
    port["resume"] = load(str(d / "resume"), 4)
    eng, metrics = _jax_engine(4, 1, 2, pnp)
    assert eng.load_checkpoint(ck)[0] is not None
    jres["resume"] = _jax_run(eng, metrics, resume)
    return port, jres


def _check(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_array_equal(got["moe_expert_tokens"],
                                  want["moe_expert_tokens"])
    np.testing.assert_array_equal(got["moe_drop_fraction"],
                                  want["moe_drop_fraction"])
    for k in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=[_name(*c) for c in CASES])
def test_moe_at_dp_matches_jax(runs, case):
    port, jres = runs
    ranks = port[_name(*case)]
    _check(ranks[0], jres[_name(*case)])
    for r in ranks[1:]:
        assert list(r["digest"]) == list(ranks[0]["digest"])
        np.testing.assert_array_equal(r["params"], ranks[0]["params"])
        for k in ("loss",) + METRICS:
            np.testing.assert_array_equal(r[k], ranks[0][k])


def test_dp2_save_resumes_at_dp4_and_in_jax(runs):
    port, jres = runs
    _check(port["resume"][0], jres["resume"])


# --------------------------------------------------------------------- #
# The global routing in one process
# --------------------------------------------------------------------- #
def _two_rank_routing(params, xs, moe):
    """Each rank's ``_moe_tokens`` over a ``RoutingSpan`` of the ranks,
    two threads meeting in an all-gather."""
    world = len(xs)
    slots, barrier = [None] * world, threading.Barrier(world)
    out = [None] * world

    def gather_for(rank):
        def gather(t):
            slots[rank] = t.clone()
            barrier.wait()
            got = torch.cat(slots)
            barrier.wait()
            return got
        return gather

    def body(rank):
        span = tlayer.RoutingSpan(world, rank, gather_for(rank))
        out[rank] = tlayer._moe_tokens(params, xs[rank], moe, True,
                                       span=span)
    threads = [threading.Thread(target=body, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


@pytest.mark.parametrize("cf", [0.5, 1.25, float("inf")])
def test_global_routing_equals_the_concatenated_tokens(cf):
    torch.manual_seed(0)
    moe = tlayer.MoEConfig(num_experts=8, top_k=2, capacity_factor=cf)
    H, F = 16, 32
    params = {"router_kernel": torch.randn(H, 8),
              "moe_fc_kernel": torch.randn(8, H, F) * 0.1,
              "moe_fc_bias": torch.randn(8, F) * 0.1,
              "moe_out_kernel": torch.randn(8, F, H) * 0.1,
              "moe_out_bias": torch.randn(8, H) * 0.1}
    xs = [torch.randn(24, H) for _ in range(2)]
    whole, st = tlayer._moe_tokens(params, torch.cat(xs), moe, True)
    parts = _two_rank_routing(params, xs, moe)
    got = torch.cat([y for y, _ in parts])
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)
    stats = [s for _, s in parts]
    assert torch.equal(stats[0]["expert_tokens"] + stats[1]["expert_tokens"],
                       st["expert_tokens"])
    for k in ("drop_fraction", "aux_loss", "z_loss"):
        torch.testing.assert_close((stats[0][k] + stats[1][k]) / 2, st[k],
                                   rtol=1e-6, atol=1e-7)
    if cf == 0.5:
        assert float(st["drop_fraction"]) > 0.2


# --------------------------------------------------------------------- #
# The config and the wire
# --------------------------------------------------------------------- #
def test_moe_at_dp_is_ported_and_ep_still_raises():
    base = W.ds_config("fp32", 2, 2, extra={"moe": MOE})
    names = [n for n, _ in tconfig.DeepSpeedConfig(
        base, world_size=2).unported_features()]
    assert not any("MoE" in n for n in names)
    ep = W.ds_config("fp32", 2, 2, extra={"moe": dict(
        MOE, expert_parallel_size=2)})
    names = [n for n, _ in tconfig.DeepSpeedConfig(
        ep, world_size=2).unported_features()]
    assert "moe.expert_parallel_size > 1" in names


@pytest.mark.parametrize("case", [(4, 1, 1), (4, 2, 2)],
                         ids=["dp4_s1", "dp4_s2"])
def test_wire_model_prices_the_expert_leaves_as_jax(runs, case):
    world, stage, _ = case
    shapes = [np.shape(x) for x in jax.tree_util.tree_leaves(
        _jax_params(_cfgs()[1]))]
    model = grad_sync_wire_model(shapes, world)
    key = "all_reduce_wire_bytes" if stage < 2 else \
        "reduce_scatter_wire_bytes"
    assert any(len(s) == 4 for s in shapes)        # [n_moe, E, H, F]
    assert runs[1][_name(*case)]["wire_bytes"] == model[key]
