"""A client ``torch.optim`` optimizer at ZeRO stages 1-3 across ranks
(``ops/optimizers.TorchOptimizer`` over a rank's ``ShardGroup`` rows,
one tensor a leaf slice), on gpt2-tiny over gloo
(``tests/torch_dp_worker.py``), 3 fp32 steps with clipping and the dp
tests' WarmupLR (the client optimizer's learning rate, as JAX hands its
schedule to a ``callable(schedule_fn)`` client).

- AdamW, SGD with momentum and Adagrad at dp 2 and dp 4, stages 1, 2
  and 3 (8 rows a micro-step at every dp): losses within 1e-5 relative
  and the final parameters within 1e-5 of the same optimizer at dp 1 on
  the same global batch, and of
  the JAX engine with the optax counterpart as its client optimizer on
  a mesh of the same dp (``optax.adamw``, ``optax.sgd(momentum=0.9)``,
  ``optax.adagrad`` with the same accumulator start and eps); every
  rank holds the same parameters.
- The classes whose step is not elementwise (Adafactor, LBFGS,
  SparseAdam, Muon) raise at ZeRO 1-3, naming why; the elementwise
  ones build over a rank's rows.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.parallel.topology import build_mesh

import torch_dp_worker as W
from deepspeed_tpu_torch.ops import fused_update as tfu
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime.zero import partition as tpart
from test_torch_dp import load, params_np, save_params, wait

STEPS, ROWS = 3, 8
OPTIMS = {
    "adamw": (("AdamW", {"weight_decay": 0.01}),
              lambda lr: optax.adamw(lr, weight_decay=0.01)),
    "sgd": (("SGD", {"momentum": 0.9}),
            lambda lr: optax.sgd(lr, momentum=0.9)),
    "adagrad": (("Adagrad", {"initial_accumulator_value": 0.1,
                             "eps": 0.0}),
                lambda lr: optax.adagrad(lr, initial_accumulator_value=0.1,
                                         eps=0.0)),
}
CASES = [(o, dp, s) for o in OPTIMS for dp in (2, 4) for s in (1, 2, 3)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's torch ops on one thread: gpt2-tiny's ops are small,
    and under parallel test workers an intra-op team waits for cores the
    other workers' processes hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _name(o, dp, s):
    return f"{o}_dp{dp}_s{s}"


def jax_run(opt, dp, batches, params):
    cfg = dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"],
                              dtype=jnp.float32, fused_kernels=False,
                              hidden_dropout=0.0, attn_dropout=0.0)
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(cfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params),
        optimizer=OPTIMS[opt][1],
        config=W.ds_config("fp32", dp, 1, micro=ROWS // dp),
        mesh=build_mesh(devices=jax.devices()[:dp]))
    losses = [float(eng.train_batch(b)) for b in batches]
    flat = np.concatenate([
        np.asarray(x, np.float32).reshape(-1) for x in
        jax.tree_util.tree_leaves(jax.device_get(eng.state.params))])
    return np.asarray(losses), flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("optz"))
    params = params_np()
    pp = os.path.join(d, "p.npz")
    save_params(params, pp)
    # One global batch of ROWS rows a micro-step for every dp (micro
    # ROWS / dp a rank), so one dp-1 run per optimizer holds both dps.
    rng = np.random.default_rng(4)
    batches = rng.integers(0, 512, (STEPS, ROWS * W.GAS, 33)) \
        .astype(np.int32)
    np.save(os.path.join(d, "b.npy"), batches)

    def job(opt, world, stage, name):
        cls, kw = OPTIMS[opt][0]
        return dict(name=name, precision="fp32", stage=stage,
                    micro=ROWS // world, torch_optim={"name": cls, "kw": kw},
                    batches=os.path.join(d, "b.npy"),
                    out=os.path.join(d, name))
    procs = [W.spawn_forked(d, dp, [job(o, dp, s, _name(o, dp, s))
                                    for o, p_, s in CASES if p_ == dp],
                            f"w{dp}", pp) for dp in (2, 4)]
    procs.append(W.spawn_forked(d, 1, [job(o, 1, 0, f"{o}_dp1")
                                       for o in OPTIMS], "w1", pp))
    jax_runs = {(o, dp): jax_run(o, dp, batches, params)
                for o in OPTIMS for dp in (2, 4)}
    for p in procs:
        wait(p)
    port = {_name(*c): load(os.path.join(d, _name(*c)), c[1])
            for c in CASES}
    for o in OPTIMS:
        port[f"{o}_dp1"] = load(os.path.join(d, f"{o}_dp1"), 1)
    return port, jax_runs


@pytest.mark.parametrize("opt, dp, stage", CASES,
                         ids=[_name(*c) for c in CASES])
def test_torch_optim_at_zero_matches_dp1(runs, opt, dp, stage):
    port, _ = runs
    r, one = port[_name(opt, dp, stage)], port[f"{opt}_dp1"][0]
    for x in r:
        np.testing.assert_array_equal(x["params"], r[0]["params"])
        np.testing.assert_array_equal(x["loss"], r[0]["loss"])
    np.testing.assert_allclose(r[0]["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(r[0]["params"], one["params"], atol=1e-5)
    assert int(r[0]["count"]) == STEPS


@pytest.mark.parametrize("opt, dp, stage", CASES,
                         ids=[_name(*c) for c in CASES])
def test_torch_optim_at_zero_matches_jax_optax(runs, opt, dp, stage):
    port, jax_runs = runs
    jl, jp = jax_runs[(opt, dp)]
    r = port[_name(opt, dp, stage)][0]
    np.testing.assert_allclose(r["loss"], jl, rtol=1e-5)
    np.testing.assert_allclose(r["params"], jp, atol=1e-5)


@pytest.mark.parametrize("cls, match", [
    ("Adafactor", "rows and columns"), ("LBFGS", "closure"),
    ("SparseAdam", "sparse gradients"), ("Muon", "orthogonalizes")])
def test_shape_dependent_classes_raise_at_zero(cls, match):
    sg = tfu.ShardGroup([(16, 4), (5,)], torch.float32, torch.device("cpu"),
                        tpart.row_plan(2, 1))
    kw = {"lr": 1e-3}
    opt = topt.client_optimizer(
        lambda params: getattr(torch.optim, cls)(params, **kw), None, 1e-3)
    with pytest.raises(NotImplementedError, match=match):
        opt.init([sg])


@pytest.mark.parametrize("cls", sorted(topt.ELEMENTWISE_TORCH_OPTIM))
def test_elementwise_classes_build_over_rows(cls):
    sg = tfu.ShardGroup([(16, 4), (5,)], torch.float32, torch.device("cpu"),
                        tpart.row_plan(4, 3))
    opt = topt.client_optimizer(getattr(torch.optim, cls), None, 1e-3)
    opt.init([sg])
    assert len(opt._leaves) == 2
    assert opt._leaves[0][0].shape == (2, sg.columns[0][1])
