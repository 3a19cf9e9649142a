"""The port's optimizer matrix and training API across processes, against
the JAX engine on an N-device CPU mesh (the harness of
tests/test_torch_dp.py: gpt2-tiny, N gloo processes of
tests/torch_dp_worker.py, gas 2, micro 2 a rank, clipping, WarmupLR).

- ZeRO stage 2 at dp 2 and dp 4 under Lamb and under SGD with momentum,
  3 steps, fp32, dropout 0: losses within 1e-5 relative and params
  within 1e-5 of JAX on the same mesh size (Lamb's per-leaf norms are
  summed over the ranks' rows: a rank-local norm would diverge), and of
  the port's own dp 1 on the same global batch; every rank holds the
  same params.
- Lamb checkpoints at dp 2, stage 2: the port's save after step 1 (rank
  0 writes the whole leaves) resumes in a JAX dp 2 engine, and a JAX dp
  2 save resumes in the port at dp 2; 2 more steps each, losses within
  1e-5 and params within 1e-5 of the run that kept going.
- The trio at dropout 0.1 bit-equal to ``train_batch`` (every step's
  params digest, losses, final buffers) at dp 2, stage 2, and at stage 3
  under ``remat_policy: full`` (the saved tensors' re-gathers outlive
  ``forward`` into ``backward``).
"""
import os

import jax
import numpy as np
import pytest

import torch_dp_worker as W
from test_torch_dp import (jax_engine, jax_flat_params, jax_steps, load,
                           make_batches, params_np, save_params, spawn,
                           wait)

STEPS = 3
SAVE_AFTER = 1
LAMB = {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}}
SGD = {"type": "SGD", "params": {"lr": 1e-2, "momentum": 0.9}}
OPTS = {"lamb": LAMB, "sgd": SGD}


def _opt_ds(opt):
    lr = opt["params"]["lr"]
    return {"optimizer": opt, "scheduler": {"type": "WarmupLR", "params": {
        "warmup_num_steps": 3, "warmup_max_lr": lr}}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("optdp")
    pnp = params_np()
    ppath = str(d / "params.npz")
    save_params(pnp, ppath)
    batches = {w: make_batches(w, 10 + w, STEPS) for w in (2, 4)}
    for w, arr in batches.items():
        np.save(str(d / f"b{w}.npy"), arr)

    # JAX first: its dp 2 Lamb save is a port job's input.
    jres = {}
    jdir = str(d / "jax_lamb_dp2")
    for w in (2, 4):
        for name, opt in OPTS.items():
            eng = jax_engine("fp32", 2, w, pnp, extra=_opt_ds(opt))
            if w == 2 and name == "lamb":
                head = jax_steps(eng, batches[w][:SAVE_AFTER])
                eng.save_checkpoint(jdir)
                tail = jax_steps(eng, batches[w][SAVE_AFTER:])
                rec = {k: np.concatenate([head[k], tail[k]]) for k in head}
            else:
                rec = jax_steps(eng, batches[w])
            rec["params"] = jax_flat_params(eng)
            jres[(w, name)] = rec

    def job(w, name, opt, **kw):
        return dict(dict(name=name, precision="fp32", stage=2,
                         batches=str(d / f"b{w}.npy"), ds=_opt_ds(opt),
                         out=str(d / f"dp{w}_{name}")), **kw)
    tdir = str(d / "port_lamb_dp2")
    adamw = {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}
    dp2 = [job(2, "lamb", LAMB, save={"dir": tdir, "after": SAVE_AFTER}),
           job(2, "sgd", SGD),
           job(2, "lamb_resumed", LAMB, load=jdir, first=SAVE_AFTER),
           job(2, "tb_s2", adamw, dropout=0.1),
           job(2, "trio_s2", adamw, dropout=0.1, trio=True),
           job(2, "tb_s3_full", adamw, dropout=0.1, stage=3, remat="full"),
           job(2, "trio_s3_full", adamw, dropout=0.1, stage=3,
               remat="full", trio=True)]
    dp4 = [job(4, "lamb", LAMB), job(4, "sgd", SGD)]
    dp1 = [dict(job(w, name, opt, micro=W.MICRO * w),
                out=str(d / f"dp1_b{w}_{name}"))
           for w in (2, 4) for name, opt in OPTS.items()]
    procs = [spawn(d, 2, dp2, "dp2", ppath), spawn(d, 4, dp4, "dp4", ppath),
             spawn(d, 1, dp1, "dp1", ppath)]
    for p in procs:
        wait(p)
    port = {}
    for w, jobs in ((2, dp2), (4, dp4)):
        for j in jobs:
            port[(w, j["name"])] = load(j["out"], w)
    for j in dp1:
        port[(1, os.path.basename(j["out"]))] = load(j["out"], 1)

    # The port's dp 2 save resumes in JAX.
    eng = jax_engine("fp32", 2, 2, pnp, extra=_opt_ds(LAMB))
    assert eng.load_checkpoint(tdir)[0] is not None
    rec = jax_steps(eng, batches[2][SAVE_AFTER:])
    rec["params"] = jax_flat_params(eng)
    jres[(2, "lamb_resumed")] = rec
    return port, jres


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["lamb", "sgd"])
def test_stage2_matches_jax(runs, name, world):
    port, jres = runs
    got, want = port[(world, name)][0], jres[(world, name)]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-5)
    one = port[(1, f"dp1_b{world}_{name}")][0]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["params"], one["params"], atol=1e-5)
    for r in port[(world, name)][1:]:
        assert list(r["digest"]) == list(got["digest"])


def test_lamb_checkpoints_both_ways_at_dp2(runs):
    port, jres = runs
    # JAX save (step 1) -> port dp 2 resume, against JAX going on.
    got, want = port[(2, "lamb_resumed")][0], jres[(2, "lamb")]
    np.testing.assert_allclose(got["loss"], want["loss"][SAVE_AFTER:],
                               rtol=1e-5)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-5)
    # port save (step 1) -> JAX dp 2 resume, against the port going on.
    got, want = jres[(2, "lamb_resumed")], port[(2, "lamb")][0]
    np.testing.assert_allclose(got["loss"], want["loss"][SAVE_AFTER:],
                               rtol=1e-5)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-5)


@pytest.mark.parametrize("stage", ["s2", "s3_full"])
def test_trio_bit_equal_to_train_batch_at_dp2(runs, stage):
    port, _ = runs
    for tb, trio in zip(port[(2, f"tb_{stage}")], port[(2, f"trio_{stage}")]):
        assert list(trio["digest"]) == list(tb["digest"])
        np.testing.assert_array_equal(trio["loss"], tb["loss"])
        for k in tb:
            np.testing.assert_array_equal(trio[k], tb[k])
