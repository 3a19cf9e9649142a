"""The two stage-0 train steps that replace the grad all-reduce — 1-bit
Adam and sparse (CSR) embedding gradients — across processes, against
the JAX engine on an N-device CPU mesh (the harness of
tests/test_torch_dp.py: gpt2-tiny, N gloo processes of
tests/torch_dp_worker.py, gas 2, micro 2 a rank, clipping 1.0, WarmupLR,
dropout 0).

- 1-bit Adam (``freeze_step`` 2, AdamW-like lr 1e-3 with decay) at dp 2
  and dp 4, fp32, 3 steps (two in warmup, one compressed): every loss
  within 1e-5 relative of JAX (the third is computed before the
  compressed update); the final params as
  ``test_torch_onebit._assert_compressed_params`` holds them (the
  tolerance plus 1e-5 of each element's update, a sign flip within 2.5
  times it); the ranks' params bit-equal after every step, their worker
  errors different after the freeze; ``comm_bytes`` a step in each
  phase. fp16 at dp 2 (from 2^21: skips, then steps; the 1-bit count
  does not advance on a skip): losses within 1e-3, equal scales and
  skips.
- 1-bit checkpoints at dp 2 both ways: the port's save after step 3
  loads into a JAX dp 2 engine with every buffer bit-equal to the
  ranks' (the worker error rank by rank), and a JAX dp 2 save loads
  into the port at dp 2 with each rank's row.
- Sparse gradients at dp 2 (``wte`` marked; dp 4 on the embedding model
  of tests/test_torch_sparse_grads.py), fp32 and fp16 (from 2^21: the
  overflow skips included): losses and params
  within the training tolerances of JAX's sparse engine, the skips and
  scales equal, ``sparse_comm_stats`` equal to JAX's every step (gpt2's
  head is the tied ``wte``, so every row is shipped); at dp 2
  bit-equal to the port's dense stage-0 path (two terms sum to the same
  bits in either order, and the 1/dp and the loss scale are powers of
  two).
"""
import jax
import numpy as np
import pytest

from test_torch_dp import (jax_engine, jax_flat_params, load, make_batches,
                           params_np, save_params, spawn, wait)

STEPS = 3
FREEZE = 2
LR = 1e-3
ONEBIT = {"optimizer": {"type": "OneBitAdam", "params": {
    "lr": LR, "freeze_step": FREEZE, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_num_steps": 3, "warmup_max_lr": LR}}}
SPARSE = {"sparse_gradients": True}
# (from 2^21 gpt2-tiny skips 4 steps: 3 more take two warmup steps and
# one compressed)
FP16_STEPS = 7


def _jax_run(eng, batches):
    rec = {"loss": [], "loss_scale": [], "skipped": [], "sparse": [],
           "dense": []}
    for b in batches:
        rec["loss_scale"].append(float(eng.state.loss_scale))
        rec["loss"].append(float(eng.train_batch(b)))
        rec["skipped"].append(int(eng.state.skipped_steps))
        st = eng.sparse_comm_stats
        rec["sparse"].append(st.get("sparse_elements", -1))
        rec["dense"].append(st.get("dense_elements", -1))
    out = {k: np.asarray(v) for k, v in rec.items()}
    out["params"] = jax_flat_params(eng)
    return out


def _jax_onebit(eng):
    st = jax.device_get(eng.state.opt_state)
    return {name: [np.asarray(x) for x in
                   jax.tree_util.tree_leaves(getattr(st, name))]
            for name in ("m", "v", "worker_error", "server_error")}, \
        int(st.step)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("obsp")
    pnp = params_np()
    ppath = str(d / "params.npz")
    save_params(pnp, ppath)
    batches = {w: make_batches(w, 20 + w, FP16_STEPS) for w in (2, 4)}
    for w, arr in batches.items():
        np.save(str(d / f"b{w}.npy"), arr)
    jdir, tdir = str(d / "jax_ob"), str(d / "port_ob")

    # JAX's dp 2 1-bit run first: its save is a port job's input.
    jres = {}
    eng = jax_engine("fp32", 0, 2, pnp, extra=ONEBIT)
    jres[(2, "ob")] = _jax_run(eng, batches[2][:STEPS])
    jres[(2, "ob")]["onebit"] = _jax_onebit(eng)
    eng.save_checkpoint(jdir)
    del eng

    def job(w, name, precision, ds, **kw):
        return dict(dict(name=name, precision=precision, stage=0, ds=ds,
                         batches=str(d / f"b{w}.npy"), steps=STEPS,
                         out=str(d / f"dp{w}_{name}")), **kw)
    dp2 = [job(2, "ob", "fp32", ONEBIT,
               save={"dir": tdir, "after": STEPS}),
           job(2, "ob_fp16", "fp16", ONEBIT, steps=FP16_STEPS),
           job(2, "ob_resumed", "fp32", ONEBIT, load=jdir, first=STEPS,
               steps=0),
           job(2, "sp", "fp32", SPARSE), job(2, "s0", "fp32", {}),
           job(2, "sp_fp16", "fp16", SPARSE, steps=FP16_STEPS)]
    dp4 = [job(4, "ob", "fp32", ONEBIT)]
    procs = [spawn(d, 2, dp2, "dp2", ppath), spawn(d, 4, dp4, "dp4", ppath)]

    for w, name, precision, extra, steps in (
            (4, "ob", "fp32", ONEBIT, STEPS),
            (2, "ob_fp16", "fp16", ONEBIT, FP16_STEPS),
            (2, "sp", "fp32", SPARSE, STEPS),
            (2, "sp_fp16", "fp16", SPARSE, FP16_STEPS)):
        eng = jax_engine(precision, 0, w, pnp, extra=extra)
        jres[(w, name)] = _jax_run(eng, batches[w][:steps])
        if name == "ob":
            jres[(w, name)]["onebit"] = _jax_onebit(eng)
    for p in procs:
        wait(p)
    port = {(w, j["name"]): load(j["out"], w)
            for w, jobs in ((2, dp2), (4, dp4)) for j in jobs}

    # The port's dp 2 save loads into JAX.
    eng = jax_engine("fp32", 0, 2, pnp, extra=ONEBIT)
    assert eng.load_checkpoint(tdir)[0] is not None
    jres[(2, "ob_resumed_from_port")] = _jax_onebit(eng)
    return port, jres


def _leaves_of(flat_buf, shapes):
    out, off = [], 0
    for s in shapes:
        n = int(np.prod(s))
        out.append(flat_buf[off:off + n].reshape(s))
        off += n
    return out


def _shapes():
    return [np.shape(x) for x in jax.tree_util.tree_leaves(params_np())]


@pytest.mark.parametrize("world", [2, 4])
def test_onebit_matches_jax(runs, world):
    port, jres = runs
    ranks, want = port[(world, "ob")], jres[(world, "ob")]
    np.testing.assert_allclose(ranks[0]["loss"], want["loss"], rtol=1e-5)
    for r in ranks[1:]:
        assert list(r["digest"]) == list(ranks[0]["digest"])
    # after the freeze each rank's worker error is its own
    assert not np.array_equal(ranks[0]["worker_error0"],
                              ranks[1]["worker_error0"])
    assert np.abs(ranks[0]["worker_error0"]).max() > 0
    # comm_bytes: fp32 words in warmup, signs and scales after
    n = ranks[0]["params"].size
    cb = list(ranks[0]["comm_bytes"])
    assert cb[:FREEZE] == [4 * n] * FREEZE and cb[FREEZE] < n // 4, cb
    # the params: the tolerance plus the compressed update's share
    leaves, _ = want["onebit"]
    shapes = _shapes()
    got = _leaves_of(ranks[0]["params"], shapes)
    exp = _leaves_of(want["params"], shapes)
    flips = total = 0
    for i, (a, b, v, m) in enumerate(zip(got, exp, leaves["v"],
                                         leaves["m"])):
        d = np.abs(a - b)
        u = LR * np.abs(m).max() / (np.sqrt(v) + 1e-8)
        assert (d <= 2.5 * u + 1e-5).all(), (i, d.max())
        bad = d > 1e-5 + 1e-5 * u
        if shapes[i] == (2, 384):              # the key bias: noise
            bad[..., 128:256] = False
        flips += int(bad.sum())
        total += d.size
    assert flips <= 1e-3 * total, (flips, total)


def test_onebit_fp16_matches_jax(runs):
    port, jres = runs
    ranks, want = port[(2, "ob_fp16")], jres[(2, "ob_fp16")]
    assert list(ranks[0]["skipped"]) == list(want["skipped"])
    assert list(ranks[0]["loss_scale"]) == list(want["loss_scale"])
    assert want["skipped"][-1] >= 1 and want["skipped"][-1] < FP16_STEPS
    # the losses up to the first compressed step's (a skip does not
    # advance the 1-bit count)
    taken = np.cumsum(np.diff(np.concatenate([[0], want["skipped"]])) == 0)
    assert taken[-1] > FREEZE, taken
    upto = int(np.argmax(taken == FREEZE + 1)) + 1
    np.testing.assert_allclose(ranks[0]["loss"][:upto], want["loss"][:upto],
                               rtol=1e-3)
    for r in ranks[1:]:
        assert list(r["digest"]) == list(ranks[0]["digest"])


def test_onebit_checkpoints_both_ways_at_dp2(runs):
    port, jres = runs
    # port save -> JAX: every buffer the ranks held, bit for bit
    loaded, step = jres[(2, "ob_resumed_from_port")]
    ranks = port[(2, "ob")]
    assert step == int(ranks[0]["count"]) == STEPS
    shapes = _shapes()
    for name in ("m", "v", "server_error"):
        want = np.concatenate([x.reshape(-1) for x in loaded[name]])
        np.testing.assert_array_equal(ranks[0][f"{name}0"], want)
    for r, res in enumerate(ranks):
        want = np.concatenate([x[r].reshape(-1)
                               for x in loaded["worker_error"]])
        np.testing.assert_array_equal(res["worker_error0"], want)
    # JAX save -> port at dp 2: each rank its row
    saved, jstep = jres[(2, "ob")]["onebit"]
    for r, res in enumerate(port[(2, "ob_resumed")]):
        assert int(res["count"]) == jstep
        for name in ("m", "v", "server_error"):
            np.testing.assert_array_equal(
                res[f"{name}0"],
                np.concatenate([x.reshape(-1) for x in saved[name]]))
        np.testing.assert_array_equal(
            res["worker_error0"],
            np.concatenate([x[r].reshape(-1)
                            for x in saved["worker_error"]]))
    assert len(shapes) == len(saved["m"])


@pytest.mark.parametrize("world, name", [(2, "sp"), (2, "sp_fp16")])
def test_sparse_matches_jax(runs, world, name):
    port, jres = runs
    ranks, want = port[(world, name)], jres[(world, name)]
    fp16 = name.endswith("fp16")
    tol = 1e-3 if fp16 else 1e-5
    np.testing.assert_allclose(ranks[0]["loss"], want["loss"], rtol=tol)
    np.testing.assert_allclose(ranks[0]["params"], want["params"], atol=tol)
    assert list(ranks[0]["sparse_elements"]) == list(want["sparse"])
    assert list(ranks[0]["dense_elements"]) == list(want["dense"])
    # (gpt2's head is the tied wte: every row of its grad is nonzero, so
    # the CSR rows ship more than the dense tensor; the embedding model
    # of tests/test_torch_sparse_grads.py shows the saving)
    assert (want["sparse"] > 0).all()
    for r in ranks[1:]:
        assert list(r["digest"]) == list(ranks[0]["digest"])
    if fp16:
        assert list(ranks[0]["skipped"]) == list(want["skipped"])
        assert list(ranks[0]["loss_scale"]) == list(want["loss_scale"])
        assert want["skipped"][-1] >= 1


def test_sparse_bit_equal_to_dense_stage0_at_dp2(runs):
    port, _ = runs
    for sp, dense in zip(port[(2, "sp")], port[(2, "s0")]):
        assert list(sp["digest"]) == list(dense["digest"])
        np.testing.assert_array_equal(sp["loss"], dense["loss"])
        assert (dense["sparse_elements"] == -1).all()
