"""Sparse (CSR) embedding gradients in the port (``runtime/csr_tensor.py``
and the engine's sparse step) against the JAX package's, on the
embedding model of JAX ``tests/test_sparse_grads.py`` (VOCAB 512, HID 8:
a mean-pooled lookup regressed onto a learnable target, each batch
touching 8 of the 512 rows).

In this process (dp 1, where both engines take the main path):

- ``CSRTensor`` (``from_dense``, ``to_dense`` with duplicate rows,
  ``sparse_size``, ``dense_size``, ``add``, ``coalesce``) and
  ``all_gather_csr`` give JAX's indices and values bit for bit (fp32,
  duplicates summed in order of appearance);
- the engine marks the leaves JAX marks, by the default predicate and
  by a ``sparse_grad_filter`` that gets the path in ``keystr`` form;
  ZeRO stage 1 and OnebitAdam refuse it (``ValueError``); a config in
  which nothing matches trains densely;
- at dp 1 the sparse config runs the main path: bit-equal to the dense
  engine, ``sparse_comm_stats`` empty, and within 1e-5 of the JAX engine
  on one device.

Across gloo processes (tests/torch_dp_worker.py, ``model: embed``) and
the JAX engine on a 2- and 4-device CPU mesh, Adam lr 1e-2, gas 2: the
cases of the JAX file —

- parity with the dense all-reduce (dp 2: bit-equal; dp 2 and 4: losses
  within 1e-5 and params within 1e-5 of JAX's sparse engine);
- the comm volume: ``sparse_comm_stats`` equal to JAX's every step, and
  under a quarter of the dense elements;
- fp16 (static scale 1024) against the dense fp16 path within JAX's
  tolerances (losses 5e-3 / 5e-4, params 2e-3 / 2e-5) and against JAX
  within 1e-3;
- the fp16 overflow vote (scale 2^32): the step skipped, the params
  untouched, one skip counted on every rank;
- 30 steps converge (the last loss under half the first); a run with
  ``steps_per_print`` 1 logs every step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime import csr_tensor as jcsr
from deepspeed_tpu.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.runtime import csr_tensor as tcsr

import test_sparse_grads as J
import torch_dp_worker as W
from test_torch_dp import spawn, wait, load

ADAM = {"type": "Adam", "params": {"lr": 1e-2}}
N_ROWS = 32
STEPS = 5
CONVERGE = 30


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(world, sparse, **over):
    ds = W.ds_config("fp32", world, 0, micro=N_ROWS // (W.GAS * world),
                     extra={"optimizer": ADAM, "scheduler": None,
                            "gradient_clipping": 0.0,
                            "sparse_gradients": sparse})
    ds.update(over)
    return ds


def _batch_np(i, rows=8):
    b = J.make_batch(i, n=N_ROWS, rows=rows)
    return {"ids": np.asarray(b["ids"]), "y": np.asarray(b["y"])}


def _port_engine(ds, **kw):
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=W.embed_loss, model_params=W.embed_params(), config=ds,
        device="cpu", **kw)
    return eng


def _jax_engine(ds, world=1, **kw):
    return DeepSpeedEngine(model=J.loss_fn, model_params=J.model_params(),
                           config=ds,
                           mesh=build_mesh(devices=jax.devices()[:world]),
                           **kw)


def _flat_port(eng):
    return np.concatenate([t.detach().float().reshape(-1).numpy() for t in
                           (eng.state.params["embedding"],
                            eng.state.params["out_w"])])


def _flat_jax(eng):
    p = jax.device_get(eng.state.params)
    return np.concatenate([np.asarray(p["embedding"]).reshape(-1),
                           np.asarray(p["out_w"]).reshape(-1)])


# --------------------------------------------------------------------- #
# CSRTensor
# --------------------------------------------------------------------- #
def _dense_case(seed):
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal((16, 5)) * (rng.random((16, 1)) < 0.4)) \
        .astype(np.float32)
    return d


def test_csr_tensor_matches_jax():
    a, b = _dense_case(0), _dense_case(1)
    ja, jb = jcsr.CSRTensor.from_dense(a), jcsr.CSRTensor.from_dense(b)
    ta, tb = (tcsr.CSRTensor.from_dense(torch.from_numpy(x))
              for x in (a, b))
    np.testing.assert_array_equal(ta.row_indices.numpy(), ja.row_indices)
    np.testing.assert_array_equal(ta.values.numpy(), ja.values)
    assert ta.sparse_size() == ja.sparse_size()
    assert ta.dense_size == ja.dense_size == 80
    # duplicate rows: add (concatenate), to_dense, coalesce
    j_sum, t_sum = ja.add(jb).add(ja), ta.add(tb).add(ta)
    np.testing.assert_array_equal(t_sum.to_dense().numpy(),
                                  j_sum.to_dense())
    jc, tc = j_sum.coalesce(), t_sum.coalesce()
    np.testing.assert_array_equal(tc.row_indices.numpy(), jc.row_indices)
    np.testing.assert_array_equal(tc.values.numpy(), jc.values)
    # all_gather_csr over three shards, rows summed in shard order
    shards = [_dense_case(s) for s in (2, 3, 4)]
    jg = jcsr.all_gather_csr([jcsr.CSRTensor.from_dense(x) for x in shards])
    tg = tcsr.all_gather_csr([tcsr.CSRTensor.from_dense(torch.from_numpy(x))
                              for x in shards])
    np.testing.assert_array_equal(tg.row_indices.numpy(), jg.row_indices)
    np.testing.assert_array_equal(tg.values.numpy(), jg.values)
    np.testing.assert_array_equal(tg.to_dense().numpy(), jg.to_dense())
    empty = tcsr.CSRTensor.from_dense(torch.zeros(4, 3))
    assert empty.sparse_size() == 0 and not empty.to_dense().any()


# --------------------------------------------------------------------- #
# The engine in this process (dp 1)
# --------------------------------------------------------------------- #
def test_engine_detects_embedding_leaves():
    eng = _port_engine(_cfg(1, True))
    jeng = _jax_engine(_cfg(1, True))
    assert eng._sparse_names == jeng._sparse_names == ["['embedding']"]
    assert len(eng._sparse_idx) == 1


def test_sparse_custom_filter():
    seen = []

    def filt(path, leaf):
        seen.append((path, tuple(leaf.shape)))
        return "out_w" in path
    eng = _port_engine(_cfg(1, True), sparse_grad_filter=filt)
    jeng = _jax_engine(_cfg(1, True),
                       sparse_grad_filter=lambda p, l: "out_w" in p)
    assert eng._sparse_names == jeng._sparse_names == ["['out_w']"]
    assert seen == [("['embedding']", (512, 8)), ("['out_w']", (8, 1))]
    assert np.isfinite(float(eng.train_batch(_batch_np(0))))
    # nothing matched: a warning, and the dense path
    eng = _port_engine(_cfg(1, True), sparse_grad_filter=lambda p, l: False)
    assert eng._sparse_idx == [] and eng._sparse_names == []


def test_sparse_gradients_gates():
    with pytest.raises(ValueError, match="ZeRO stage 0"):
        _port_engine(_cfg(1, True, zero_optimization={"stage": 1}))
    with pytest.raises(ValueError, match="OnebitAdam"):
        _port_engine(_cfg(1, True, optimizer={"type": "OneBitAdam",
                                              "params": {"lr": 1e-3}}))


def test_dp1_takes_the_main_path():
    sp, dn = _port_engine(_cfg(1, True)), _port_engine(_cfg(1, False))
    jeng = _jax_engine(_cfg(1, True))
    for i in range(STEPS):
        b = _batch_np(i)
        ls, ld = float(sp.train_batch(b)), float(dn.train_batch(b))
        assert ls == ld
        np.testing.assert_allclose(ls, float(jeng.train_batch(b)),
                                   rtol=1e-5)
    assert sp.sparse_comm_stats == {} == jeng.sparse_comm_stats
    np.testing.assert_array_equal(_flat_port(sp), _flat_port(dn))
    np.testing.assert_allclose(_flat_port(sp), _flat_jax(jeng), atol=1e-5)


# --------------------------------------------------------------------- #
# Across processes
# --------------------------------------------------------------------- #
def _save_batches(path, n, rows=8):
    bs = [_batch_np(i, rows) for i in range(n)]
    np.savez(path, ids=np.stack([b["ids"] for b in bs]),
             y=np.stack([b["y"] for b in bs]))
    return bs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sparse")
    bpath = str(d / "b.npz")
    batches = _save_batches(bpath, CONVERGE)
    fp16 = {"fp16": {"enabled": True, "loss_scale": 1024}}
    big = {"fp16": {"enabled": True, "loss_scale": 2 ** 32}}

    def job(w, name, sparse, steps=STEPS, precision="fp32", **over):
        ds = {k: v for k, v in _cfg(w, sparse, **over).items()
              if k in ("optimizer", "scheduler", "gradient_clipping",
                       "sparse_gradients", "fp16", "steps_per_print")}
        return dict(name=name, model="embed", precision=precision, stage=0,
                    micro=N_ROWS // (W.GAS * w), ds=ds, batches=bpath,
                    steps=steps, out=str(d / f"dp{w}_{name}"))
    dp2 = [job(2, "sparse", True), job(2, "dense", False),
           job(2, "fp16_sparse", True, **fp16),
           job(2, "fp16_dense", False, **fp16),
           job(2, "overflow", True, steps=1, **big),
           job(2, "converge", True, steps=CONVERGE),
           job(2, "log", True, steps=2, steps_per_print=1)]
    dp4 = [job(4, "sparse", True)]
    # (the worker needs a params file; the embed model brings its own)
    ppath = str(d / "unused.npz")
    np.savez(ppath)
    procs = [spawn(d, 2, dp2, "dp2", ppath), spawn(d, 4, dp4, "dp4", ppath)]
    jres = {}
    for w, name, over in ((2, "sparse", {}), (4, "sparse", {}),
                          (2, "fp16_sparse", fp16)):
        eng = _jax_engine(_cfg(w, True, **over), world=w)
        rec = {"loss": [], "sparse": [], "dense": []}
        for b in batches[:STEPS]:
            rec["loss"].append(float(eng.train_batch(
                {k: jnp.asarray(v) for k, v in b.items()})))
            rec["sparse"].append(eng.sparse_comm_stats["sparse_elements"])
            rec["dense"].append(eng.sparse_comm_stats["dense_elements"])
        rec = {k: np.asarray(v) for k, v in rec.items()}
        rec["params"] = _flat_jax(eng)
        jres[(w, name)] = rec
    for p in procs:
        wait(p)
    port = {(w, j["name"]): load(j["out"], w)
            for w, jobs in ((2, dp2), (4, dp4)) for j in jobs}
    return port, jres


@pytest.mark.parametrize("world", [2, 4])
def test_sparse_matches_jax(runs, world):
    port, jres = runs
    ranks, want = port[(world, "sparse")], jres[(world, "sparse")]
    np.testing.assert_allclose(ranks[0]["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["params"], want["params"],
                               atol=1e-5)
    for r in ranks[1:]:
        assert list(r["digest"]) == list(ranks[0]["digest"])


def test_sparse_parity_with_dense_allreduce(runs):
    port, _ = runs
    for sp, dn in zip(port[(2, "sparse")], port[(2, "dense")]):
        assert list(sp["digest"]) == list(dn["digest"])
        np.testing.assert_array_equal(sp["loss"], dn["loss"])


@pytest.mark.parametrize("world", [2, 4])
def test_sparse_comm_volume_savings(runs, world):
    port, jres = runs
    got, want = port[(world, "sparse")][0], jres[(world, "sparse")]
    assert list(got["sparse_elements"]) == list(want["sparse"])
    assert list(got["dense_elements"]) == list(want["dense"])
    assert (got["sparse_elements"] > 0).all()
    # 8 touched rows of 512 a rank -> ~1/64 of the elements a rank
    assert (got["sparse_elements"] < 0.25 * got["dense_elements"]).all()


def test_sparse_fp16_parity_with_dense_fp16(runs):
    port, jres = runs
    sp, dn = port[(2, "fp16_sparse")][0], port[(2, "fp16_dense")][0]
    np.testing.assert_allclose(sp["loss"], dn["loss"], rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(sp["params"], dn["params"], rtol=2e-3,
                               atol=2e-5)
    want = jres[(2, "fp16_sparse")]
    np.testing.assert_allclose(sp["loss"], want["loss"], rtol=1e-3)
    np.testing.assert_allclose(sp["params"], want["params"], atol=1e-3)
    assert list(sp["sparse_elements"]) == list(want["sparse"])


def test_sparse_fp16_overflow_votes_and_skips(runs):
    port, _ = runs
    p0 = np.concatenate([t.reshape(-1).numpy() for t in
                         (W.embed_params()["embedding"],
                          W.embed_params()["out_w"])])
    for r in port[(2, "overflow")]:
        np.testing.assert_array_equal(r["params"], p0)
        assert list(r["skipped"]) == [1]


def test_sparse_trains_to_convergence(runs):
    port, _ = runs
    losses = port[(2, "converge")][0]["loss"]
    assert losses[-1] < 0.5 * losses[0], losses


def test_sparse_logging_every_step(runs):
    port, _ = runs
    r = port[(2, "log")][0]
    assert np.isfinite(r["loss"]).all() and list(r["loss_scale"]) == [1, 1]
