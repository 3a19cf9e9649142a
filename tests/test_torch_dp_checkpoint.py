"""Checkpoints of the port's data-parallel engine (one optimizer file
per dp rank, the JAX layout) across dp sizes, ZeRO stages and the two
packages, on gpt2-tiny on the CPU (the harness of tests/test_torch_dp.py:
N gloo processes of tests/torch_dp_worker.py, the JAX engine on an
N-device mesh).

- A port dp 4 stage-3 save after 2 of 5 steps resumes at port dp 2
  stage 2 on the same global batches: the next 3 losses within 1e-5
  relative and the final params within 1e-5 absolute of the dp 4 run
  that did not stop.
- A port dp 2 (stage 2) save resumes in a JAX dp 2 engine, and a JAX
  dp 2 save resumes at port dp 2: the next 3 losses within 1e-5 and
  the final params within 1e-5 of the run that did not stop, on the
  saving side. The port's files have the JAX files' keys, shapes and
  dtypes, shard by shard, and the same meta layout keys.
- An async save at dp 2 writes the same bytes as the sync save.
"""
import json
import os

import numpy as np
import pytest

from test_torch_dp import (jax_engine, jax_flat_params, jax_steps, load,
                           make_batches, params_np, save_params, spawn,
                           wait)
from deepspeed_tpu_torch.runtime.flax_msgpack import msgpack_restore

SAVE_AT = 2


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("dpckpt")
    pnp = params_np()
    ppath = str(d / "params.npz")
    save_params(pnp, ppath)
    b2, b4 = make_batches(2, 3), make_batches(4, 4)
    np.save(str(d / "b2.npy"), b2)
    np.save(str(d / "b4.npy"), b4)

    def job(name, world_b, stage, **kw):
        return dict(dict(name=name, precision="fp32", stage=stage,
                         batches=str(d / f"b{world_b}.npy"),
                         out=str(d / name)), **kw)
    dirs = {k: str(d / k) for k in ("a4", "sync", "async", "jax")}
    first = [
        spawn(d, 4, [job("dp4", 4, 3, save=dict(dir=dirs["a4"],
                                                after=SAVE_AT))],
              "dp4", ppath),
        spawn(d, 2, [job("sync", 2, 2, save=dict(dir=dirs["sync"],
                                                 after=SAVE_AT)),
                     job("async", 2, 2, save=dict(dir=dirs["async"],
                                                  after=SAVE_AT),
                         ds={"checkpoint": {"async": True}})],
              "dp2a", ppath)]
    # JAX dp 2: save after SAVE_AT steps, go on to the end.
    jeng = jax_engine("fp32", 2, 2, pnp)
    jhead = jax_steps(jeng, b2[:SAVE_AT])
    jeng.save_checkpoint(dirs["jax"])
    jtail = jax_steps(jeng, b2[SAVE_AT:])
    jtail["params"] = jax_flat_params(jeng)
    for p in first:
        wait(p)
    second = spawn(d, 2, [
        job("from_dp4", 4, 2, micro=4, load=dirs["a4"], first=SAVE_AT),
        job("from_jax", 2, 2, load=dirs["jax"], first=SAVE_AT)],
        "dp2b", ppath)
    # JAX dp 2 resumes the port's dp 2 save.
    jres = jax_engine("fp32", 2, 2, params_np(seed=5))
    assert jres.load_checkpoint(dirs["sync"])[0] is not None
    jfrom = jax_steps(jres, b2[SAVE_AT:])
    jfrom["params"] = jax_flat_params(jres)
    wait(second)
    res = {n: load(str(d / n), w) for n, w in (
        ("dp4", 4), ("sync", 2), ("async", 2), ("from_dp4", 2),
        ("from_jax", 2))}
    return res, dict(head=jhead, tail=jtail, from_port=jfrom), dirs


def _tag(dirs, key):
    return os.path.join(dirs[key], f"global_step{SAVE_AT}")


def test_dp4_stage3_save_resumes_at_dp2_stage2(ckpt):
    res, _, dirs = ckpt
    with open(os.path.join(_tag(dirs, "a4"), "engine_meta.json")) as f:
        meta = json.load(f)
    assert meta["optim_shards"] == 4 and meta["dp_world_size"] == 4
    assert meta["optim_shard_axes"] == [None, 0, 0]
    want, got = res["dp4"][0], res["from_dp4"]
    for r in got:
        np.testing.assert_allclose(r["loss"], want["loss"][SAVE_AT:],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["params"], want["params"], atol=1e-5)


def test_port_dp2_save_resumes_in_jax_dp2(ckpt):
    res, jax_res, _ = ckpt
    want, got = res["sync"][0], jax_res["from_port"]
    np.testing.assert_allclose(got["loss"], want["loss"][SAVE_AT:],
                               rtol=1e-5)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-5)


def test_jax_dp2_save_resumes_at_port_dp2(ckpt):
    res, jax_res, _ = ckpt
    want = jax_res["tail"]
    for r in res["from_jax"]:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["params"], want["params"], atol=1e-5)


def test_async_save_is_byte_identical_to_sync_at_dp2(ckpt):
    _, _, dirs = ckpt
    a, b = _tag(dirs, "sync"), _tag(dirs, "async")
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert "zero_pp_rank_1_mp_rank_00_optim_states.msgpack" in names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def test_dp2_files_have_the_jax_layout(ckpt):
    _, _, dirs = ckpt
    port, jax_ = _tag(dirs, "sync"), _tag(dirs, "jax")
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_))
    with open(os.path.join(port, "engine_meta.json")) as f:
        pm = json.load(f)
    with open(os.path.join(jax_, "engine_meta.json")) as f:
        jm = json.load(f)
    for k in ("optim_shards", "optim_shard_axes", "dp_world_size",
              "fused_moment_layout", "global_steps"):
        assert pm[k] == jm[k], k
    for n in sorted(os.listdir(port)):
        if not n.endswith(".msgpack"):
            continue
        with open(os.path.join(port, n), "rb") as f:
            p = msgpack_restore(f.read())
        with open(os.path.join(jax_, n), "rb") as f:
            j = msgpack_restore(f.read())

        def shapes(t):
            if isinstance(t, dict):
                return {k: shapes(v) for k, v in t.items()}
            a = np.asarray(t)
            return (a.shape, a.dtype.name)
        assert shapes(p) == shapes(j), n
