"""ZeRO-Offload across dp ranks: the port's engine as N gloo processes
(``tests/torch_dp_worker.py``, the harness of tests/test_torch_dp.py)
against the JAX offload engine in one process on an N-device CPU mesh,
on gpt2-tiny (fp32, gas 2, micro 2 a rank, dropout 0, AdamW, clipping
1.0, WarmupLR, 5 steps).

Each rank holds its partition of the host masters and moments (each
leaf sliced along its first axis that dp divides, a leaf with none held
whole); the grads reach it by a reduce-scatter along that axis (an
all-reduce for a whole leaf), the partitioned squared norm is
all-reduced, and the params come back by an all-gather.

- dp 2 at stages 1 and 2, dp 4 at stage 2: losses within 1e-5 relative, the
  final device params within 1e-5 absolute, and every rank's partitions
  joined along their axes within 1e-5 of the JAX host masters and
  moments; every rank holds the same params bit for bit after every
  step, and a leaf held whole is the same bits on every rank.
- ``overlap_comm`` at dp 2 runs the serial step (as JAX's multi-process
  offload does): the same bits as without it.
- A port dp 2 save after 2 steps is the single-process layout (full
  leaves, one optimizer file): a JAX engine loads it and its next 3
  losses are within 1e-5 of the port run that did not stop; a JAX save
  resumes at port dp 2 likewise.
"""
import os

import numpy as np
import pytest

from test_torch_dp import (jax_engine, jax_flat_params, jax_steps, load,
                           make_batches, params_np, save_params, spawn,
                           wait)
from deepspeed_tpu_torch.runtime.zero.offload import _partition_axis
from torch_jax_native import jax_native  # noqa: F401 (autouse)
from test_torch_offload import team_of_one  # noqa: F401 (the JAX side's)

OFFLOAD = {"cpu_offload": True}
SAVE_AT = 2
RUNS = {  # name: (world, stage, extra zero keys)
    "dp2_s1": (2, 1, OFFLOAD), "dp2_s2": (2, 2, OFFLOAD),
    "dp4_s2": (4, 2, OFFLOAD),
    "dp2_s2_overlap": (2, 2, dict(OFFLOAD, overlap_comm=True)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("offload_dp")
    pnp = params_np()
    ppath = str(d / "params.npz")
    save_params(pnp, ppath)
    batches = {w: make_batches(w, 10 + w) for w in (2, 4)}
    for w, arr in batches.items():
        np.save(str(d / f"b{w}.npy"), arr)
    dirs = {k: str(d / k) for k in ("port", "jax")}

    def job(name, **kw):
        world, stage, zero = RUNS.get(name, RUNS["dp2_s2"])
        return dict(dict(name=name, precision="fp32", stage=stage,
                         zero=zero, batches=str(d / f"b{world}.npy"),
                         out=str(d / name)), **kw)
    # JAX's dp 2 stage 2 run saves first: its tag is the dp 2 group's
    # last job (a resume at port dp 2); the port's save from that group
    # resumes in the same JAX engine at the end.
    procs = [spawn(d, 4, [job("dp4_s2")], "dp4", ppath)]
    world, stage, zero = RUNS["dp2_s2"]
    jeng = jax_engine("fp32", stage, world, pnp, zero=zero)
    head = jax_steps(jeng, batches[2][:SAVE_AT])
    jeng.save_checkpoint(dirs["jax"])
    procs.append(spawn(d, 2, [
        job("dp2_s1"),
        job("dp2_s2", save=dict(dir=dirs["port"], after=SAVE_AT)),
        job("dp2_s2_overlap"),
        job("resume_from_jax", load=dirs["jax"], first=SAVE_AT)],
        "dp2", ppath))
    jres, jhost = {}, {}
    for name in ("dp2_s2", "dp2_s1", "dp4_s2"):
        world, stage, zero = RUNS[name]
        if name == "dp2_s2":
            eng = jeng
            tail = jax_steps(eng, batches[2][SAVE_AT:])
            rec = {k: np.concatenate([head[k], tail[k]]) for k in head}
        else:
            eng = jax_engine("fp32", stage, world, pnp, zero=zero)
            rec = jax_steps(eng, batches[world])
        rec["params"] = jax_flat_params(eng)
        jres[name] = rec
        off = eng._offload
        jhost[name] = [np.asarray(x) for x in off.masters + off.opt.exp_avg +
                       off.opt.exp_avg_sq]
    for p in procs:
        wait(p)
    port = {n: load(str(d / n), RUNS[n][0]) for n in RUNS}
    port["resume_from_jax"] = load(str(d / "resume_from_jax"), 2)
    # The port's dp 2 tag in JAX's engine.
    assert jeng.load_checkpoint(dirs["port"])[0] is not None
    jresumed = jax_steps(jeng, batches[2][SAVE_AT:])
    return dict(port=port, jax=jres, jhost=jhost, jresumed=jresumed,
                pnp=pnp, tag=os.path.join(dirs["port"], f"global_step"
                                          f"{SAVE_AT}"))


@pytest.mark.parametrize("name", ["dp2_s1", "dp2_s2", "dp4_s2"])
def test_offload_dp_matches_jax(runs, name):
    got, want = runs["port"][name], runs["jax"][name]
    np.testing.assert_allclose(got[0]["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got[0]["params"], want["params"], atol=1e-5)


def _joined(ranks, shapes, kind):
    """Every rank's partitions of host ``kind`` (hp, hm, hv) joined
    along each leaf's partition axis."""
    world = len(ranks)
    out = []
    for i, shape in enumerate(shapes):
        ax = _partition_axis(shape, world)
        parts = [r[f"{kind}{i}"] for r in ranks]
        if ax is None:
            for p in parts[1:]:
                np.testing.assert_array_equal(p, parts[0])
            out.append(parts[0])
        else:
            out.append(np.concatenate(parts, axis=ax))
    return out


@pytest.mark.parametrize("name", ["dp2_s1", "dp2_s2", "dp4_s2"])
def test_host_partitions_join_to_jax_state(runs, name):
    want = runs["jhost"][name]
    n = len(want) // 3
    shapes = [w.shape for w in want[:n]]
    got = sum((_joined(runs["port"][name], shapes, k)
               for k in ("hp", "hm", "hv")), [])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-5)
    local = runs["port"][name][0]
    assert any(local[f"hp{i}"].shape != s for i, s in enumerate(shapes))
    assert int(local["count"]) == 5


@pytest.mark.parametrize("name", list(RUNS))
def test_every_rank_holds_the_same_params(runs, name):
    ranks = runs["port"][name]
    for r in ranks[1:]:
        assert list(r["digest"]) == list(ranks[0]["digest"])
        np.testing.assert_array_equal(r["params"], ranks[0]["params"])
        np.testing.assert_array_equal(r["loss"], ranks[0]["loss"])


def test_overlap_at_dp2_is_the_serial_step(runs):
    a, b = runs["port"]["dp2_s2"][0], runs["port"]["dp2_s2_overlap"][0]
    assert list(a["digest"]) == list(b["digest"])
    np.testing.assert_array_equal(a["loss"], b["loss"])


def test_dp2_save_is_the_single_process_layout_and_resumes_in_jax(runs):
    names = sorted(os.listdir(runs["tag"]))
    assert names == ["engine_meta.json", "mp_rank_00_model_states.msgpack",
                     "zero_pp_rank_0_mp_rank_00_optim_states.msgpack"]
    port = runs["port"]["dp2_s2"][0]
    np.testing.assert_allclose(runs["jresumed"]["loss"],
                               port["loss"][SAVE_AT:], rtol=1e-5)


def test_jax_save_resumes_at_port_dp2(runs):
    got = runs["port"]["resume_from_jax"][0]
    np.testing.assert_allclose(got["loss"], runs["jax"]["dp2_s2"]["loss"]
                               [SAVE_AT:], rtol=1e-5)
    np.testing.assert_allclose(got["params"], runs["jax"]["dp2_s2"]
                               ["params"], atol=1e-5)
