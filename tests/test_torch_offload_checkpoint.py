"""ZeRO-Offload checkpoints: the port's offload engine against the JAX
package's, on gpt2-tiny on the CPU (the helpers of
tests/test_torch_offload.py).

- The JAX offload layout both ways (fp32, fp16, bf16): a JAX save
  resumes in the port and a port save in JAX, the next three losses
  within the training tolerances (1e-5, 1e-3, 1e-2), scales and skips
  equal; the same file names and meta keys; the optimizer file holds the
  bytes flax writes for its own tree.
- ``load_optimizer_states=False`` both ways: the masters from the module
  file, fresh moments, and the compute-dtype copy (and the card's
  params) re-derived from the loaded masters.
- The lr schedule is restored unless asked not to; a device-optimizer
  engine refuses an offload tag's optimizer state and takes its params
  without it, and an offload engine refuses a device-optimizer tag's.
"""
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

from deepspeed_tpu_torch.ops.fused_update import tree_flatten
from torch_jax_native import jax_native  # noqa: F401 (autouse)
from test_torch_offload import (PRECISIONS, _batches, _check_hist, _ds,
                                _jax_engine, _port_engine, _step,
                                params_np, team_of_one)  # noqa: F401


def _masters(eng):
    return [np.asarray(m, np.float32).copy() for m in eng._offload.masters]


@pytest.fixture(scope="module")
def resume_runs(tmp_path_factory, params_np):
    """``resume_runs(precision)``: JAX trains 3 steps, saves, trains 3
    more; the port (from another init) loads the JAX tag, trains the
    same 3, saves, trains 3 more; the JAX engine loads the port's tag
    and trains those 3. Run once a precision (the JAX engine's compile
    is most of a run's time) and shared by the tests below."""
    runs = {}

    def run(precision):
        if precision in runs:
            return runs[precision]
        d = tmp_path_factory.mktemp(f"offload_{precision}")
        jdir, tdir = str(d / "jax"), str(d / "port")
        batches = _batches(9)
        jeng = _jax_engine(precision, params_np)
        jhist = [_step(jeng, b) for b in batches[:3]]
        jeng.save_checkpoint(jdir)
        jsaved = _masters(jeng)
        jhist += [_step(jeng, b) for b in batches[3:6]]
        other = jax.tree_util.tree_map(lambda x: x * 0.5, params_np)
        teng = _port_engine(precision, other)
        path, _ = teng.load_checkpoint(jdir)
        loaded = (path, teng.global_steps, teng.global_samples,
                  teng.lr_scheduler.last_batch_iteration)
        thist = [_step(teng, b) for b in batches[3:6]]
        teng.save_checkpoint(tdir, client_state={"epoch": 2})
        tsaved = _masters(teng)
        thist += [_step(teng, b) for b in batches[6:9]]
        jpath, jclient = jeng.load_checkpoint(tdir)
        assert jpath is not None
        j2hist = [_step(jeng, b) for b in batches[6:9]]
        runs[precision] = dict(
            precision=precision, jhist=jhist, thist=thist, j2hist=j2hist,
            loaded=loaded, jclient=jclient, jdir=jdir, tdir=tdir,
            jsaved=jsaved, tsaved=tsaved, jeng=jeng)
        return runs[precision]
    return run


@pytest.fixture(scope="module", params=list(PRECISIONS))
def resumes(request, resume_runs):
    return resume_runs(request.param)


def test_jax_offload_save_resumes_in_port(resumes):
    r = resumes
    assert r["loaded"][0].endswith("global_step3")
    assert r["loaded"][1:] == (3, 12, 2)
    _check_hist(r["thist"][:3], r["jhist"][3:6], r["precision"])


def test_port_offload_save_resumes_in_jax(resumes):
    r = resumes
    assert r["jclient"] == {"epoch": 2}
    _check_hist(r["j2hist"], r["thist"][3:6], r["precision"])
    if r["precision"] == "fp16":
        assert r["jhist"][2][2] > 0, r["jhist"]


def test_port_offload_files_are_the_jax_layout(resumes):
    """The same file names and meta keys as the JAX offload tag, and an
    optimizer file holding the bytes flax writes for its own tree."""
    tag = os.path.join(resumes["tdir"], "global_step6")
    jtag = os.path.join(resumes["jdir"], "global_step3")
    assert sorted(os.listdir(tag)) == sorted(os.listdir(jtag))
    with open(os.path.join(tag, "engine_meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(jtag, "engine_meta.json")) as f:
        jmeta = json.load(f)
    assert list(meta) == list(jmeta)
    name = "zero_pp_rank_0_mp_rank_00_optim_states.msgpack"
    with open(os.path.join(tag, name), "rb") as f:
        raw = f.read()
    tree = flax_ser.msgpack_restore(raw)
    assert flax_ser.msgpack_serialize(tree) == raw
    with open(os.path.join(jtag, name), "rb") as f:
        jtree = flax_ser.msgpack_restore(f.read())
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    for (_, a), (_, b) in zip(flat, jflat):
        assert type(a) is type(b)
        if isinstance(a, np.ndarray):
            assert (a.shape, a.dtype) == (b.shape, b.dtype)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_load_without_optimizer_states(direction, resume_runs, params_np):
    """Masters from the module file, fresh moments, the compute-dtype
    copy (and the card's params) re-derived from the loaded masters. The
    bf16 run's tags: JAX's (step 3) into a new port engine that has
    trained a step, the port's (step 6) into that run's JAX engine, which
    has trained on since."""
    r = resume_runs("bf16")
    if direction == "jax_to_port":
        path, saved, steps = r["jdir"], r["jsaved"], 3
        dst = _port_engine("bf16", jax.tree_util.tree_map(
            lambda x: x * 0.5, params_np))
        dst.train_batch(_batches(1, seed=1)[0])  # moments, staging in use
    else:
        path, saved, steps = r["tdir"], r["tsaved"], 6
        dst = r["jeng"]
    opt_steps = dst._offload.opt.step_count
    dst.load_checkpoint(path, load_optimizer_states=False)
    off = dst._offload
    staged = off.staging if direction == "jax_to_port" \
        else off.local_param_leaves()
    for m, s in zip(off.masters, saved):
        np.testing.assert_array_equal(np.asarray(m), s)
    for st, m in zip(staged, off.masters):
        want = np.asarray(m, np.float32).astype(ml_dtypes.bfloat16)
        got = st.view(torch.int16).numpy() if isinstance(st, torch.Tensor) \
            else np.asarray(st).view(np.int16)
        np.testing.assert_array_equal(got, want.view(np.int16))
    if direction == "jax_to_port":
        for pv, st in zip(tree_flatten(dst.state.params)[0], staged):
            assert torch.equal(pv, st)
    assert off.opt.step_count == opt_steps and dst.global_steps == steps


def test_lr_scheduler_state_loads_unless_asked_not_to(tmp_path, params_np):
    eng = _port_engine("fp32", params_np)
    for b in _batches(3):
        eng.train_batch(b)
    eng.save_checkpoint(str(tmp_path))
    for flag, want in ((True, 2), (False, -1)):
        other = _port_engine("fp32", params_np)
        other.load_checkpoint(str(tmp_path), load_lr_scheduler_states=flag)
        assert other.lr_scheduler.last_batch_iteration == want
        assert other.global_steps == 3


def test_device_optimizer_engine_and_an_offload_tag(tmp_path, params_np):
    eng = _port_engine("fp32", params_np)
    eng.train_batch(_batches(1)[0])
    eng.save_checkpoint(str(tmp_path))
    dev = _port_engine("fp32", params_np, _ds("fp32", {"cpu_offload": False}))
    assert dev._offload is None
    with pytest.raises(ValueError, match="ZeRO-Offload"):
        dev.load_checkpoint(str(tmp_path))
    assert dev.global_steps == 0
    path, _ = dev.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert path is not None
    for a, b in zip(tree_flatten(dev.state.params)[0], eng._offload.masters):
        assert torch.equal(a, b)
    # ...and an offload engine refuses a device-optimizer tag's state.
    d2 = tmp_path / "dev"
    dev.save_checkpoint(str(d2))
    with pytest.raises(ValueError, match="no ZeRO-Offload"):
        _port_engine("fp32", params_np).load_checkpoint(str(d2))
