"""The port's checkpointing against the JAX package's, on gpt2-tiny on
the CPU: the same files in both directions.

- The msgpack codec (runtime/flax_msgpack.py) writes the bytes flax's
  ``msgpack_serialize`` writes (fp32, bf16, fp16 and int32 arrays, 0-d
  arrays, numpy scalars, nested dicts, chunked arrays with
  ``MAX_CHUNK_SIZE`` lowered on both sides) and reads flax's bytes back
  to equal arrays (bf16 as a torch tensor through its 2-byte view).
- JAX save → port resume, and port save → JAX resume, in fp32, fp16
  (initial_scale_power 21: four skipped steps, then taken ones) and
  bf16 with fp32 masters, gas 2, WarmupLR: the next three losses within
  1e-5, 1e-3 and 1e-2 relative (tests/test_torch_training.py's
  tolerances), the fp16 loss scales and skip counts equal.
- A JAX dp 2, ZeRO stage 2 save (two optimizer shard files) resumes in
  the port at world size 1: the next three fp32 losses within 1e-5 of a
  JAX dp 1 engine that loads the same tag.
- Port save → port resume with dropout 0.1 repeats the uninterrupted run
  bit for bit (losses, params, moments), in bf16 with masters and in the
  master-free mode (stochastic rounding); async and sync saves write the
  same bytes; a snapshot taken before a step still holds the pre-step
  values after it.
- The commit protocol, the load hardening, auto-save, the writer's
  bounds and failures and the SIGTERM save, as the JAX package's
  tests/test_async_ckpt.py holds them; a process SIGKILLed at each of
  the six crash points leaves ``latest`` loadable.
- The ``checkpoint`` block parses and rejects as the JAX one does.
- ``InferenceEngine.from_train_checkpoint`` on a JAX tag serves the
  greedy tokens of the JAX ``from_train_checkpoint``, with step logits
  within tests/test_torch_serving.py's 1e-4.

The JAX engines run on a one-device mesh (dp 2 on two of the eight CPU
devices) with dense attention and ``fused_kernels=False``.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu_torch.inference import InferenceEngine as TEngine
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.fused_update import tree_flatten
from deepspeed_tpu_torch.runtime import async_ckpt
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import flax_msgpack as fm
from deepspeed_tpu_torch.runtime.async_ckpt import (AsyncCheckpointer,
                                                    CheckpointSnapshot,
                                                    commit_snapshot,
                                                    is_complete)
from torch_jax_native import jax_native  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = {"fp32": 1e-5, "fp16": 1e-3, "bf16": 1e-2}
PRECISIONS = {"fp32": (torch.float32, jnp.float32),
              "fp16": (torch.float16, jnp.float16),
              "bf16": (torch.bfloat16, jnp.bfloat16)}


# --------------------------------------------------------------------- #
# Codec
# --------------------------------------------------------------------- #
def _codec_tree():
    rng = np.random.default_rng(0)
    return {
        "fp32": rng.standard_normal((3, 5)).astype(np.float32),
        "fp16": rng.standard_normal((4,)).astype(np.float16),
        "bf16": rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16),
        "int32": np.arange(-3, 9, dtype=np.int32).reshape(3, 4),
        "zero_d": np.asarray(np.float32(2.5)),
        "np_scalar": np.int32(-7),
        "np_scalar_f": np.float32(0.125),
        "nested": {"b": {"z": np.ones(2, np.float32), "a": [1, -40, 300]},
                   "10": 70000, "2": -2 ** 33, "s": "x" * 40},
        "empty": np.zeros((0, 3), np.float32),
        "flags": {"t": True, "f": False, "n": None, "x": 1.5},
    }


def _torch_tree(tree):
    """The same tree with every array as a torch tensor (bf16 too)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, np.ndarray):
            if x.dtype == ml_dtypes.bfloat16:
                return torch.from_numpy(x.view(np.uint16).copy()).view(
                    torch.bfloat16)
            return torch.from_numpy(x.copy())
        return x
    return conv(tree)


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, np.ndarray) and want.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert np.asarray(got).dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("arrays", ["numpy", "torch"])
def test_codec_bytes_equal_flax(arrays):
    tree = _codec_tree()
    want = flax_ser.msgpack_serialize(tree)
    src = tree if arrays == "numpy" else _torch_tree(tree)
    assert fm.msgpack_serialize(src) == want


def test_codec_restores_flax_bytes():
    tree = _codec_tree()
    _assert_tree_equal(fm.msgpack_restore(flax_ser.msgpack_serialize(tree)),
                       tree)


def test_codec_chunked_arrays(monkeypatch):
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", 1000)
    rng = np.random.default_rng(1)
    tree = {"big": rng.standard_normal((30, 20)).astype(np.float32),
            "bf": rng.standard_normal(1500).astype(ml_dtypes.bfloat16),
            "small": np.arange(5, dtype=np.int32)}
    want = flax_ser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in want
    assert fm.msgpack_serialize(tree) == want
    assert fm.msgpack_serialize(_torch_tree(tree)) == want
    _assert_tree_equal(fm.msgpack_restore(want), tree)
    top = rng.standard_normal(700).astype(np.float32)
    assert fm.msgpack_serialize(top) == flax_ser.msgpack_serialize(top)


# --------------------------------------------------------------------- #
# JAX <-> port resumes (fp32, fp16, bf16)
# --------------------------------------------------------------------- #
def _cfgs(precision, dropout=0.0):
    tdt, jdt = PRECISIONS[precision]
    d = dict(hidden_dropout=dropout, attn_dropout=dropout)
    return (dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=tdt,
                                **d),
            dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=jdt,
                                fused_kernels=False, **d))


def _ds(precision, extra=None):
    ds = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-4, "weight_decay": 0.01}},
          "scheduler": {"type": "WarmupLR", "params": {
              "warmup_num_steps": 3, "warmup_max_lr": 1e-4}}}
    if precision == "fp16":
        ds["fp16"] = {"enabled": True, "initial_scale_power": 21}
    if precision in ("bf16", "master_free"):
        ds["bf16"] = {"enabled": True,
                      "stochastic_rounding": precision == "master_free"}
    ds.update(extra or {})
    return ds


def _batches(n=9, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (4, 33)).astype(np.int32)
            for _ in range(n)]


def _params_np(seed=0):
    return jax.tree_util.tree_map(
        np.asarray,
        jgpt2.gpt2_init(jax.random.PRNGKey(seed), _cfgs("fp32")[1]))


def _jax_engine(precision, params_np, devices=1, ds=None):
    _, jcfg = _cfgs(precision)
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params_np),
        config=ds or _ds(precision),
        mesh=build_mesh(devices=jax.devices()[:devices]))
    return eng


def _port_engine(precision, params=None, seed=0, dropout=0.0, extra=None,
                 rng=None):
    tcfg, _ = _cfgs("bf16" if precision == "master_free" else precision,
                    dropout)
    if params is None:
        params = tgpt2.gpt2_init(tcfg, torch.Generator().manual_seed(seed),
                                 "cpu")
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg), model_params=params,
        config=_ds(precision, extra), device="cpu", rng=rng)
    return eng


def _step(eng, batch):
    loss = float(eng.train_batch(batch))
    st = eng.state
    return (loss, float(st.loss_scale), int(st.skipped_steps))


def _check_hist(got, want, precision):
    rtol = RTOL[precision]
    for (gl, gs, gk), (wl, ws, wk) in zip(got, want):
        assert abs(gl - wl) <= rtol * abs(wl), (got, want)
        if precision == "fp16":
            assert (gs, gk) == (ws, wk), (got, want)


@pytest.fixture(scope="module", params=list(PRECISIONS))
def resumes(request, tmp_path_factory):
    """JAX trains 3 steps, saves, trains 3 more; the port loads the JAX
    tag, trains the same 3, saves, and trains 3 more; a fresh JAX engine
    loads the port's tag and trains those 3."""
    precision = request.param
    d = tmp_path_factory.mktemp(f"resume_{precision}")
    jdir, tdir = str(d / "jax"), str(d / "port")
    batches = _batches()
    params = _params_np()
    jeng = _jax_engine(precision, params)
    jhist = [_step(jeng, b) for b in batches[:3]]
    jeng.save_checkpoint(jdir)
    jhist += [_step(jeng, b) for b in batches[3:6]]

    teng = _port_engine(precision, seed=5)
    path, client = teng.load_checkpoint(jdir)
    loaded = dict(path=path, client=client, steps=teng.global_steps,
                  samples=teng.global_samples, micro=teng.micro_steps,
                  lbi=teng.lr_scheduler.last_batch_iteration)
    thist = [_step(teng, b) for b in batches[3:6]]
    teng.save_checkpoint(tdir, client_state={"epoch": 2})
    thist += [_step(teng, b) for b in batches[6:9]]

    jeng2 = _jax_engine(precision, _params_np(seed=9))
    jpath, jclient = jeng2.load_checkpoint(tdir)
    assert jpath is not None
    j2hist = [_step(jeng2, b) for b in batches[6:9]]
    return dict(precision=precision, jhist=jhist, thist=thist,
                j2hist=j2hist, loaded=loaded, jclient=jclient,
                jdir=jdir, tdir=tdir)


def test_jax_save_resumes_in_port(resumes):
    r = resumes
    assert r["loaded"]["path"].endswith("global_step3")
    assert r["loaded"]["client"] == {}
    assert (r["loaded"]["steps"], r["loaded"]["samples"],
            r["loaded"]["micro"], r["loaded"]["lbi"]) == (3, 12, 6, 2)
    _check_hist(r["thist"][:3], r["jhist"][3:6], r["precision"])
    if r["precision"] == "fp16":
        # skipped steps before the save, taken ones after the resume
        assert r["jhist"][2][2] > 0 and r["thist"][2][2] < 6, r["jhist"]


def test_port_save_resumes_in_jax(resumes):
    r = resumes
    assert r["jclient"] == {"epoch": 2}
    _check_hist(r["j2hist"], r["thist"][3:6], r["precision"])


def test_port_files_are_the_jax_layout(resumes):
    """The port's tag: the JAX file names, meta keys in the JAX order
    with the layout marker and one shard axis per optimizer leaf, and an
    optimizer file whose moments are the JAX V-interleaved buffers."""
    tag = os.path.join(resumes["tdir"], "global_step6")
    assert sorted(os.listdir(tag)) == sorted([
        "engine_meta.json", "mp_rank_00_model_states.msgpack",
        "zero_pp_rank_0_mp_rank_00_optim_states.msgpack"])
    with open(os.path.join(tag, "engine_meta.json")) as f:
        meta = json.load(f)
    jtag = os.path.join(resumes["jdir"], "global_step3")
    with open(os.path.join(jtag, "engine_meta.json")) as f:
        jmeta = json.load(f)
    assert list(meta) == list(jmeta)
    assert meta["fused_moment_layout"] == 2
    assert meta["optim_shard_axes"] == jmeta["optim_shard_axes"] == \
        [None, None, None]
    assert meta["lr_scheduler"] == {"last_batch_iteration": 5}
    assert (meta["global_steps"], meta["global_samples"]) == (6, 24)
    with open(os.path.join(tag, "zero_pp_rank_0_mp_rank_00_optim_states"
                           ".msgpack"), "rb") as f:
        port = flax_ser.msgpack_restore(f.read())
    with open(os.path.join(jtag, "zero_pp_rank_0_mp_rank_00_optim_states"
                           ".msgpack"), "rb") as f:
        jax_ = flax_ser.msgpack_restore(f.read())
    assert sorted(port) == sorted(jax_)
    for k in port:
        if k == "__scalars__":
            for s in port[k]:
                assert port[k][s].dtype == jax_[k][s].dtype
                assert port[k][s].shape == ()
        else:
            assert (port[k].shape, port[k].dtype) == \
                (jax_[k].shape, jax_[k].dtype)


def test_jax_dp2_zero2_save_resumes_in_port(tmp_path):
    """A JAX save on two dp ranks (ZeRO stage 2: two optimizer shard
    files, the moments split along axis 0) loads at world size 1 by
    joining the shards; the port's next three losses match a JAX dp 1
    engine that loads the same tag."""
    d = str(tmp_path / "dp2")
    ds2 = _ds("fp32", {"zero_optimization": {"stage": 2}})
    jeng = _jax_engine("fp32", _params_np(), devices=2, ds=ds2)
    batches = _batches()
    for b in batches[:3]:
        jeng.train_batch(b)
    jeng.save_checkpoint(d)
    with open(os.path.join(d, "global_step3", "engine_meta.json")) as f:
        meta = json.load(f)
    assert meta["optim_shards"] == 2 and meta["dp_world_size"] == 2
    assert meta["optim_shard_axes"] == [None, 0, 0]
    j1 = _jax_engine("fp32", _params_np(seed=4))
    assert j1.load_checkpoint(d)[0] is not None
    want = [_step(j1, b) for b in batches[3:6]]
    teng = _port_engine("fp32", seed=4)
    assert teng.load_checkpoint(d)[0] is not None
    assert teng.global_steps == 3
    _check_hist([_step(teng, b) for b in batches[3:6]], want, "fp32")


# --------------------------------------------------------------------- #
# Port save -> port resume: bit-equal, async == sync, snapshot copies
# --------------------------------------------------------------------- #
def _flat_state(eng):
    out = [g.param.clone() for g in eng._groups]
    out += [g.cast.clone() for g in eng._groups if g.cast is not None]
    out += [t.clone() for t in eng.state.opt_state.m + eng.state.opt_state.v]
    st = eng.state
    out += [t.clone() for t in (st.step, st.loss_scale, st.growth_count,
                                st.hysteresis, st.skipped_steps,
                                st.opt_state.count)]
    return out


@pytest.mark.parametrize("precision", ["bf16", "master_free"])
def test_port_resume_is_bit_equal_with_dropout(tmp_path, precision):
    """Dropout 0.1 (and, master-free, the stochastic-rounding seed): the
    step's random stream comes from the base seed and the step, so a
    resumed run repeats the uninterrupted one bit for bit."""
    batches = _batches(6)
    a = _port_engine(precision, seed=0, dropout=0.1, rng=11)
    la = [float(a.train_batch(b)) for b in batches[:3]]
    a.save_checkpoint(str(tmp_path))
    la += [float(a.train_batch(b)) for b in batches[3:]]
    b = _port_engine(precision, seed=1, dropout=0.1, rng=11)
    assert b.load_checkpoint(str(tmp_path))[0] is not None
    lb = [float(b.train_batch(x)) for x in batches[3:]]
    assert lb == la[3:]
    for x, y in zip(_flat_state(a), _flat_state(b)):
        assert torch.equal(x, y)
    # A generator given as rng seeds the stream by its initial seed.
    g = _port_engine(precision, seed=0, dropout=0.1,
                     rng=torch.Generator().manual_seed(11))
    assert [float(g.train_batch(x)) for x in batches[:3]] == la[:3]


def test_async_and_sync_artifacts_bit_identical(tmp_path):
    eng = _port_engine("bf16", extra={"checkpoint": {"async": True}})
    for b in _batches(3):
        eng.train_batch(b)
    eng.save_checkpoint(str(tmp_path / "a"), tag="t")
    assert eng._async_ckpt.wait(timeout=60)
    assert eng._async_ckpt.last_error is None
    eng._async_ckpt.close()
    eng._async_ckpt = None          # reroute through the sync path
    eng.save_checkpoint(str(tmp_path / "s"), tag="t")
    files = sorted(os.listdir(tmp_path / "a" / "t"))
    assert files == sorted(os.listdir(tmp_path / "s" / "t"))
    for fn in files:
        assert (tmp_path / "a" / "t" / fn).read_bytes() == \
            (tmp_path / "s" / "t" / fn).read_bytes(), fn


def test_snapshot_holds_pre_step_values(tmp_path):
    """The fused step rewrites the flat buffers in place: a snapshot
    taken before a step, committed after it, still holds the values of
    its own step."""
    batches = _batches(3)
    eng = _port_engine("fp32")
    eng.train_batch(batches[0])
    before = _flat_state(eng)
    snap = eng._snapshot_checkpoint(str(tmp_path / "late"), None, None,
                                    True)
    eng.train_batch(batches[1])
    assert not torch.equal(before[0], eng._groups[0].param)
    commit_snapshot(snap)
    eng2 = _port_engine("fp32", seed=3)
    assert eng2.load_checkpoint(str(tmp_path / "late"))[0] is not None
    assert eng2.global_steps == 1
    for x, y in zip(before, _flat_state(eng2)):
        assert torch.equal(x, y)


# --------------------------------------------------------------------- #
# Commit protocol (host-only units), as tests/test_async_ckpt.py
# --------------------------------------------------------------------- #
class TestCommitProtocol:
    def _snap(self, tmp_path, tag="t", payload=b"x" * 64):
        return CheckpointSnapshot(
            save_dir=str(tmp_path), tag=tag, save_latest=True,
            meta={"global_steps": 1},
            blobs=[("blob.bin", payload), ("lazy.bin", lambda: payload)])

    def test_commit_seals_and_flips_latest(self, tmp_path):
        commit_snapshot(self._snap(tmp_path))
        assert is_complete(tmp_path / "t")
        assert (tmp_path / "t" / "blob.bin").read_bytes() == b"x" * 64
        assert (tmp_path / "t" / "lazy.bin").read_bytes() == b"x" * 64
        assert (tmp_path / "latest").read_text() == "t"
        assert sorted(os.listdir(tmp_path)) == ["latest", "t"]

    def test_same_tag_overwrite(self, tmp_path):
        commit_snapshot(self._snap(tmp_path, payload=b"old" * 10))
        commit_snapshot(self._snap(tmp_path, payload=b"new" * 10))
        assert (tmp_path / "t" / "blob.bin").read_bytes() == b"new" * 10
        assert sorted(os.listdir(tmp_path)) == ["latest", "t"]

    def test_stale_tmp_dir_cleared(self, tmp_path):
        stale = tmp_path / "t.tmp"
        stale.mkdir()
        (stale / "garbage").write_text("torn")
        commit_snapshot(self._snap(tmp_path))
        assert is_complete(tmp_path / "t")
        assert not stale.exists()

    def test_writer_error_surfaces_on_next_save(self, tmp_path):
        ck = AsyncCheckpointer(writer_timeout_s=5.0)
        try:
            def boom():
                raise OSError("disk gone")
            ck.submit(CheckpointSnapshot(
                save_dir=str(tmp_path), tag="bad", save_latest=True,
                meta={}, blobs=[("b.bin", boom)]))
            assert ck.wait(timeout=10)
            assert isinstance(ck.last_error, OSError)
            assert not (tmp_path / "latest").exists()
            assert not is_complete(tmp_path / "bad")
        finally:
            ck.close()

    def test_engine_raises_failed_background_write(self, tmp_path):
        eng = _port_engine("fp32", extra={"checkpoint": {"async": True}})
        eng.train_batch(_batches(1)[0])
        eng._async_ckpt.last_error = OSError("disk gone")
        with pytest.raises(RuntimeError, match="background checkpoint"):
            eng.save_checkpoint(str(tmp_path / "ck"))
        # The error is consumed: the retry goes through.
        assert eng.save_checkpoint(str(tmp_path / "ck"))
        assert eng._async_ckpt.wait(timeout=30)
        assert is_complete(tmp_path / "ck" / "global_step1")
        eng._async_ckpt.close()


# --------------------------------------------------------------------- #
# Auto-save, the writer's bounds, the preemption save
# --------------------------------------------------------------------- #
def test_snapshot_every_auto_saves(tmp_path):
    d = str(tmp_path / "auto")
    eng = _port_engine("fp32", extra={"checkpoint": {
        "async": True, "snapshot_every": 2, "save_dir": d,
        "preempt_save": False}})
    for b in _batches(5):
        eng.train_batch(b)
    assert eng._async_ckpt.wait(timeout=60)
    tags = sorted(t for t in os.listdir(d) if t.startswith("global"))
    assert tags == ["global_step2", "global_step4"]
    assert (tmp_path / "auto" / "latest").read_text() == "global_step4"
    for t in tags:
        assert is_complete(os.path.join(d, t))
    eng._async_ckpt.close()


def test_max_pending_bounds_host_copies(tmp_path, monkeypatch):
    """The next save blocks until the writer has room: host memory stays
    at max_pending_snapshots full-state copies."""
    monkeypatch.setenv("DS_CKPT_TEST_WRITE_DELAY_S", "0.2")
    eng = _port_engine("fp32", extra={"checkpoint": {"async": True}})
    eng.train_batch(_batches(1)[0])
    t0 = time.perf_counter()
    eng.save_checkpoint(str(tmp_path / "ck"), tag="a")
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.save_checkpoint(str(tmp_path / "ck"), tag="b")
    second = time.perf_counter() - t0
    assert second > first + 0.2, (first, second)
    assert eng._async_ckpt.wait(timeout=60)
    assert is_complete(tmp_path / "ck" / "a")
    assert is_complete(tmp_path / "ck" / "b")
    assert (tmp_path / "ck" / "latest").read_text() == "b"
    eng._async_ckpt.close()


def test_wedged_writer_fails_save_loudly(tmp_path, monkeypatch):
    monkeypatch.setenv("DS_CKPT_TEST_WRITE_DELAY_S", "0.4")
    eng = _port_engine("fp32", extra={"checkpoint": {
        "async": True, "writer_timeout_s": 0.2}})
    monkeypatch.chdir(tmp_path)         # the watchdog's stack dump
    eng.train_batch(_batches(1)[0])
    eng.save_checkpoint(str(tmp_path / "ck"), tag="a")
    with pytest.raises(RuntimeError, match="writer still busy"):
        eng.save_checkpoint(str(tmp_path / "ck"), tag="b")
    assert eng._async_ckpt.wait(timeout=60)
    assert is_complete(tmp_path / "ck" / "a")
    assert not (tmp_path / "ck" / "b").exists()
    eng._async_ckpt.close()


class TestPreemptSave:
    def test_preempt_skips_when_step_already_saved(self, tmp_path):
        d = str(tmp_path / "auto")
        eng = _port_engine("fp32", extra={"checkpoint": {
            "snapshot_every": 2, "save_dir": d, "preempt_save": False}})
        for b in _batches(4):
            eng.train_batch(b)
        before = os.path.getmtime(os.path.join(d, "global_step4"))
        assert eng.preempt_save() is True
        assert os.path.getmtime(os.path.join(d, "global_step4")) == before
        tags = sorted(t for t in os.listdir(d) if t.startswith("global"))
        assert tags == ["global_step2", "global_step4"]

    def test_preempt_waits_for_inflight_write(self, tmp_path, monkeypatch):
        monkeypatch.setenv("DS_CKPT_TEST_WRITE_DELAY_S", "0.1")
        d = str(tmp_path / "auto")
        eng = _port_engine("fp32", extra={"checkpoint": {
            "async": True, "snapshot_every": 1, "save_dir": d,
            "preempt_save": False}})
        eng.train_batch(_batches(1)[0])            # the auto-save queues
        assert eng.preempt_save() is True          # waits, no second save
        assert not eng._async_ckpt.in_flight
        assert (tmp_path / "auto" / "latest").read_text() == "global_step1"
        assert is_complete(os.path.join(d, "global_step1"))
        eng._async_ckpt.close()

    def test_preempt_falls_through_after_failed_background_write(
            self, tmp_path):
        d = str(tmp_path / "auto")
        eng = _port_engine("fp32", extra={"checkpoint": {
            "async": True, "snapshot_every": 1, "save_dir": d,
            "preempt_save": False}})
        eng.train_batch(_batches(1)[0])
        assert eng._async_ckpt.wait(timeout=60)
        eng._async_ckpt.last_error = OSError("disk gone")
        assert eng.preempt_save() is True
        assert (tmp_path / "auto" / "latest").read_text() == "global_step1"
        assert is_complete(os.path.join(d, "global_step1"))
        assert eng._async_ckpt.last_error is None
        eng._async_ckpt.close()

    def test_no_handler_without_save_dir(self):
        before = signal.getsignal(signal.SIGTERM)
        eng = _port_engine("fp32", extra={"checkpoint": {"async": True}})
        assert eng._preempt_saver is None
        assert signal.getsignal(signal.SIGTERM) == before
        eng._async_ckpt.close()

    def test_sigterm_saves_final_and_exits_by_the_signal(self, tmp_path):
        """A run killed by SIGTERM between auto-saves: the handler
        commits the current step, then the process dies by the signal
        (the default disposition re-raised)."""
        d = str(tmp_path / "auto")
        code = f"""
import sys, os, signal, dataclasses, numpy as np, torch
sys.path.insert(0, {REPO!r})
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2
cfg = dataclasses.replace(gpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32)
ds = {{"train_batch_size": 2, "steps_per_print": 10 ** 9,
      "optimizer": {{"type": "AdamW", "params": {{"lr": 1e-3}}}},
      "checkpoint": {{"snapshot_every": 2, "save_dir": {d!r}}}}}
eng, *_ = deepspeed_tpu_torch.initialize(
    model=gpt2.gpt2_loss_fn(cfg),
    model_params=gpt2.gpt2_init(cfg, torch.Generator().manual_seed(0), "cpu"),
    config=ds, device="cpu")
rng = np.random.default_rng(0)
for _ in range(3):
    eng.train_batch(rng.integers(0, 512, (2, 17)))
os.kill(os.getpid(), signal.SIGTERM)
print("SURVIVED_SIGTERM")
"""
        p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=120)
        assert p.returncode == -signal.SIGTERM, (p.returncode, p.stderr)
        assert "SURVIVED_SIGTERM" not in p.stdout
        assert (tmp_path / "auto" / "latest").read_text() == "global_step3"
        assert is_complete(os.path.join(d, "global_step2"))
        eng = _port_engine("fp32", seed=3)
        eng.load_checkpoint(d)
        assert eng.global_steps == 3


# --------------------------------------------------------------------- #
# Load hardening and the tags the port refuses
# --------------------------------------------------------------------- #
class TestLoadHardening:
    def test_latest_written_atomically_no_residue(self, tmp_path):
        eng = _port_engine("fp32")
        eng.train_batch(_batches(1)[0])
        eng.save_checkpoint(str(tmp_path), tag="t")
        names = os.listdir(tmp_path)
        assert "latest" in names
        assert not [n for n in names if n.startswith("latest.tmp")]
        assert (tmp_path / "latest").read_text() == "t"

    def test_torn_tag_refused_with_state_untouched(self, tmp_path):
        eng = _port_engine("fp32")
        eng.train_batch(_batches(1)[0])
        eng.save_checkpoint(str(tmp_path), tag="t")
        os.remove(tmp_path / "t" / "engine_meta.json")    # tear the seal
        eng2 = _port_engine("fp32", seed=7)
        before = _flat_state(eng2)
        assert eng2.load_checkpoint(str(tmp_path)) == (None, {})
        assert eng2.global_steps == 0
        for a, b in zip(before, _flat_state(eng2)):
            assert torch.equal(a, b)

    def test_latest_to_missing_dir_refused(self, tmp_path):
        (tmp_path / "latest").write_text("ghost")
        eng = _port_engine("fp32")
        assert eng.load_checkpoint(str(tmp_path)) == (None, {})
        assert eng.load_checkpoint(str(tmp_path / "nowhere")) == (None, {})


def _saved_tag(tmp_path, eng=None):
    eng = eng or _port_engine("fp32")
    eng.train_batch(_batches(1)[0])
    eng.save_checkpoint(str(tmp_path), tag="t")
    return tmp_path / "t"


def _edit_meta(tag, **kw):
    meta = json.loads((tag / "engine_meta.json").read_text())
    meta.update(kw)
    for k, v in list(meta.items()):
        if v is None:
            del meta[k]
    (tag / "engine_meta.json").write_text(json.dumps(meta))


def test_old_moment_layout_refused_before_any_state_changes(tmp_path):
    tag = _saved_tag(tmp_path)
    _edit_meta(tag, fused_moment_layout=None)
    eng = _port_engine("fp32", seed=7)
    before = _flat_state(eng)
    with pytest.raises(ValueError, match="fused_moment_layout"):
        eng.load_checkpoint(str(tmp_path))
    for a, b in zip(before, _flat_state(eng)):
        assert torch.equal(a, b)
    # Params only: the moments keep their values.
    path, _ = eng.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert path is not None and eng.global_steps == 1
    assert torch.equal(before[1], eng.state.opt_state.m[0])


@pytest.mark.parametrize("meta, match", [
    ({"mp_shards": 2, "param_shard_axes": [None]}, "tensor-parallel"),
    ({"pipeline_layer_files": True}, "pipeline"),
    ({"optim_shards": None, "offload": True}, "ZeRO-Offload"),
])
def test_unported_checkpoint_layouts_raise(tmp_path, meta, match):
    if meta.pop("offload", False):
        # ZeRO-Offload tags are ported: an offload engine's tag (host
        # optimizer state, no shard map) loads into an offload engine
        # (tests/test_torch_offload.py holds them against JAX's).
        off = {"zero_optimization": {"stage": 2, "cpu_offload": True}}
        src = _port_engine("fp32", extra=off)
        tag = _saved_tag(tmp_path, src)
        assert "optim_shards" not in json.loads(
            (tag / "engine_meta.json").read_text())
        eng = _port_engine("fp32", seed=7, extra=off)
        path, _ = eng.load_checkpoint(str(tmp_path))
        assert path is not None and eng.global_steps == 1
        for a, b in zip(eng._offload.masters, src._offload.masters):
            assert torch.equal(a, b)
        return
    if meta.get("mp_shards"):
        # Tensor-parallel tags are ported: JAX's mp_rank files (a split
        # leaf's contiguous slices, the others whole in shard 0) load,
        # assembled, into an engine at any model-parallel size (across
        # ranks: tests/test_torch_tp_checkpoint.py holds them against
        # JAX's files). Here the port's tag is rewritten as two shards,
        # wte split by rows.
        src = _port_engine("fp32")
        tag = _saved_tag(tmp_path, src)
        model = tag / "mp_rank_00_model_states.msgpack"
        leaves = tree_flatten(fm.msgpack_restore(model.read_bytes())
                              ["module"])[0]
        axes = [0 if x.shape == (512, 128) else None for x in leaves]
        for r in range(2):
            blob = {str(i): (x[r * 256:(r + 1) * 256] if ax == 0 else x)
                    for i, (x, ax) in enumerate(zip(leaves, axes))
                    if ax == 0 or r == 0}
            (tag / f"mp_rank_{r:02d}_model_states.msgpack").write_bytes(
                fm.msgpack_serialize(blob))
        _edit_meta(tag, mp_shards=2, param_shard_axes=axes)
        eng = _port_engine("fp32", seed=7)
        path, _ = eng.load_checkpoint(str(tmp_path))
        assert path is not None and eng.global_steps == 1
        for a, b in zip(tree_flatten(eng.state.params)[0],
                        tree_flatten(src.state.params)[0]):
            assert torch.equal(a, b)
        return
    tag = _saved_tag(tmp_path)
    _edit_meta(tag, **meta)
    eng = _port_engine("fp32", seed=7)
    with pytest.raises(NotImplementedError, match=match):
        eng.load_checkpoint(str(tmp_path))
    assert eng.global_steps == 0


def test_module_strict_and_lenient(tmp_path):
    tag = _saved_tag(tmp_path)
    model = tag / "mp_rank_00_model_states.msgpack"
    tree = fm.msgpack_restore(model.read_bytes())
    del tree["module"]["ln_f_bias"]
    model.write_bytes(fm.msgpack_serialize(tree))
    eng = _port_engine("fp32", seed=7)
    keep = eng.state.params["ln_f_bias"].clone()
    with pytest.raises(ValueError, match="ln_f_bias: missing"):
        eng.load_checkpoint(str(tmp_path))
    assert eng.global_steps == 0
    path, _ = eng.load_checkpoint(str(tmp_path), load_module_strict=False)
    assert path is not None
    assert torch.equal(eng.state.params["ln_f_bias"], keep)
    np.testing.assert_array_equal(eng.state.params["wte"].detach().numpy(),
                                  tree["module"]["wte"])


def test_lr_scheduler_state_loads_unless_asked_not_to(tmp_path):
    _saved_tag(tmp_path)
    eng = _port_engine("fp32", seed=7)
    eng.load_checkpoint(str(tmp_path), load_lr_scheduler_states=False)
    assert eng.lr_scheduler.last_batch_iteration == -1
    eng.load_checkpoint(str(tmp_path))
    assert eng.lr_scheduler.state_dict() == {"last_batch_iteration": 0}


# --------------------------------------------------------------------- #
# Crash matrix: a real SIGKILL at each protocol offset
# --------------------------------------------------------------------- #
# The child commits the GOOD tag's files, then arms the crash point and
# commits the BAD tag's, the async route for after_snapshot as the
# engine takes it; it builds no model.
CHILD = """
import os, sys
sys.path.insert(0, {repo!r})
from deepspeed_tpu_torch.runtime.async_ckpt import (AsyncCheckpointer,
    CheckpointSnapshot, commit_snapshot, crash_point)
d, src = {ckdir!r}, {src!r}

def snap(tag):
    blobs = [(fn, open(os.path.join(src, tag, fn), "rb").read())
             for fn in sorted(os.listdir(os.path.join(src, tag)))
             if fn != "engine_meta.json"]
    import json
    meta = json.load(open(os.path.join(src, tag, "engine_meta.json")))
    return CheckpointSnapshot(save_dir=d, tag=tag, save_latest=True,
                              meta=meta, blobs=blobs)

commit_snapshot(snap("good"))
open(os.path.join(d, "GOOD_DONE"), "w").write("1")
os.environ["DS_CKPT_CRASH_POINT"] = {point!r}
if {point!r} == "after_snapshot":
    ck = AsyncCheckpointer(writer_timeout_s=30)
    s = snap("bad")
    crash_point("after_snapshot")
    ck.submit(s)
    ck.wait(timeout=30)
else:
    commit_snapshot(snap("bad"))
print("SURVIVED_THE_CRASH_POINT")
"""


@pytest.fixture(scope="module")
def crash_sources(tmp_path_factory):
    """The files of two real port tags (steps 2 and 3) for the child to
    commit."""
    src = tmp_path_factory.mktemp("crash_src")
    eng = _port_engine("fp32")
    batches = _batches(3)
    for b in batches[:2]:
        eng.train_batch(b)
    eng.save_checkpoint(str(src), tag="good", save_latest=False)
    eng.train_batch(batches[2])
    eng.save_checkpoint(str(src), tag="bad", save_latest=False)
    return str(src)


@pytest.mark.parametrize("point, expected_steps", [
    ("after_snapshot", {2}),     # the snapshot is lost, nothing written
    ("mid_blob_write", {2}),     # half a blob in bad's tmp dir
    ("pre_seal", {2}),           # every blob, no seal
    ("pre_commit", {2}),         # sealed tmp dir, not renamed
    ("pre_latest", {2}),         # bad renamed, latest not flipped
    ("mid_latest", {2, 3}),      # latest's tmp file written, not replaced
])
def test_kill_at_protocol_offset_leaves_latest_loadable(
        tmp_path, crash_sources, point, expected_steps):
    assert point in async_ckpt.CRASH_POINTS
    ckdir = str(tmp_path)
    p = subprocess.run(
        [sys.executable, "-c", CHILD.format(repo=REPO, ckdir=ckdir,
                                            src=crash_sources,
                                            point=point)],
        capture_output=True, text=True, timeout=120)
    assert p.returncode == -signal.SIGKILL, (p.returncode, p.stderr[-2000:])
    assert "SURVIVED_THE_CRASH_POINT" not in p.stdout
    assert os.path.exists(os.path.join(ckdir, "GOOD_DONE"))
    assert is_complete(os.path.join(ckdir, "good"))
    eng = _port_engine("fp32", seed=9)
    path, _ = eng.load_checkpoint(ckdir)
    assert path is not None, f"latest unloadable after a kill at {point}"
    assert eng.global_steps in expected_steps, (point, eng.global_steps)
    assert np.isfinite(float(eng.train_batch(_batches(1, seed=7)[0])))


# --------------------------------------------------------------------- #
# The checkpoint block
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("block", [
    {},
    {"async": True, "snapshot_every": 50, "save_dir": "/tmp/ck",
     "preempt_save": False, "max_pending_snapshots": 2,
     "writer_timeout_s": 10.5, "fsync": True},
    {"tag_validation": "fail"},
    {"tag_validation": "Ignore", "snapshot_every": 0, "save_dir": ""},
])
def test_checkpoint_block_parses_as_jax(block):
    ds = {"train_batch_size": 8, "checkpoint": block}
    t, j = tconfig.DeepSpeedConfig(ds), jconfig.DeepSpeedConfig(ds)
    names = ("async_save", "snapshot_every", "save_dir", "preempt_save",
             "max_pending_snapshots", "writer_timeout_s", "fsync")
    assert {n: getattr(t.checkpoint_config, n) for n in names} == \
        {n: getattr(j.checkpoint_config, n) for n in names}
    for n in ("checkpoint_tag_validation_mode",
              "checkpoint_tag_validation_enabled",
              "checkpoint_tag_validation_fail"):
        assert getattr(t, n) == getattr(j, n)


@pytest.mark.parametrize("bad", [
    {"async": "yes"},
    {"snapshot_every": -1},
    {"snapshot_every": 10},               # > 0 without save_dir
    {"save_dir": 3},
    {"max_pending_snapshots": 0, "save_dir": "/tmp/x"},
    {"max_pending_snapshots": True},
    {"writer_timeout_s": 0},
    {"preempt_save": "no"},
    {"fsync": 1},
])
def test_checkpoint_block_rejects_as_jax(bad):
    ds = {"train_batch_size": 8, "checkpoint": bad}
    with pytest.raises(jconfig.DeepSpeedConfigError) as je:
        jconfig.DeepSpeedConfig(ds)
    with pytest.raises(tconfig.DeepSpeedConfigError) as te:
        tconfig.DeepSpeedConfig(ds)
    assert str(te.value) == str(je.value)


def test_lr_schedule_state_dict_matches_jax():
    from deepspeed_tpu.runtime import lr_schedules as jlr
    from deepspeed_tpu_torch.runtime import lr_schedules as tlr
    params = {"warmup_num_steps": 3, "warmup_max_lr": 1e-4}
    t, j = (m.get_lr_schedule("WarmupLR", params) for m in (tlr, jlr))
    for s in (t, j):
        s.step(4)
    assert t.state_dict() == j.state_dict() == {"last_batch_iteration": 4}
    t.load_state_dict({"last_batch_iteration": 9})
    assert t.last_batch_iteration == 9


# --------------------------------------------------------------------- #
# Serving from a training checkpoint
# --------------------------------------------------------------------- #
INF = {"max_slots": 4, "max_seq_len": 64, "prefill_chunk": 8,
       "block_size": 8}


def _drive(eng):
    """Prefill two slots, then five decode steps: the logits and the
    greedy tokens of each step."""
    logits, toks = [], []
    for s, n in ((0, 11), (1, 17)):
        prompt = np.random.default_rng(s).integers(0, 512, n).astype(
            np.int32)
        tok, lg = eng.prefill(prompt, slot=s, return_logits=True)
        eng.activate_slot(s, n, tok)
        logits.append(np.asarray(lg))
        toks.append(int(tok))
    for _ in range(5):
        tok, lg = eng.decode_once(return_logits=True)
        logits.append(np.asarray(lg)[:2])
        toks.append([int(t) for t in np.asarray(tok)[:2]])
    return logits, toks


def test_serving_from_a_jax_training_checkpoint(tmp_path):
    """A JAX fp32 training tag (weights scaled up so greedy streams vary
    token to token) served by both packages' from_train_checkpoint."""
    params = _params_np(seed=3)
    for name in list(params["blocks"]):
        if name.endswith("_kernel"):
            params["blocks"][name] = params["blocks"][name] * 6
    params["wte"], params["wpe"] = params["wte"] * 6, params["wpe"] * 6
    jeng = _jax_engine("fp32", params)
    jeng.train_batch(_batches(1)[0])
    jeng.save_checkpoint(str(tmp_path))
    jcfg = dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"],
                               dtype=torch.float32)
    js = JEngine.from_train_checkpoint(
        str(tmp_path), jcfg, config={"inference": dict(INF,
                                                       paged_kernel=False)},
        mesh=build_mesh(devices=jax.devices()[:1]))
    want_logits, want_toks = _drive(js)
    js.close()
    ts = TEngine.from_train_checkpoint(str(tmp_path), tcfg,
                                       config={"inference": INF},
                                       device="cpu")
    got_logits, got_toks = _drive(ts)
    assert got_toks == want_toks
    assert len(set(str(t) for t in want_toks)) > 2
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    # The tag named explicitly; a shape that does not fit the model.
    assert TEngine.from_train_checkpoint(
        str(tmp_path), tcfg, config={"inference": INF}, tag="global_step1",
        device="cpu") is not None
    wide = dataclasses.replace(tcfg, hidden_size=64)
    with pytest.raises(ValueError, match="shape"):
        TEngine.from_train_checkpoint(str(tmp_path), wide,
                                      config={"inference": INF},
                                      device="cpu")


def test_serving_refuses_tp_sharded_tags(tmp_path):
    tag = tmp_path / "t"
    tag.mkdir()
    (tag / "mp_rank_01_model_states.msgpack").write_bytes(b"")
    (tmp_path / "latest").write_text("t")
    with pytest.raises(NotImplementedError, match="TP-sharded"):
        TEngine.from_train_checkpoint(
            str(tmp_path), dataclasses.replace(
                tgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32),
            device="cpu")
    with pytest.raises(FileNotFoundError):
        TEngine.from_train_checkpoint(str(tmp_path / "none"),
                                      tgpt2.GPT2_CONFIGS["gpt2-tiny"],
                                      device="cpu")
