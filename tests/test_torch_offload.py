"""The port's ZeRO-Offload (``runtime/zero/offload.py`` and the engine's
offload path) against the JAX package's, on the CPU.

- ``_partition_axis`` and ``_partition_buckets`` give JAX's answers.
- ``ZeroOffloadOptimizer`` against JAX's at the host step, on the same
  numpy masters and grads (3 steps, buckets of a few leaves): the same
  buckets, the same metrics (the vote, the grad norm, the clip
  coefficient, the lr), bit-equal masters, moments and compute-dtype
  copy; an inf in the last bucket skips the step on both sides with the
  same loss-scale sequence and no master or moment changed. The JAX
  optimizer's norm is its module's numpy path, called directly: the
  port's norm sums in numpy's order on any host, while the JAX
  library's vectorized sum differs in its last bits between hosts of
  other SIMD widths (``tests/test_torch_cpu_adam.py``), which decides
  the clip coefficient and the overflow vote.
- The engine with ``cpu_offload`` (stage 2) against the JAX offload
  engine on gpt2-tiny, the same converted weights, dropout 0, gas 2, 5
  steps: losses within 1e-5 relative and final masters within 1e-5 (fp32),
  1e-3 with equal skip and scale sequences (fp16), 1e-2 (bf16).
- Serial against overlapped at the host step, on leaves wide enough for
  OpenMP teams of several threads: bit-equal metrics, masters, moments
  and copies over 3 steps, the norms on the same team in both modes.
- Serial against overlapped (``overlap_comm``), with buckets of a few
  leaves (at least 3): bit-equal losses, masters, moments and device
  params over 4 steps, at gas 1 and 2, bf16 and fp32 wires; and an inf
  poisoned into the last leaf mid-run (through ``_offload_grads``) skips
  the step on both, halves the scale once and leaves every bucket's
  masters and moments untouched, then both go on bit-equal.
- Checkpoints: tests/test_torch_offload_checkpoint.py (the helpers
  below serve both files).
- ``examples/gpt2/ds_config_offload.json`` (read from the file) builds
  an offload engine that trains; ``overlap_comm`` selects the overlapped
  pipeline; ``offload_timings`` carries the JAX keys; master-free bf16
  with offload raises JAX's ``ValueError``; stage 0 ignores
  ``cpu_offload`` as JAX does; stage 3 with offload configures at any
  dp (at dp 1 it is stage 2).

The JAX engines run on a one-device mesh with dense attention and
``fused_kernels=False`` (the JAX package documents both settings as the
same arithmetic; tests/test_torch_training.py holds its kernels).
"""
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime.zero import offload as joff
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import cpu_adam as tca
from deepspeed_tpu_torch.ops.fused_update import tree_flatten
from deepspeed_tpu_torch.runtime.zero import offload as toff
from torch_jax_native import jax_native  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = {"fp32": 1e-5, "fp16": 1e-3, "bf16": 1e-2}
PRECISIONS = {"fp32": (torch.float32, jnp.float32),
              "fp16": (torch.float16, jnp.float16),
              "bf16": (torch.bfloat16, jnp.bfloat16)}
# A bucket of a few gpt2-tiny leaves (its largest leaf is 256 KiB).
SMALL_BUCKET = 64 * 1024


@pytest.fixture(scope="module", autouse=True)
def team_of_one():
    """The main thread's OpenMP team is one thread: the norms' sums are
    deterministic on the JAX side too, and the JAX library's calls on
    gpt2-tiny's small leaves do not wake a team under parallel test
    workers (the two libraries share the process's OpenMP runtime).
    Module-scoped, so that it also holds in the module-scoped fixtures
    that train (tests/test_torch_offload_checkpoint.py): an autouse
    fixture of a scope is set up before the others of that scope."""
    lib = tca.native_lib()
    prev = int(lib.ds_omp_max_threads())
    lib.ds_omp_set_threads(1)
    yield
    lib.ds_omp_set_threads(prev)


def _cfgs(precision):
    tdt, jdt = PRECISIONS[precision]
    d = dict(hidden_dropout=0.0, attn_dropout=0.0)
    return (dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=tdt,
                                **d),
            dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=jdt,
                                fused_kernels=False, **d))


def _ds(precision, zero=None, extra=None, gas=2):
    ds = {"train_batch_size": 2 * gas, "gradient_accumulation_steps": gas,
          "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
          "zero_optimization": dict({"stage": 2, "cpu_offload": True},
                                    **(zero or {})),
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-4, "weight_decay": 0.01}},
          "scheduler": {"type": "WarmupLR", "params": {
              "warmup_num_steps": 3, "warmup_max_lr": 1e-4}}}
    if precision == "fp16":
        ds["fp16"] = {"enabled": True, "initial_scale_power": 19}
    if precision == "bf16":
        ds["bf16"] = {"enabled": True}
    ds.update(extra or {})
    return ds


def _batches(n, rows=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (rows, 33)).astype(np.int32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def params_np():
    return jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0),
                                    _cfgs("fp32")[1]))


def _jax_engine(precision, params_np, ds=None):
    _, jcfg = _cfgs(precision)
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params_np),
        config=ds or _ds(precision),
        mesh=build_mesh(devices=jax.devices()[:1]))
    return eng


def _port_engine(precision, params_np, ds=None, rng=0):
    tcfg, _ = _cfgs(precision)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg),
        model_params=convert.from_jax_params(params_np),
        config=ds or _ds(precision), device="cpu", rng=rng)
    return eng


def _step(eng, batch):
    """(loss, the loss scale after the step, skipped steps)."""
    loss = float(eng.train_batch(batch))
    return loss, eng.loss_scale(), int(eng.skipped_steps)


def _check_hist(got, want, precision):
    np.testing.assert_allclose([h[0] for h in got], [h[0] for h in want],
                               rtol=RTOL[precision])
    assert [h[1:] for h in got] == [h[1:] for h in want]


# --------------------------------------------------------------------- #
# The host step
# --------------------------------------------------------------------- #
def test_partition_axis_and_buckets_match_jax():
    shapes = [(8, 3), (3, 8), (5, 7), (2, 4, 6), (16,), (1, 12)]
    for num in (1, 2, 3, 4, 8):
        for s in shapes:
            assert toff._partition_axis(s, num) == \
                joff._partition_axis(s, num)
    sizes = [100, 40, 300, 20, 20, 500, 8]
    for bucket in (1, 64, 150, 400, 10 ** 6):
        assert toff._partition_buckets(sizes, bucket) == \
            joff._partition_buckets(sizes, bucket)


HOST_CASES = {  # name: (compute dtype, clip, fp16, poison the last leaf)
    "fp32": ("fp32", 0.0, False, False),
    "fp32_clip": ("fp32", 0.05, False, False),
    "bf16_clip": ("bf16", 0.05, False, False),
    "fp16_overflow": ("fp16", 1.0, True, True),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_step_matches_jax(case):
    prec, clip, fp16, poison = HOST_CASES[case]
    tdt, jdt = PRECISIONS[prec]
    rng = np.random.default_rng(11)
    tree = {"a": rng.standard_normal((24, 16)).astype(np.float32),
            "b": {"c": rng.standard_normal((40,)).astype(np.float32),
                  "d": rng.standard_normal((8, 8, 4)).astype(np.float32)},
            "e": rng.standard_normal((300,)).astype(np.float32)}
    kw = dict(gradient_clipping=clip, fp16=fp16,
              scaler_cfg=dict(init_scale=2.0 ** 10, static=False,
                              scale_window=2, min_scale=1.0, hysteresis=1),
              bucket_bytes=1024, host_threads=2)
    sched = lambda step: 1e-2 / (1 + step)  # noqa: E731
    opt_params = {"lr": 1e-2, "weight_decay": 0.01}
    jo = joff.ZeroOffloadOptimizer(
        jax.tree_util.tree_map(np.copy, tree), "AdamW", opt_params, sched,
        jdt, **kw)
    # (the masters' bits are the native step's: tests/torch_jax_native.py)
    assert jo.opt.native
    numpy_path = types.SimpleNamespace(_lib=None)
    jo.opt.grad_norm_sq = lambda leaves, scale=1.0: \
        type(jo.opt).grad_norm_sq(numpy_path, leaves, scale)
    to = toff.ZeroOffloadOptimizer(
        convert.from_jax_params(tree), "AdamW", opt_params, sched, tdt,
        **kw)
    assert to.buckets == jo.buckets and len(to.buckets) >= 3
    for k in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32) * 30,
            tree)
        if poison and k == 1:
            grads["e"][-1] = np.inf
        before = [m.clone() for m in to.masters + to.opt.exp_avg]
        jm = jo.host_step(jax.tree_util.tree_map(np.copy, grads))
        tm = to.host_step(convert.from_jax_params(grads))
        assert tm == jm, (k, tm, jm)
        if tm["overflow"]:
            for a, b in zip(before, to.masters + to.opt.exp_avg):
                assert torch.equal(a, b)
        for a, b in zip(jo.masters + jo.opt.exp_avg + jo.opt.exp_avg_sq,
                        to.masters + to.opt.exp_avg + to.opt.exp_avg_sq):
            np.testing.assert_array_equal(b.numpy(), a)
        for a, b in zip(jo.local_param_leaves(), to.staging):
            a = np.asarray(a)
            if prec == "bf16":
                np.testing.assert_array_equal(
                    b.view(torch.int16).numpy(), a.view(np.int16))
            else:
                np.testing.assert_array_equal(b.float().numpy(),
                                              a.astype(np.float32))
        assert (to.loss_scale, to.skipped_steps, to.step_count) == \
            (jo.loss_scale, jo.skipped_steps, jo.step_count)
    if clip:
        assert tm["clip_coeff"] < 1.0
    if poison:
        assert to.skipped_steps == 1


# --------------------------------------------------------------------- #
# The engine against JAX's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_engine_matches_jax_offload_engine(precision, params_np):
    batches = _batches(5)
    jeng = _jax_engine(precision, params_np)
    teng = _port_engine(precision, params_np)
    assert teng._offload is not None and jeng._offload is not None
    assert teng._offload.buckets == jeng._offload.buckets
    jh = [_step(jeng, b) for b in batches]
    th = [_step(teng, b) for b in batches]
    _check_hist(th, jh, precision)
    if precision == "fp16":
        assert 0 < th[-1][2] < len(batches), th
    atol = {"fp32": 1e-5, "fp16": 1e-3, "bf16": 1e-2}[precision]
    for a, b in zip(jeng._offload.masters, teng._offload.masters):
        np.testing.assert_allclose(b.numpy(), a, atol=atol)
    # The card holds no optimizer state; its params are the staging copy.
    assert teng.state.opt_state is None and not teng._groups
    for pv, st in zip(tree_flatten(teng.state.params)[0],
                      teng._offload.staging):
        assert torch.equal(pv, st)


# --------------------------------------------------------------------- #
# Serial against overlapped
# --------------------------------------------------------------------- #
def _flat_host(eng):
    off = eng._offload
    return [t.clone() for t in off.masters + off.opt.exp_avg +
            off.opt.exp_avg_sq] + [t.detach().clone() for t in
                                   tree_flatten(eng.state.params)[0]]


def _assert_bit_equal(a, b):
    for x, y in zip(_flat_host(a), _flat_host(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("host_threads", [0, 2])
def test_overlap_matches_serial_on_wide_teams(host_threads):
    """Four leaves of 4 * MIN_PER_THREAD elements, a bucket each, fp32
    grads (a bf16 wire's squares sum exactly in fp64 in any order) with
    clipping: the norms take ``cores // host_threads`` threads in both
    modes and Adam every core when serial."""
    n = 4 * tca.MIN_PER_THREAD
    rng = np.random.default_rng(21)
    tree = {k: rng.standard_normal(n).astype(np.float32) for k in "abcd"}
    offs = [toff.ZeroOffloadOptimizer(
        convert.from_jax_params(tree), "AdamW", {"lr": 1e-2},
        lambda step: 1e-2, torch.float32, gradient_clipping=1.0,
        bucket_bytes=4 * n, host_threads=host_threads) for _ in range(2)]
    ser, ovl = offs
    assert ser.num_buckets() == 4
    team = max(1, tca.default_threads() // (host_threads or 1))
    assert ser.norm_threads == team and ser.adam_threads[False] == \
        tca.default_threads()
    for k in range(3):
        grads = [torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)) for _ in tree]
        fetch = lambda b: [grads[b]]  # noqa: E731
        ms, ts = toff.run_bucketed_step(ser, fetch, overlap=False)
        mo, to_ = toff.run_bucketed_step(ovl, fetch, overlap=True)
        assert ms == mo and ms["clip_coeff"] < 1.0, (k, ms, mo)
        assert ts["omp_threads"]["norm"] == to_["omp_threads"]["norm"] == \
            team
        for a, b in zip(ser.masters + ser.opt.exp_avg + ser.opt.exp_avg_sq,
                        ovl.masters + ovl.opt.exp_avg + ovl.opt.exp_avg_sq):
            assert torch.equal(a, b), k
        assert torch.equal(ser.staging_flat, ovl.staging_flat)


@pytest.mark.parametrize("gas", [1, 2])
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_overlap_matches_serial_bit_exact(precision, gas, params_np):
    engs = [_port_engine(precision, params_np, _ds(
        precision, {"overlap_comm": ov, "offload_bucket_size": SMALL_BUCKET,
                    "offload_host_threads": 4}, gas=gas))
        for ov in (False, True)]
    ser, ovl = engs
    assert ovl._offload_overlap and not ser._offload_overlap
    assert ovl._offload.num_buckets() >= 3
    for i, b in enumerate(_batches(4, rows=2 * gas, seed=3)):
        assert float(ser.train_batch(b)) == float(ovl.train_batch(b)), i
    _assert_bit_equal(ser, ovl)
    t = ovl.offload_timings
    assert t["overlapped"] and t["num_buckets"] == ovl._offload.num_buckets()
    for key in ("d2h_ms", "norm_ms", "adam_ms", "h2d_ms"):
        assert len(t["per_bucket"][key]) == t["num_buckets"]
    assert 0.0 <= t["overlap_fraction"] < 1.0
    for key in ("d2h_ms", "host_norm_ms", "host_step_ms", "h2d_dispatch_ms",
                "pipeline_span_ms", "overlap_fraction", "num_buckets",
                "device_step_ms", "h2d_wait_ms", "wall_ms"):
        assert key in t and key in ser.offload_timings
    assert ser.offload_timings["overlap_fraction"] == 0.0


def test_overlap_fp16_overflow_mid_pipeline_parity(params_np):
    zero = {"offload_bucket_size": SMALL_BUCKET, "offload_host_threads": 4}
    extra = {"fp16": {"enabled": True, "initial_scale_power": 8,
                      "hysteresis": 1, "loss_scale_window": 4}}
    ser = _port_engine("fp16", params_np, _ds("fp16", zero, extra))
    ovl = _port_engine("fp16", params_np,
                       _ds("fp16", dict(zero, overlap_comm=True), extra))
    batches = _batches(4, seed=4)
    for eng in (ser, ovl):
        eng.train_batch(batches[0])
        orig = eng._offload_grads

        def poisoned(mb, step, _orig=orig, _eng=eng):
            out = _orig(mb, step)
            # the last leaf: the last bucket, whose norm lands last
            _eng._local_grad_views[-1].fill_(float("inf"))
            return out
        eng._offload_grads = poisoned
    before = _flat_host(ovl)
    scale = ovl.loss_scale()
    ser.train_batch(batches[1])
    ovl.train_batch(batches[1])
    assert ser.skipped_steps == ovl.skipped_steps == 1
    assert ovl.loss_scale() == ser.loss_scale() == scale / 2
    for x, y in zip(before, _flat_host(ovl)):
        assert torch.equal(x, y)
    for eng in (ser, ovl):
        del eng._offload_grads
    for b in batches[2:]:
        assert float(ser.train_batch(b)) == float(ovl.train_batch(b))
    _assert_bit_equal(ser, ovl)


# --------------------------------------------------------------------- #
# Configuration
# --------------------------------------------------------------------- #
def test_example_offload_config_trains(params_np):
    """The repo's example config, read from its file: bf16, stage 2,
    ``cpu_offload``, AdamW 3e-3, clip 1.0, train_batch_size 8."""
    path = os.path.join(REPO, "examples", "gpt2", "ds_config_offload.json")
    tcfg, _ = _cfgs("bf16")
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg),
        model_params=convert.from_jax_params(params_np), config=path,
        device="cpu")
    assert eng._offload is not None and not eng._offload_overlap
    assert eng.zero_optimization_stage() == 2
    losses = [float(eng.train_batch(b)) for b in _batches(2, rows=8)]
    assert all(np.isfinite(losses)) and eng._offload.step_count == 2
    with open(path) as f:
        ds = json.load(f)
    ds["zero_optimization"]["overlap_comm"] = True
    ds["steps_per_print"] = 10 ** 9
    ovl, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg),
        model_params=convert.from_jax_params(params_np), config=ds,
        device="cpu")
    ovl.train_batch(_batches(1, rows=8)[0])
    assert ovl._offload_overlap and ovl.offload_timings["overlapped"]


def test_master_free_with_offload_raises_as_jax(params_np):
    extra = {"bf16": {"enabled": True, "stochastic_rounding": True}}
    with pytest.raises(ValueError, match="master-free"):
        _jax_engine("bf16", params_np, _ds("bf16", extra=extra))
    with pytest.raises(ValueError, match="master-free"):
        _port_engine("bf16", params_np, _ds("bf16", extra=extra))


def test_offload_optimizer_names_as_jax(params_np):
    ds = _ds("fp32", extra={"optimizer": {"type": "Adam",
                                          "params": {"lr": 1e-3}}})
    assert not _port_engine("fp32", params_np, ds)._offload.opt.adamw_mode
    with pytest.raises(ValueError, match="supports"):
        toff.ZeroOffloadOptimizer({"a": torch.zeros(3)}, "Lamb", {},
                                  lambda s: 1e-3, torch.float32)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_stage3_offload_at_dp_raises(world):
    """Stage 3 with offload: at dp 1 it is stage 2's offload; above, it
    is ported (the card holds each leaf's shard along the host
    partition's axis; tests/test_torch_zero3_offload.py trains it), so
    the config names no unported feature at any dp."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    names = [f for f, _ in DeepSpeedConfig(
        {"train_batch_size": 8 * world,
         "zero_optimization": {"stage": 3, "cpu_offload": True}},
        world_size=world).unported_features()]
    assert names == []
    for stage in (1, 2):
        assert DeepSpeedConfig(
            {"train_batch_size": 8 * world,
             "zero_optimization": {"stage": stage, "cpu_offload": True}},
            world_size=world).unported_features() == []


def test_stage0_ignores_cpu_offload_as_jax(params_np):
    ds = _ds("fp32", {"stage": 0})
    assert _jax_engine("fp32", params_np, ds)._offload is None
    eng = _port_engine("fp32", params_np, ds)
    assert eng._offload is None and eng.state.opt_state is not None
