"""ZeRO at a dp that does not divide V = 8 (dp 3, 5, 6, 7), against the
JAX engine at the same dp.

JAX keeps V = max(8, dp) and places the fused optimizer's flat
``[V * Lpad]`` buffers by ``_leaf_spec``: split in dp equal parts when
dp divides the length, else replicated. The port's ``row_plan`` /
``ShardGroup`` give each rank exactly that range (``ranged``), or the
whole buffer (``replicated``).

- The plan's range is JAX's device placement, for dp 3, 5, 6 and 7 and
  group lengths that dp does and does not divide; K6's noise index of a
  rank's elements starts at the range's first element, JAX's index of
  it (the JAX kernel runs the whole buffer there).
- gloo worlds of 3 (ZeRO 1, 2, 3) and 6 (ZeRO 2) train gpt2-tiny 3 fp32
  steps within 1e-5 of JAX's engine at the same dp (its ZeRO 2 run),
  with vocabulary 512 (gpt2-tiny's group: 8 row quanta, replicated at
  dp 3) and 1024 (9 quanta: split in parts at dp 3 and 6); every rank
  holds the same parameters;
- master-free bf16 at dp 3 (split groups): losses within the bf16
  class's 1e-2 of JAX's, the ranks bit-equal;
- a dp-3 save resumes in JAX at dp 3 (its third step as the port's
  uninterrupted one) and at port dp 2 as at JAX dp 2, within 1e-5;
- the pipeline at pp 2 x dp 3 (ZeRO 1, 1F1B, gpt2-tiny with 4 layers:
  tests/test_torch_pipe.py's case ``pp23_1f1b``, in this file's world
  of 6), where every stage group is replicated: 3 steps as JAX's
  ``PipelineEngine``, and its save after step 2 (the whole tree's
  moments gathered from replicated groups) resumed in JAX and in the
  port as the uninterrupted step 3.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.ops import fused_update as jfu
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime.zero import partition as jpart

import torch_dp_worker as W
from deepspeed_tpu_torch.ops import fused_update as tfu
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.zero import partition as tpart
from test_torch_dp import load, save_params, wait
from test_torch_pipe import (check_matches_jax, check_tied_shared_bit_equal,
                             jax_pipe, jcfg, make_batches)
from test_torch_pipe import job as pipe_job

STEPS = 3
JDT = {"fp32": jnp.float32, "master_free": jnp.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's torch ops on one thread: gpt2-tiny's ops are small,
    and under parallel test workers an intra-op team waits for cores the
    other workers' processes hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dp", [3, 5, 6, 7])
@pytest.mark.parametrize("quanta", [8, 9, 15, 105])
def test_plan_is_jax_placement(dp, quanta):
    Lpad = quanta * 8192
    n = 8 * Lpad
    mesh = build_mesh(devices=jax.devices()[:dp])
    sh = NamedSharding(mesh, jpart._leaf_spec((n,), dp, "data"))
    slices = [idx[0] for idx in sh.devices_indices_map((n,)).values()]
    for d in range(dp):
        plan = tpart.row_plan(dp, d)
        assert not plan.rows
        lo, hi = plan.elements(Lpad)
        assert (slices[d].start or 0, slices[d].stop or n) == (lo, hi)
        sg = tfu.ShardGroup([(8 * Lpad,)], torch.float32,
                            torch.device("cpu"), plan)
        assert sg.Lpad == Lpad and sg.base == lo and sg.numel == hi - lo
        assert sg.replicated == (n % dp != 0)


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_ranged_rows_pack_and_noise_are_jax(rank):
    """A dp-3 rank's part of a group of 9 quanta (split in 3): its
    values are the flat buffer's range, and K6's stochastic rounding of
    them draws JAX's noise at every element (index = place in the whole
    buffer, as the JAX kernel runs it there)."""
    rng = np.random.default_rng(rank)
    shapes = [(8192 * 8 * 8,), (1000,), (3, 7)]
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in shapes]
    sg = tfu.ShardGroup(shapes, torch.float32, torch.device("cpu"),
                        tpart.row_plan(3, rank))
    assert sg.ranged and not sg.replicated and sg.Lpad == 9 * 8192
    full = torch.empty(sg.full_numel)
    sg.pack(leaves, full, rows=(0, 8))
    mine = torch.empty(sg.numel)
    sg.pack(leaves, mine)
    lo, hi = sg.elements
    assert torch.equal(mine, full[lo:hi])
    seed = np.int32(-98765)
    row = torch.tensor([int(seed), tfu._int32(sg.base)], dtype=torch.int32)
    got = tfu.stochastic_round_indexed(mine[:4096], row)
    idx = (np.uint64(lo) + np.arange(4096, dtype=np.uint64)) & \
        np.uint64(0xFFFFFFFF)
    noise = np.asarray(jfu._hash_u32(jnp.asarray(idx.astype(np.uint32)) ^
                                     jnp.uint32(seed.view(np.uint32)))) \
        & 0xFFFF
    want = tfu.stochastic_round_bits(
        mine[:4096], torch.from_numpy(noise.astype(np.int64)))
    assert torch.equal(got, want)


def test_config_names_no_dp_up_to_8():
    for world in range(1, 9):
        c = tconfig.DeepSpeedConfig({"train_batch_size": 8 * world,
                                     "zero_optimization": {"stage": 2}},
                                    world_size=world)
        assert c.unported_features() == []
    c = tconfig.DeepSpeedConfig({"train_batch_size": 32}, world_size=16)
    assert [f for f, _ in c.unported_features()] == [
        "a dp world of 16 (above 8 JAX widens the fused optimizer's "
        "V-layout to dp, outside its own test envelope)"]


def test_lamb_refuses_a_ranged_group():
    sg = tfu.ShardGroup([(7, 5)], torch.float32, torch.device("cpu"),
                        tpart.row_plan(3, 1))
    with pytest.raises(NotImplementedError, match="does not divide"):
        topt._leaf_segments(sg)


# --------------------------------------------------------------------- #
# gloo worlds against JAX
# --------------------------------------------------------------------- #
def _jcfg(precision, vocab):
    return dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"],
                               dtype=JDT[precision], fused_kernels=False,
                               hidden_dropout=0.0, attn_dropout=0.0,
                               vocab_size=vocab)


def _params(vocab):
    return jax.tree_util.tree_map(np.asarray, jgpt2.gpt2_init(
        jax.random.PRNGKey(0), _jcfg("fp32", vocab)))


def jax_run(world, stage, vocab, batches, precision="fp32", load_dir=None,
            eng=None, keep=None):
    """JAX's losses and final parameters (flat); ``eng``: an engine of
    the same settings to take the steps (a resume reuses the compiled
    one), ``keep``: a dict the engine is left in under ``(world, stage,
    vocab, precision)``."""
    if eng is None:
        eng, *_ = deepspeed_tpu.initialize(
            model=jgpt2.gpt2_loss_fn(_jcfg(precision, vocab),
                                     attention_fn=jdense),
            model_params=jax.tree_util.tree_map(jnp.asarray,
                                                _params(vocab)),
            config=W.ds_config(precision, world, stage),
            mesh=build_mesh(devices=jax.devices()[:world]))
    if keep is not None:
        keep[(world, stage, vocab, precision)] = eng
    if load_dir:
        eng.load_checkpoint(load_dir)
    losses = [float(eng.train_batch(b)) for b in batches]
    params = np.concatenate([
        np.asarray(x, np.float32).reshape(-1) for x in
        jax.tree_util.tree_leaves(jax.device_get(eng.state.params))])
    return np.asarray(losses), params


# name: (world, stage, vocab, precision)
CASES = {
    "dp3_s1_v512": (3, 1, 512, "fp32"),
    "dp3_s2_v512": (3, 2, 512, "fp32"),
    "dp3_s3_v512": (3, 3, 512, "fp32"),
    "dp3_s1_v1024": (3, 1, 1024, "fp32"),
    "dp3_s2_v1024": (3, 2, 1024, "fp32"),
    "dp3_s3_v1024": (3, 3, 1024, "fp32"),
    "dp6_s2_v1024": (6, 2, 1024, "fp32"),
    "dp3_mf_v1024": (3, 2, 1024, "master_free"),
}
# The JAX run each case is held against (JAX's ZeRO stage does not
# change its arithmetic beyond the reduction order).
JAX_OF = {"dp3_s1_v512": "dp3_s2_v512", "dp3_s3_v512": "dp3_s2_v512",
          "dp3_s1_v1024": "dp3_s2_v1024", "dp3_s3_v1024": "dp3_s2_v1024"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dp3"))
    for v in (512, 1024):
        save_params(_params(v), os.path.join(d, f"p{v}.npz"))
    batches = {}
    for world in (3, 6):
        rng = np.random.default_rng(world)
        batches[world] = rng.integers(
            0, 512, (STEPS, W.MICRO * W.GAS * world, 33)).astype(np.int32)
        np.save(os.path.join(d, f"b{world}.npy"), batches[world])
    # (a dp-2 world resumes the dp-3 save on the same global batches)
    np.save(os.path.join(d, "b2.npy"), batches[3][:, :W.MICRO * W.GAS * 2])

    def job(case, **kw):
        world, stage, vocab, prec = CASES[case]
        return dict(dict(name=case, precision=prec, stage=stage,
                         vocab=vocab, batches=os.path.join(d, f"b{world}"
                                                           ".npy"),
                         out=os.path.join(d, case)), **kw)
    ck, pck = os.path.join(d, "ck3"), os.path.join(d, "pck23")
    # The pipeline's parameters (gpt2-tiny, 4 layers) and batches.
    pipe_p = os.path.join(d, "pipe.npz")
    save_params(jax.tree_util.tree_map(np.asarray, jgpt2.gpt2_init(
        jax.random.PRNGKey(0), jcfg())), pipe_p)
    pipe_b = make_batches(3, 34)
    np.save(os.path.join(d, "b3_4.npy"), pipe_b)
    procs = []
    for world in (3, 6):
        # (dp3_s2_v1024 saves after its second step; a job of another
        # vocabulary names its parameters)
        jobs = [job(n, params=os.path.join(d, f"p{c[2]}.npz"),
                    **({"save": {"dir": ck, "after": 2}}
                       if n == "dp3_s2_v1024" else {}))
                for n, c in CASES.items() if c[0] == world]
        if world == 6:
            jobs += [pipe_job("pp23_1f1b", d, params=pipe_p,
                              save={"dir": pck, "after": 2}),
                     pipe_job("pp23_1f1b", d, params=pipe_p, name="presume",
                              load=pck, first=2, steps=1,
                              out=os.path.join(d, "presume"))]
        procs.append(W.spawn_forked(d, world, jobs, f"w{world}",
                                    os.path.join(d, "p1024.npz")))
    procs.append(W.spawn_forked(
        d, 2, [dict(name="resume", precision="fp32", stage=2, vocab=1024,
                    first=2, steps=1, load=ck,
                    wait_for=os.path.join(ck, "latest"),
                    batches=os.path.join(d, "b2.npy"),
                    out=os.path.join(d, "resume"))],
        "r2", os.path.join(d, "p1024.npz")))
    # (the resumes in JAX at dp 3 take the steps on the engines of the
    # whole runs: no second compile)
    jax_runs, engines = {}, {}
    for name, (world, stage, vocab, prec) in CASES.items():
        if name not in JAX_OF:
            jax_runs[name] = jax_run(world, stage, vocab, batches[world],
                                     prec, keep=engines)
    jax_runs["pp23_1f1b"] = jax_pipe("pp23_1f1b", pipe_b, keep=engines)
    for p in procs:
        wait(p)
    jax_runs["resumed"] = jax_run(
        3, 2, 1024, batches[3][2:], load_dir=ck,
        eng=engines[(3, 2, 1024, "fp32")])
    jax_runs["resumed2"] = jax_run(
        2, 2, 1024, batches[3][2:, :W.MICRO * W.GAS * 2], load_dir=ck)
    jax_runs["presumed"] = jax_pipe("pp23_1f1b", pipe_b[2:], load_dir=pck,
                                    eng=engines["pp23_1f1b"])
    port = {n: load(os.path.join(d, n), CASES[n][0]) for n in CASES}
    port["resume"] = load(os.path.join(d, "resume"), 2)
    for n in ("pp23_1f1b", "presume"):
        port[n] = load(os.path.join(d, n), 6)
    return port, jax_runs


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n][3] == "fp32"])
def test_dp_not_dividing_8_matches_jax(runs, name):
    port, jax_runs = runs
    jl, jp = jax_runs[JAX_OF.get(name, name)]
    r = port[name]
    for x in r:
        np.testing.assert_array_equal(x["loss"], r[0]["loss"])
        np.testing.assert_array_equal(x["params"], r[0]["params"])
    np.testing.assert_allclose(r[0]["loss"], jl, rtol=1e-5)
    np.testing.assert_allclose(r[0]["params"], jp, atol=1e-5)


def test_master_free_at_dp3_matches_jax(runs):
    """Master-free bf16 (its noise is JAX's at every element:
    ``test_ranged_rows_pack_and_noise_are_jax``): losses within the
    bf16 class's 1e-2 of JAX's (tests/test_torch_dp_precision.py's
    rule), every rank's parameters bit-equal."""
    port, jax_runs = runs
    jl, _ = jax_runs["dp3_mf_v1024"]
    r = port["dp3_mf_v1024"]
    np.testing.assert_allclose(r[0]["loss"], jl, rtol=1e-2)
    for x in r:
        np.testing.assert_array_equal(x["params"], r[0]["params"])


def test_dp3_save_resumes_at_dp2_and_in_jax(runs):
    port, jax_runs = runs
    # (its save after step 2 of the whole run)
    whole = port["dp3_s2_v1024"][0]
    jl, jp = jax_runs["resumed"]
    np.testing.assert_allclose(jl, whole["loss"][2:], rtol=1e-5)
    np.testing.assert_allclose(jp, whole["params"], atol=1e-5)
    # port dp 2 (on a dp-2 batch) as JAX dp 2 from the same save
    r = port["resume"]
    jl2, jp2 = jax_runs["resumed2"]
    np.testing.assert_allclose(r[0]["loss"], jl2, rtol=1e-5)
    np.testing.assert_allclose(r[0]["params"], jp2, atol=1e-5)
    np.testing.assert_array_equal(r[0]["params"], r[1]["params"])


def test_pipeline_at_dp3_matches_jax(runs):
    """pp 2 x dp 3, ZeRO 1, 1F1B: JAX's losses and whole tree within
    1e-5, the ranks' losses equal, the tied leaves bit-equal on the first
    and last stage."""
    port, jax_runs = runs
    pipe_runs = {"port": port, "jax": jax_runs}
    check_matches_jax(pipe_runs, "pp23_1f1b")
    check_tied_shared_bit_equal(pipe_runs, "pp23_1f1b")


def test_pipeline_dp3_save_resumes_in_jax_and_the_port(runs):
    """Every stage group of the case is replicated at dp 3 (3 divides no
    group's flat buffer), so its save gathers each rank's whole groups;
    JAX and the port resume it as the uninterrupted step 3."""
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipe_spec
    spec = gpt2_pipe_spec(dataclasses.replace(
        tgpt2.GPT2_CONFIGS["gpt2-tiny"], num_layers=4),
        torch.Generator().manual_seed(0), device="cpu")
    for stage in range(2):
        leaves = tfu.tree_flatten(spec.stage_params(stage, 2))[0]
        for dt, idxs in tfu.float_groups(leaves):
            sg = tfu.ShardGroup([tuple(leaves[i].shape) for i in idxs], dt,
                                torch.device("cpu"), tpart.row_plan(3, 0))
            assert sg.replicated
    port, jax_runs = runs
    whole = port["pp23_1f1b"][0]
    jl, jp = jax_runs["presumed"]
    np.testing.assert_allclose(jl["loss"], whole["loss"][2:], rtol=1e-5)
    np.testing.assert_allclose(jp, whole["params"], atol=1e-5)
    r = port["presume"]
    for x in r:
        np.testing.assert_array_equal(x["loss"], r[0]["loss"])
    np.testing.assert_array_equal(r[0]["loss"], whole["loss"][2:])
    np.testing.assert_array_equal(r[0]["params"], whole["params"])
