"""The port's pipeline engine (``runtime/pipe/engine.py``) against the JAX
``PipelineEngine`` on ``build_mesh(pp=P, dp=D)``, on gpt2-tiny with 4
layers (fp32 unless named, dropout 0, gas 4 micro-batches of 2 rows a dp
rank, AdamW with clipping and WarmupLR), 3 steps.

The port runs P * D gloo processes (``tests/torch_dp_worker.py``'s
``pipe`` jobs: rank = stage * D + d, each taking its dp rank's rows of
each micro-batch as the JAX engine shards them); the JAX engine runs in
this process. Both start from JAX ``gpt2_init``'s parameters.

- pp 2 x dp 1, ``gpipe`` and ``1f1b`` (pp 2 x dp 2 and pp 4 x dp 1 in
  tests/test_torch_pipe_dp.py, on this file's harness): losses within
  1e-5 relative and the whole ``{shared, blocks}`` tree within 1e-5 of
  JAX's, and within 1e-5 of the port's own non-pipelined engine at the
  same dp; every rank reports the same losses; the tied ``shared``
  leaves of the first and last stage bit-equal after the steps;
- 1F1B without the stage remat is bit-identical to 1F1B with it;
- fp16 (``initial_scale_power`` 21): the same skip sequence and loss
  scales as JAX's;
- non-uniform cuts (``stage_layers`` [3, 1]) and a two-program
  ``hetero_pipe_spec`` (a tanh stem, then a residual ReLU layer): as
  JAX's; the hetero's zero slices stay zero;
- a pp-2 save after 2 steps resumes in JAX (its third step as the
  port's uninterrupted one), and a JAX save resumes in the port; JAX's
  tag loaded and saved again by the port is JAX's bytes;
- the compositions JAX refuses raise with its messages, the others the
  pipeline does not run with theirs.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.gpt2_pipe import gpt2_pipe_spec as jpipe_spec
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime.pipe.hetero import hetero_pipe_spec as jhetero

import deepspeed_tpu_torch
import torch_dp_worker as W
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipe_spec
from deepspeed_tpu_torch.runtime.pipe.schedule import TrainSchedule
from test_torch_dp import load, save_params, wait

STEPS, MICRO, GAS, LAYERS = 3, 2, 4, 4
JDT = {"fp32": jnp.float32, "fp16": jnp.float16}
# name: (P, D, schedule, precision, zero stage, extra pipe keys)
CASES = {
    "pp2_gpipe": (2, 1, "gpipe", "fp32", 0, {}),
    "pp2_1f1b": (2, 1, "1f1b", "fp32", 1, {}),
    "pp2_1f1b_noremat": (2, 1, "1f1b", "fp32", 1, {"remat": 0}),
    "pp2_fp16": (2, 1, "gpipe", "fp16", 0, {}),
    "pp2_cuts": (2, 1, "gpipe", "fp32", 0, {"stage_layers": [3, 1]}),
    "pp2_hetero": (2, 1, "1f1b", "fp32", 0, {"hetero": True}),
    "pp22_gpipe": (2, 2, "gpipe", "fp32", 1, {}),
    "pp22_1f1b": (2, 2, "1f1b", "fp32", 2, {}),
    "pp4_gpipe": (4, 1, "gpipe", "fp32", 0, {}),
    "pp4_1f1b": (4, 1, "1f1b", "fp32", 1, {}),
    # (in tests/test_torch_zero_dp3.py, beside the other dp-3 worlds)
    "pp23_1f1b": (2, 3, "1f1b", "fp32", 1, {}),
}
GAS_OF = {"pp4_1f1b": 8}
# (JAX's schedule without the stage remat is the same arithmetic)
JAX_OF = {"pp2_1f1b_noremat": "pp2_1f1b"}
UNIFORM = ["pp2_gpipe", "pp2_1f1b", "pp22_gpipe", "pp22_1f1b",
           "pp4_gpipe", "pp4_1f1b"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's torch ops on one thread: gpt2-tiny's ops are small,
    and under parallel test workers an intra-op team waits for cores the
    other workers' processes hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jcfg(precision="fp32"):
    return dataclasses.replace(
        jgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=JDT[precision],
        fused_kernels=False, hidden_dropout=0.0, attn_dropout=0.0,
        num_layers=LAYERS)


def ds(P, D, sched, precision, stage, remat=None, gas=GAS):
    pipe = {"schedule": sched}
    if remat is not None:
        pipe["activation_checkpoint_interval"] = remat
    return W.ds_config(precision, D, stage, None,
                       {"mesh": {"pipe_parallel_size": P},
                        "pipeline": pipe}, MICRO, gas)


def jax_hetero_parts(P):
    e, h, progs, sp, stp, sh = W.hetero_parts(P=P)
    np_ = lambda t: jnp.asarray(t.numpy())  # noqa: E731

    def stem(p, x, rng):
        return jnp.tanh(x @ p["w"] + p["b"])

    def body(p, x, rng):
        return x + jax.nn.relu(x @ p["w"])

    def embed(s, tokens, rng):
        return s["emb"][tokens[:, 0] % 64]

    def head(s, x, targets, rng):
        pred = x @ s["out"]
        return jnp.mean((pred[:, 0] - targets[:, 0].astype(jnp.float32)
                         / 64) ** 2)
    return jhetero(embed, head, [stem, body], sp,
                   [{k: np_(v) for k, v in t.items()} for t in stp],
                   shared_params={k: np_(v) for k, v in sh.items()})


def jax_pipe(name, batches, load_dir=None, save_dir=None, save_after=None,
             eng=None, keep=None):
    """JAX's run of case ``name`` on ``batches``: ``(record, whole tree
    flat)``. ``eng``: an engine of the case to take the steps (a resume
    reuses the compiled one); ``keep``: a dict the engine is left in
    under ``name``."""
    P, D, sched, prec, stage, extra = CASES[name]
    if eng is None:
        if extra.get("hetero"):
            spec = jax_hetero_parts(P)
        else:
            spec = jpipe_spec(jcfg(prec), rng=jax.random.PRNGKey(0),
                              stage_layers=extra.get("stage_layers"))
        eng, *_ = deepspeed_tpu.initialize(
            model=spec, config=ds(P, D, sched, prec, stage,
                                  extra.get("remat"), GAS_OF.get(name, GAS)),
            mesh=build_mesh(pp=P, dp=D, devices=jax.devices()[:P * D]))
    if keep is not None:
        keep[name] = eng
    if load_dir:
        eng.load_checkpoint(load_dir)
    rec = {"loss": [], "loss_scale": [], "skipped": []}
    for k, b in enumerate(batches):
        rec["loss_scale"].append(float(eng.state.loss_scale))
        rec["loss"].append(float(eng.train_batch(b)))
        rec["skipped"].append(int(eng.state.skipped_steps))
        if save_dir and k + 1 == save_after:
            eng.save_checkpoint(save_dir)
    params = np.concatenate([
        np.asarray(x, np.float32).reshape(-1)
        for x in jax.tree_util.tree_leaves(jax.device_get(eng.state.params))])
    return {k: np.asarray(v) for k, v in rec.items()}, params


def make_batches(D, seed, gas=GAS):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (STEPS, MICRO * gas * D, 33)) \
        .astype(np.int32)


def job(case, d, **kw):
    P, D, sched, prec, stage, extra = CASES[case]
    pipe = dict({"stages": P, "schedule": sched}, **extra)
    name = case
    return dict(dict(name=name, precision=prec, stage=stage, layers=LAYERS,
                     gas=GAS_OF.get(case, GAS),
                     batches=os.path.join(d, f"b{D}_{GAS_OF.get(case, GAS)}"
                                          ".npy"),
                     pipe=pipe, out=os.path.join(d, name)), **kw)


def run_pipe_cases(d, names, ckpt=False):
    """The harness of this file and tests/test_torch_pipe_dp.py: the
    port's jobs for the cases ``names`` (one gloo world a world size,
    all at once), the port's non-pipelined engine at each dp they use
    (``base{D}``), and meanwhile JAX's run of each case in this process.
    ``ckpt``: also the checkpoint crossing of ``pp2_1f1b`` (JAX saves
    after 2 steps for a port job to resume; the port saves for JAX)."""
    flat = jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0), jcfg()))
    pp = os.path.join(d, "p.npz")
    save_params(flat, pp)
    keys = {(CASES[n][1], GAS_OF.get(n, GAS)) for n in names} | \
        {(CASES[n][1], GAS) for n in names}
    batches = {}
    for D, gas in sorted(keys):
        batches[(D, gas)] = make_batches(D, 10 * D + gas, gas)
        np.save(os.path.join(d, f"b{D}_{gas}.npy"), batches[(D, gas)])
    jck = os.path.join(d, "jck")
    base = dict(precision="fp32", stage=0, layers=LAYERS, gas=GAS)
    worlds = {}
    for n in names:
        # (with ``ckpt``, pp2_1f1b saves after its second step)
        kw = {"save": {"dir": os.path.join(d, "pck"), "after": 2}} \
            if ckpt and n == "pp2_1f1b" else {}
        worlds.setdefault(CASES[n][0] * CASES[n][1], []).append(
            job(n, d, **kw))
    if ckpt:
        # JAX's tag loaded and saved again at once (JAX's files), then
        # its third step (the job waits for JAX's save: last in its
        # world)
        worlds[2].append(
            job("pp2_1f1b", d, name="resume", load=jck, first=2, steps=1,
                wait_for=os.path.join(jck, "latest"),
                save={"dir": os.path.join(d, "rck"), "after": 0},
                out=os.path.join(d, "resume")))
    dps = sorted({CASES[n][1] for n in names if not CASES[n][5]})
    for D in dps:
        worlds.setdefault(D, []).append(dict(
            base, name=f"base{D}", out=os.path.join(d, f"base{D}"),
            batches=os.path.join(d, f"b{D}_{GAS}.npy")))
    procs = [W.spawn_forked(d, w, jobs, f"w{w}", pp)
             for w, jobs in worlds.items()]
    jax_runs, engines = {}, {}
    for name in names:
        if name in JAX_OF:
            continue
        D = CASES[name][1]
        save = dict(save_dir=jck, save_after=2, keep=engines) \
            if ckpt and name == "pp2_1f1b" else {}
        jax_runs[name] = jax_pipe(name, batches[(D, GAS_OF.get(name, GAS))],
                                  **save)
    for name, twin in JAX_OF.items():
        if name in names:
            jax_runs[name] = jax_runs[twin]
    for p in procs:
        wait(p)
    out = {name: load(os.path.join(d, name), CASES[name][0] * CASES[name][1])
           for name in names}
    for D in dps:
        out[f"base{D}"] = load(os.path.join(d, f"base{D}"), D)
    res = {"port": out, "jax": jax_runs}
    if ckpt:
        out["resume"] = load(os.path.join(d, "resume"), 2)
        res["dirs"] = {"jax": os.path.join(jck, "global_step2"),
                       "resaved": os.path.join(d, "rck", "global_step2")}
        # JAX resumes the port's save (on its engine of the whole run)
        res["jax_resumed"] = jax_pipe("pp2_1f1b", batches[(1, GAS)][2:],
                                      load_dir=os.path.join(d, "pck"),
                                      eng=engines["pp2_1f1b"])
    return res


# This file: pp 2 x dp 1 (tests/test_torch_pipe_dp.py: dp 2 and pp 4).
NAMES = ["pp2_gpipe", "pp2_1f1b", "pp2_1f1b_noremat", "pp2_fp16",
         "pp2_cuts", "pp2_hetero"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_pipe_cases(str(tmp_path_factory.mktemp("pipe")), NAMES,
                          ckpt=True)


def check_matches_jax(runs, name):
    port, (jrec, jparams) = runs["port"][name], runs["jax"][name]
    for r in port:
        np.testing.assert_array_equal(r["loss"], port[0]["loss"])
    np.testing.assert_allclose(port[0]["loss"], jrec["loss"], rtol=1e-5)
    np.testing.assert_allclose(port[0]["params"], jparams, atol=1e-5)
    if CASES[name][3] == "fp16":
        np.testing.assert_array_equal(port[0]["loss_scale"],
                                      jrec["loss_scale"])
        np.testing.assert_array_equal(port[0]["skipped"], jrec["skipped"])


def check_matches_unpipelined(runs, name):
    P, D = CASES[name][:2]
    port, base = runs["port"][name], runs["port"][f"base{D}"]
    np.testing.assert_allclose(port[0]["loss"], base[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(port[0]["params"], base[0]["params"],
                               atol=1e-5)


def check_tied_shared_bit_equal(runs, name):
    P, D = CASES[name][:2]
    port = runs["port"][name]
    n_shared = 512 * 128 + 128 * 128 + 2 * 128
    first = port[0]["stage_params"][-n_shared:]
    for r in range((P - 1) * D, P * D):
        np.testing.assert_array_equal(port[r]["stage_params"][-n_shared:],
                                      first)


@pytest.mark.parametrize("name", NAMES)
def test_pipeline_matches_jax(runs, name):
    check_matches_jax(runs, name)


@pytest.mark.parametrize("name", [n for n in UNIFORM if n in NAMES])
def test_pipeline_matches_unpipelined_engine(runs, name):
    check_matches_unpipelined(runs, name)


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if not CASES[n][5].get("hetero")])
def test_tied_shared_bit_equal_on_first_and_last_stage(runs, name):
    check_tied_shared_bit_equal(runs, name)


def test_1f1b_without_stage_remat_is_bit_identical(runs):
    a, b = runs["port"]["pp2_1f1b"], runs["port"]["pp2_1f1b_noremat"]
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra["loss"], rb["loss"])
        np.testing.assert_array_equal(ra["stage_params"],
                                      rb["stage_params"])


def test_hetero_zero_slices_stay_zero(runs):
    """Stage 0's slice of the body program and stage 1's of the stem
    are zeros in JAX's layout, and stay exactly zero."""
    params = runs["port"]["pp2_hetero"][0]["params"]
    e, h, progs, sp, stp, sh = W.hetero_parts(P=2)
    # whole tree order: blocks/prog0/{b, w}, blocks/prog1/{w}, shared
    H = 16
    b0 = params[:2 * H].reshape(2, H)
    w0 = params[2 * H:2 * H + 2 * H * H].reshape(2, H, H)
    w1 = params[2 * H + 2 * H * H:2 * H + 4 * H * H].reshape(2, H, H)
    assert not b0[1].any() and not w0[1].any() and not w1[0].any()
    assert w1[1].any() and w0[0].any()


def test_checkpoints_cross_both_ways(runs):
    port = runs["port"]
    whole = port["pp2_1f1b"]
    jrec, jparams = runs["jax_resumed"]
    # the port's save at step 2 (of the whole run) resumed by JAX: its
    # step 3
    np.testing.assert_allclose(jrec["loss"], whole[0]["loss"][2:],
                               rtol=1e-5)
    np.testing.assert_allclose(jparams, whole[0]["params"], atol=1e-5)
    # JAX's save at step 2 resumed by the port
    np.testing.assert_allclose(port["resume"][0]["loss"],
                               whole[0]["loss"][2:], rtol=1e-5)
    np.testing.assert_allclose(port["resume"][0]["params"],
                               whole[0]["params"], atol=1e-5)


def test_jax_files_saved_again_are_byte_equal(runs):
    """The port loads JAX's pp-2 tag and saves it again, unchanged: the
    model file and the optimizer file are JAX's bytes."""
    jd, pd = runs["dirs"]["jax"], runs["dirs"]["resaved"]
    for f in ("mp_rank_00_model_states.msgpack",
              "zero_pp_rank_0_mp_rank_00_optim_states.msgpack"):
        with open(os.path.join(jd, f), "rb") as a, \
                open(os.path.join(pd, f), "rb") as b:
            assert a.read() == b.read(), f


# --------------------------------------------------------------------- #
# One process: what the pipeline refuses
# --------------------------------------------------------------------- #
def _spec():
    cfg = dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"], num_layers=2,
                              hidden_dropout=0.0, attn_dropout=0.0)
    return gpt2_pipe_spec(cfg, torch.Generator().manual_seed(0),
                          device="cpu")


@pytest.mark.parametrize("sched, zero, exc, match", [
    ("1f1b", {"stage": 2, "cpu_offload": True}, ValueError,
     "does not compose with zero_optimization.cpu_offload"),
    ("1f1b", {"stage": 3}, ValueError,
     "ZeRO stage 3 does not compose with pipeline grads_fn"),
    ("gpipe", {"stage": 3}, NotImplementedError, "item 7"),
    ("gpipe", {"stage": 1, "cpu_offload": True}, NotImplementedError,
     "item 7"),
])
def test_refused_compositions(sched, zero, exc, match):
    cfg = W.ds_config("fp32", 1, zero["stage"], zero,
                      {"pipeline": {"schedule": sched}}, MICRO, GAS)
    with pytest.raises(exc, match=match):
        deepspeed_tpu_torch.initialize(model=_spec(), config=cfg,
                                       device="cpu")


def test_pipeline_block_and_entry_points():
    cfg = W.ds_config("fp32", 1, 0, None, {"pipeline": {"schedule": "x"}},
                      MICRO, GAS)
    with pytest.raises(ValueError, match="'gpipe' or '1f1b'"):
        deepspeed_tpu_torch.initialize(model=_spec(), config=cfg,
                                       device="cpu")
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError
    with pytest.raises(DeepSpeedConfigError, match="must be a dict"):
        deepspeed_tpu_torch.initialize(
            model=_spec(), device="cpu",
            config=W.ds_config("fp32", 1, 0, None, {"pipeline": 2}))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=_spec(), device="cpu",
        config=W.ds_config("fp32", 1, 0, None, {}, MICRO, GAS))
    assert type(eng).__name__ == "PipelineEngine"
    assert eng.telemetry.meta["pipeline"]["schedule"] == "gpipe"
    batch = torch.from_numpy(make_batches(1, 0)[0].astype(np.int64))
    loss = float(eng.train_batch(batch))
    assert np.isfinite(loss)
    assert abs(float(eng.eval_batch(batch)) - loss) < 0.5
    with pytest.raises(RuntimeError, match="train_batch"):
        eng.forward(batch)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_a_deleted_engine_is_freed_without_a_collection(schedule):
    """No reference cycle holds a stage engine (and so its card's
    memory) past ``del``: the engine holds no bound method of itself."""
    import gc
    import weakref
    cfg = W.ds_config("fp32", 1, 0, None,
                      {"pipeline": {"schedule": schedule}}, MICRO, GAS)
    batch = torch.from_numpy(make_batches(1, 1)[0].astype(np.int64))
    was = gc.isenabled()
    gc.disable()
    try:
        eng = deepspeed_tpu_torch.initialize(model=_spec(), config=cfg,
                                             device="cpu")[0]
        eng.train_batch(batch)
        eng.eval_batch(batch)
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        if was:
            gc.enable()
