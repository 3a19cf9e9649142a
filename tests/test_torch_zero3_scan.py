"""ZeRO-3's per-layer layout and the prefetched layer scan (``Zero3Scan``)
of the port against the JAX package, on gpt2-tiny at 4 layers on the CPU
(the harness of tests/test_torch_dp.py: N gloo processes of
tests/torch_dp_worker.py, the JAX engine on an N-device mesh in this
process; fp32 unless named, gas 2, micro 2 a rank, dropout 0, AdamW with
clipping 1.0 and WarmupLR, 5 steps of numpy-seeded batches).

- dp 2: prefetch depths 0, 1 and 2 give bit-identical losses, per-step
  params digests, final params and moments, in fp32 (5 steps) and in
  bf16 (3), and with dropout 0.1 at depths 0 and 1 (3); every rank
  holds the same params.
- Against JAX's scan engine (its ``Zero3Scan`` at depth 1, dp 2): losses
  within 1e-5 relative, params within 1e-5 absolute.
- Against the port's stage 2 (no scan) at dp 2: losses within 1e-7
  relative, params within rtol 1e-4 / atol 3e-5 (JAX's own tolerances,
  ``tests/test_zero3.py``: the grad norm sums in another order, so the
  clip coefficient may move by an ulp; whether the bits are equal is
  printed).
- ``gather_working_set_bytes`` and the engine's telemetry figure equal
  JAX's at depths 0-2 (and the generic count without a scan).
- Checkpoints: a port scan save after 3 steps resumes bit-equal in the
  port, within 1e-5 in JAX's engine with and without a ``Zero3Scan``,
  and at port dp 4; a JAX scan save resumes in a port scan engine within
  1e-5. The files hold the JAX layout (JAX loads them).
- dp 4 trains with the scan (5 steps, within 1e-5 of dp 2 on the same
  global batch).
- The per-layer rows at dp 2 and 4: pack and unpack round-trip, a
  rank's part of a layered leaf's layer l is 1/dp of that layer's padded
  slice, and one master-free step over every rank's rows (K6's plain
  version, its stochastic-rounding noise indexed by the element's place
  in this layout, not JAX's: ROADMAP §3) puts each element on one of the
  two bf16 neighbours of JAX's fp32 update of it.
- In this process: an unbound spec runs the normal loop bit for bit; a
  bound spec refuses progressive layer drop, ``layer_valid`` and MoE
  blocks as JAX does; the engine refuses a spec other than the one the
  model's loss was built with; the window keeps at most ``depth + 1`` layers
  gathered and starts layer i+depth's gather before layer i is used.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.ops import fused_update as jfu
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime.zero import partition as jpart
from deepspeed_tpu.runtime.zero import stage3 as jz3

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.moe import MoEConfig
from deepspeed_tpu_torch.ops import fused_update as tfu
from deepspeed_tpu_torch.runtime.zero import partition as tpart
from deepspeed_tpu_torch.runtime.zero import stage3 as tz3

import torch_dp_worker as W
from torch_cases import ADAM_CASES, adam_case
from test_torch_dp import jax_flat_params, load, save_params, spawn, wait

LAYERS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This process's torch work on one intra-op thread (the gloo workers
    set theirs), so parallel test workers do not contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
STEPS = 5
SAVE_AT = 3
SHORT = 3          # steps of the bf16 and dropout depth comparisons
DEPTHS = (0, 1, 2)


def jcfg(dropout=0.0):
    return dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"],
                               num_layers=LAYERS, dtype=jnp.float32,
                               fused_kernels=False, hidden_dropout=dropout,
                               attn_dropout=dropout)


def tcfg(dtype=torch.float32, **kw):
    return dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"],
                               num_layers=LAYERS, dtype=dtype,
                               hidden_dropout=0.0, attn_dropout=0.0, **kw)


def jax_params():
    """gpt2-tiny's params at 4 layers as numpy (both sides' start)."""
    return jax.tree_util.tree_map(
        lambda t: t.numpy(), tgpt2.gpt2_init(
            tcfg(), torch.Generator().manual_seed(0), "cpu"))


def jax_scan_engine(params, depth=1, scan=True):
    spec = jz3.Zero3Scan() if scan else None
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg(), attention_fn=jdense, zero3=spec),
        model_params=jax.tree_util.tree_map(jnp.asarray, params),
        config=W.ds_config("fp32", 2, 3, {"prefetch_depth": depth}),
        mesh=build_mesh(devices=jax.devices()[:2]), zero3_scan=spec)
    return eng


def jax_losses(eng, batches):
    return np.asarray([float(eng.train_batch(b)) for b in batches])


def wait_file(path, timeout=240):
    import time
    t0 = time.monotonic()
    while not os.path.exists(path):
        assert time.monotonic() - t0 < timeout, path
        time.sleep(0.1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero3_scan")
    pnp = jax_params()
    ppath = str(d / "params.npz")
    save_params(pnp, ppath)
    batches = np.random.default_rng(11).integers(
        0, 512, (STEPS, W.MICRO * W.GAS * 2, 33)).astype(np.int32)
    np.save(str(d / "b.npy"), batches)
    dirs = {k: str(d / k) for k in ("port", "jax")}

    def job(name, depth=1, precision="fp32", stage=3, **kw):
        return dict(dict(name=name, precision=precision, stage=stage,
                         layers=LAYERS, batches=str(d / "b.npy"),
                         scan=None if depth is None else {"depth": depth},
                         out=str(d / name)), **kw)
    # Two dp 2 worlds and a dp 4 one at once; the bf16 and dropout runs
    # take SHORT steps.
    fp32 = [job(f"p{k}", k, save=dict(dir=dirs["port"], after=SAVE_AT)
                if k == 1 else None) for k in DEPTHS]
    fp32 += [job("s2", None, stage=2),
             job("resume", load=dirs["port"], first=SAVE_AT),
             job("from_jax", load=dirs["jax"], first=SAVE_AT,
                 wait_for=os.path.join(dirs["jax"], "latest"))]
    other = [job(f"bf16_p{k}", k, "bf16", steps=SHORT) for k in DEPTHS]
    other += [job(f"drop_p{k}", k, dropout=0.1, steps=SHORT)
              for k in (0, 1)]
    dp4 = [job("dp4", micro=1),
           job("dp4_from_port", micro=1, load=dirs["port"], first=SAVE_AT,
               wait_for=os.path.join(dirs["port"], "latest"))]
    procs = [spawn(d, 2, fp32, "dp2a", ppath),
             spawn(d, 2, other, "dp2b", ppath),
             spawn(d, 4, dp4, "dp4", ppath)]
    # JAX's scan engine: 3 steps, a save, 2 more; then the port's scan
    # save in it, and in an engine without the scan.
    jeng = jax_scan_engine(pnp)
    jres = {"loss": jax_losses(jeng, batches[:SAVE_AT]),
            "ws": jeng.telemetry.meta["zero3_gather_working_set_bytes"]}
    jeng.save_checkpoint(dirs["jax"])
    jres["loss"] = np.concatenate([jres["loss"],
                                   jax_losses(jeng, batches[SAVE_AT:])])
    jres["params"] = jax_flat_params(jeng)
    wait_file(os.path.join(dirs["port"], "latest"))
    for name, eng in (("jax_from_port", jeng),
                      ("jax_noscan_from_port",
                       jax_scan_engine(jax_params(), scan=False))):
        assert eng.load_checkpoint(dirs["port"])[0] is not None
        jres[name] = {"loss": jax_losses(eng, batches[SAVE_AT:]),
                      "params": jax_flat_params(eng)}
        del eng
    del jeng
    for p in procs:
        wait(p)
    port = {j["name"]: load(j["out"], 2) for j in fp32 + other}
    port.update({j["name"]: load(j["out"], 4) for j in dp4})
    return port, jres, dirs


def _moments(r):
    return {k: v for k, v in r.items() if k[0] in "mv" and k[1:].isdigit()}


@pytest.mark.parametrize("pre", ["", "bf16_", "drop_"])
def test_prefetch_depths_are_bit_identical(runs, pre):
    port, _, _ = runs
    depths = (0, 1) if pre == "drop_" else DEPTHS
    for r in range(2):
        ref = port[f"{pre}p0"][r]
        for k in depths[1:]:
            got = port[f"{pre}p{k}"][r]
            assert int(got["depth"]) == k
            assert list(got["digest"]) == list(ref["digest"])
            np.testing.assert_array_equal(got["loss"], ref["loss"])
            np.testing.assert_array_equal(got["params"], ref["params"])
            for name, m in _moments(ref).items():
                np.testing.assert_array_equal(got[name], m)


@pytest.mark.parametrize("name", ["p0", "p1", "p2", "bf16_p1", "drop_p1",
                                  "resume", "from_jax", "dp4",
                                  "dp4_from_port"])
def test_every_rank_holds_the_same_params(runs, name):
    ranks = runs[0][name]
    for r in ranks[1:]:
        assert list(r["digest"]) == list(ranks[0]["digest"])
        np.testing.assert_array_equal(r["params"], ranks[0]["params"])
        np.testing.assert_array_equal(r["loss"], ranks[0]["loss"])


def test_scan_matches_jax_scan_engine(runs):
    port, jres, _ = runs
    got = port["p1"][0]
    np.testing.assert_allclose(got["loss"], jres["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["params"], jres["params"], atol=1e-5)


def test_scan_matches_port_stage2(runs):
    port, _, _ = runs
    got, want = port["p0"][0], port["s2"][0]
    print(f"scan vs stage 2: losses bit-equal "
          f"{np.array_equal(got['loss'], want['loss'])}, params bit-equal "
          f"{np.array_equal(got['params'], want['params'])} (max |diff| "
          f"{np.abs(got['params'] - want['params']).max():.3e})")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-7)
    np.testing.assert_allclose(got["params"], want["params"], rtol=1e-4,
                               atol=3e-5)


def test_dp4_trains_with_the_scan(runs):
    port, _, _ = runs
    got, want = port["dp4"][0], port["p1"][0]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-5)


def test_port_save_resumes_bit_equal_in_the_port(runs):
    port, _, _ = runs
    want = port["p1"][0]
    for r in port["resume"]:
        np.testing.assert_array_equal(r["loss"], want["loss"][SAVE_AT:])
        assert list(r["digest"]) == list(want["digest"][SAVE_AT:])
        np.testing.assert_array_equal(r["params"], want["params"])


def test_port_save_loads_at_dp4(runs):
    port, _, _ = runs
    want = port["p1"][0]
    got = port["dp4_from_port"][0]
    np.testing.assert_allclose(got["loss"], want["loss"][SAVE_AT:],
                               rtol=1e-5)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-5)


@pytest.mark.parametrize("name", ["jax_from_port", "jax_noscan_from_port"])
def test_port_save_resumes_in_jax(runs, name):
    port, jres, _ = runs
    want = port["p1"][0]
    np.testing.assert_allclose(jres[name]["loss"], want["loss"][SAVE_AT:],
                               rtol=1e-5)
    np.testing.assert_allclose(jres[name]["params"], want["params"],
                               atol=1e-5)


def test_jax_save_resumes_in_port_scan(runs):
    port, jres, _ = runs
    for r in port["from_jax"]:
        np.testing.assert_allclose(r["loss"], jres["loss"][SAVE_AT:],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["params"], jres["params"], atol=1e-5)


def test_port_save_has_the_jax_meta(runs):
    _, _, dirs = runs
    tags = {k: os.path.join(dirs[k], f"global_step{SAVE_AT}")
            for k in ("port", "jax")}
    assert sorted(os.listdir(tags["port"])) == sorted(os.listdir(tags["jax"]))
    metas = {}
    for k, t in tags.items():
        with open(os.path.join(t, "engine_meta.json")) as f:
            metas[k] = json.load(f)
    for key in ("optim_shards", "optim_shard_axes", "dp_world_size",
                "fused_moment_layout", "global_steps"):
        assert metas["port"][key] == metas["jax"][key], key


def test_engine_working_set_is_jax(runs):
    port, jres, _ = runs
    assert int(port["p1"][0]["ws"]) == int(jres["ws"])


@pytest.mark.parametrize("depth", DEPTHS + (None,))
def test_gather_working_set_bytes_is_jax(depth):
    jp = jax_params()
    tp = tgpt2.gpt2_init(tcfg(), torch.Generator().manual_seed(0), "cpu")
    spec = jz3.Zero3Scan()
    covers = None if depth is None else spec.covers
    mesh = build_mesh(devices=jax.devices()[:2])
    jspecs = jpart.stage3_param_specs(jp, 2, "data", scan_paths=covers)
    for itemsize in (2, 4):
        want = jz3.gather_working_set_bytes(
            jp, jspecs, "data", itemsize, prefetch_depth=depth or 0,
            scan_paths=covers, mesh=mesh)
        got = tz3.gather_working_set_bytes(
            tp, 2, itemsize, prefetch_depth=depth or 0,
            scan_paths=None if depth is None else tz3.Zero3Scan().covers)
        assert got == want


def test_covers_is_an_exact_key_segment():
    spec = tz3.Zero3Scan()
    assert spec.covers("['blocks']['qkv_kernel']")
    assert not spec.covers("['blocks_ln_scale']")
    assert not spec.covers("['wte']")


# --------------------------------------------------------------------- #
# In this process
# --------------------------------------------------------------------- #
def _engine(spec, stage):
    cfg = tcfg()
    params = tgpt2.gpt2_init(cfg, torch.Generator().manual_seed(0), "cpu")
    ds = W.ds_config("fp32", 1, stage)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(cfg, zero3=spec), model_params=params,
        config=ds, device="cpu", rng=0, zero3_scan=spec)
    return eng


@pytest.mark.parametrize("stage", [2, 3])
def test_unbound_spec_runs_the_normal_loop(stage):
    batches = np.random.default_rng(3).integers(0, 512, (2, 4, 33))
    spec = tz3.Zero3Scan()
    engines = [_engine(spec, stage), _engine(None, stage)]
    assert not spec.bound
    losses = [[float(e.train_batch(torch.from_numpy(b))) for b in batches]
              for e in engines]
    assert losses[0] == losses[1]
    for a, b in zip(*[W.tree_flatten(e.full_params())[0] for e in engines]):
        assert torch.equal(a, b)


def test_engine_refuses_a_spec_the_model_was_not_built_with():
    cfg = tcfg()
    params = tgpt2.gpt2_init(cfg, torch.Generator().manual_seed(0), "cpu")
    for model_spec in (None, tz3.Zero3Scan()):
        with pytest.raises(ValueError, match="SAME Zero3Scan"):
            deepspeed_tpu_torch.initialize(
                model=tgpt2.gpt2_loss_fn(cfg, zero3=model_spec),
                model_params=params, config=W.ds_config("fp32", 1, 3),
                device="cpu", zero3_scan=tz3.Zero3Scan())


def _bound_spec():
    spec = tz3.Zero3Scan()
    spec.bind(compute_dtype=torch.float32, prefetch_depth=0, layer_info={})
    return spec


def test_bound_spec_refuses_layer_drop():
    cfg = tcfg()
    stacked = ttr.init_block_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    x = torch.zeros(1, 8, cfg.hidden_size)
    with pytest.raises(ValueError, match="layer drop"):
        ttr.apply_blocks(stacked, x, cfg, rng=torch.Generator(),
                         deterministic=False, pld_theta=0.5,
                         zero3=_bound_spec())
    with pytest.raises(ValueError, match="layer drop"):
        ttr.apply_blocks(stacked, x, cfg, layer_valid=[1] * LAYERS,
                         zero3=_bound_spec())
    with pytest.raises(ValueError, match="bound"):
        tz3.zero3_block_scan([], stacked, x, tz3.Zero3Scan())


def test_bound_spec_refuses_moe():
    cfg = tcfg(moe=MoEConfig(num_experts=4, top_k=1))
    stacked = ttr.init_block_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    x = torch.zeros(1, 8, cfg.hidden_size)
    with pytest.raises(ValueError, match="zero3 layer scan"):
        ttr.apply_blocks(stacked, x, cfg, zero3=_bound_spec())


@pytest.mark.parametrize("depth", DEPTHS)
def test_window_bounds_the_gathered_layers(depth):
    """The forward starts layer i+depth's gather before layer i is used;
    the backward walk holds at most depth + 1 layers (in flight or
    gathered) and gathers each layer once."""
    L = 5
    log = []

    class Gathering:
        def __init__(self, i):
            self.i = i
            log.append(("start", i))

        def wait(self):
            log.append(("wait", self.i))
            return [self.i]
    fwd = tz3._Window(Gathering, range(L), depth)
    for i in range(L):
        fwd.take(i).wait()
        started = [j for kind, j in log if kind == "start"]
        assert started == list(range(min(i + depth, L - 1) + 1))
        assert len(fwd.flight) <= depth
    log.clear()
    bwd = tz3._Window(Gathering, range(L - 1, -1, -1), depth)
    for i in range(L - 1, -1, -1):
        for _ in range(3):        # several unpacks of the layer's leaves
            assert bwd.leaf(i, 0) == i
        assert len(bwd.held) + len(bwd.flight) <= depth + 1
    assert [j for kind, j in log if kind == "start"] == \
        list(range(L - 1, -1, -1))
    assert [j for kind, j in log if kind == "wait"] == \
        list(range(L - 1, -1, -1))


LAYERED = [(4, 40, 24), (4, 24), (50,), (4, 7)]


@functools.lru_cache(maxsize=1)
def _sr_case():
    """The master-free inputs over LAYERED and JAX's fp32 update of them
    (no stochastic rounding) in its V-layout of the whole leaves."""
    sizes = [int(np.prod(s)) for s in LAYERED]
    g, p, m, v, scalars, seed = adam_case("master_free_sr", sum(sizes), 7)
    cuts = np.cumsum([0] + sizes)

    def split(a):
        return [a[i:j].reshape(s) for i, j, s in zip(cuts, cuts[1:],
                                                     LAYERED)]
    p = torch.from_numpy(p).to(torch.bfloat16).float().numpy()   # bf16
    Lj = jfu._group_row_len(sizes, 8)

    def jbuf(a):
        return jfu._flatten_group([jnp.asarray(x) for x in split(a)],
                                  range(len(sizes)), jnp.float32, 8,
                                  Lj).reshape(-1)
    _, _, kw, _ = ADAM_CASES["master_free_sr"]
    kw = dict(kw, sr=False)
    jp = jfu._run_group(jbuf(g), jbuf(p), jbuf(m), jbuf(v),
                        jnp.asarray(scalars)[None],
                        jnp.asarray(seed)[None], b1=0.9, b2=0.999,
                        eps=1e-8, cast=False, out_dtype=jnp.float32,
                        cast_dtype=None, **kw)[0]
    like = [np.zeros(s, np.float32) for s in LAYERED]
    want = jfu._unflatten_group(jnp.asarray(jp).reshape(8, Lj), like,
                                range(len(sizes)), 8)
    return (g, p, m, v, scalars, seed), split, kw, \
        [np.asarray(want[k], np.float64) for k in range(len(sizes))]


@pytest.mark.parametrize("dp", [2, 4])
def test_per_layer_rows_and_sr_noise_against_jax(dp):
    layers = [s[0] if len(s) > 1 else 0 for s in LAYERED]
    (g, p, m, v, scalars, seed), split, kw, want = _sr_case()
    # The port: every rank's rows of the per-layer layout
    T = [torch.from_numpy(x) for x in (g, p, m, v)]
    rows = []
    for d in range(dp):
        sg = tfu.ShardGroup(LAYERED, torch.bfloat16, torch.device("cpu"),
                            tpart.row_plan(dp, d), layers=layers)
        bufs = []
        for t, dt in zip(T, (torch.float32, torch.bfloat16, torch.float32,
                             torch.float32)):
            out = torch.zeros(sg.numel, dtype=dt)
            sg.pack([x.to(dt) for x in split(t)], out)
            bufs.append(out)
        # a rank's part of each layered leaf's layer l: 1/dp of it
        for k, (leaf, blk) in enumerate(zip(split(T[0]),
                                            sg.local_views(bufs[0]))):
            if not layers[k]:
                continue
            r = sg.columns[k][1]
            for layer in range(layers[k]):
                padded = torch.zeros(8 * r)
                padded[:leaf[layer].numel()] = leaf[layer].reshape(-1)
                per = 8 // dp
                assert torch.equal(blk[layer].reshape(-1),
                                   padded[d * per * r:(d + 1) * per * r])
        srow = torch.tensor([int(seed[0]), tfu._int32(sg.base)],
                            dtype=torch.int32)
        pn = tfu.fused_adam_plain(*bufs, torch.from_numpy(scalars), srow,
                                  b1=0.9, b2=0.999, eps=1e-8,
                                  **dict(kw, sr=True))[0]
        rows.append(pn)
    outs = [torch.empty(s, dtype=torch.bfloat16) for s in LAYERED]
    sg.unpack(torch.cat(rows), outs)
    back = [torch.empty(s) for s in LAYERED]
    full_g = torch.cat([tfu.ShardGroup(
        LAYERED, torch.float32, torch.device("cpu"), tpart.row_plan(dp, d),
        layers=layers).pack(split(T[0]), torch.zeros(sg.numel))
        for d in range(dp)])
    sg.unpack(full_g, back)
    for got, want_g in zip(back, split(T[0])):
        assert torch.equal(got, want_g)            # the round trip
    for k, got in enumerate(outs):
        w = want[k]
        x = got.float().numpy().astype(np.float64)
        # one of the two bf16 values around JAX's fp32 value (a bf16 ulp,
        # widened by the update's 4 fp32 ulp)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (np.abs(x - w) <= ulp * (1 + 2.0 ** -14)).all(), k


def test_per_leaf_sums_over_the_per_layer_rows():
    """Lamb's per-leaf reductions over a rank's per-layer rows (a layered
    leaf is a column range a layer): each leaf's sum of squares is its
    layers' sums added in order, and the per-leaf scale touches that
    leaf's elements only."""
    from deepspeed_tpu_torch.ops import optimizers as topt
    rng = np.random.default_rng(4)
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in LAYERED]
    layers = [s[0] if len(s) > 1 else 0 for s in LAYERED]
    for d in range(2):
        sg = tfu.ShardGroup(LAYERED, torch.float32, torch.device("cpu"),
                            tpart.row_plan(2, d), layers=layers)
        buf = sg.pack(leaves, torch.zeros(sg.numel))
        got = topt._leaf_sums(buf * buf, sg)
        views = sg.local_views(buf)
        for k, v in enumerate(views):
            want = sum(float((x * x).sum()) for x in
                       (v.unbind(0) if layers[k] else [v]))
            assert abs(float(got[k]) - want) <= 1e-6 * max(1.0, want)
        scaled = topt._leaf_scale_(buf.clone(), torch.arange(
            1.0, len(LAYERED) + 1), sg)
        for k, (a, b) in enumerate(zip(sg.local_views(scaled), views)):
            assert torch.equal(a, b * (k + 1))
