"""The port's ZeRO building blocks against the JAX package, in one
process on the CPU (the multi-process runs are tests/test_torch_dp.py
and tests/test_torch_dp_checkpoint.py).

- The V-interleaved layout (``ops/fused_update.py``): ``_group_row_len``
  and ``group_nbytes`` equal JAX's; ``_flatten_group`` (all rows, and
  each rank's rows at dp 1/2/4/8) equals the rows of JAX's buffer bit
  for bit on mixed leaf sizes that need padding; ``_unflatten_group``
  and ``leaf_moment_views`` give back JAX's leaves bit for bit.
- K5/K6 in their shard-local mode (plain versions): each rank's rows
  with its base offset against ``_run_sqnorm`` and ``_run_group``
  (interpret mode) on the same rows and seed row. K5: relative 1e-6,
  per rank and summed over the ranks. K6: params and moments within the
  4 fp32 ulp class of tests/test_torch_training_kernels.py (4 ulp of
  the larger operand of the last add: the param's last add is p + u*lr,
  and on these rows u*lr can be the larger, 5 ulp of p where it is
  twice p), the cast copy within 1 ulp. Stochastic rounding: the noise (the hash of the
  V-layout index xor the seed) equals JAX's at every element, including
  a base past 2^31 that wraps as uint32; the rounded params then equal
  JAX's wherever the two fp32 values before rounding are equal, which
  the test finds at every element but a few where the last-add ulp
  differs (at least 99.9%, within 1 bf16 ulp everywhere). The ranks'
  outputs joined equal one whole-buffer run bit for bit.
- ``runtime/zero/partition.py``: the row plan equals the JAX sharding's
  slices of the flat buffer over dp; ``describe_sharding`` reads as
  JAX's report of its fused state under ``zero_shardings`` on gpt2-tiny.
- The ZeRO block parses to the same values and errors as JAX's, stage 3
  included; the port's config refuses a dp world above 8, MoE
  at dp > 1 and the SIGTERM preemption save at dp > 1.
- ``runtime/zero/stage3.py`` on a world-1 gloo group: ``gather_cast``
  gives the leaf and its gradient, and ``regather_saved`` packs the
  gathered weights autograd saves as re-gathers with equal gradients.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops import fused_update as jfu
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.zero import partition as jpart
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import fused_update as tfu
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.zero import partition as tpart
from deepspeed_tpu_torch.runtime.zero import stage3 as tz3
from torch_cases import ADAM_CASES, adam_case, ulps

SHAPES = [(7,), (3, 5), (1000,), (8, 129), (2, 3, 4), (1,), (4100, 3)]


def _leaves(seed=0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_buffer(leaves, shards):
    sizes = [a.size for a in leaves]
    Lpad = jfu._group_row_len(sizes, shards)
    buf = jfu._flatten_group([jnp.asarray(a) for a in leaves],
                             range(len(leaves)), jnp.float32, shards, Lpad)
    return np.asarray(buf), Lpad


# --------------------------------------------------------------------- #
# The V-layout
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shards", [8, 16])
def test_row_len_and_nbytes_match_jax(shards):
    for sizes in ([7, 15, 1000, 1032, 24, 1, 12300], [1], [8192 * 8],
                  [8192 * 8 + 1], [3] * 50):
        assert tfu._group_row_len(sizes, shards) == \
            jfu._group_row_len(sizes, shards)
        assert tfu.group_nbytes(sizes, shards) == \
            jfu.group_nbytes(sizes, shards)
    assert tfu.virtual_shards(2) == jfu.virtual_shards(2) == 8
    assert tfu.virtual_shards(16) == jfu.virtual_shards(16) == 16


@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_flatten_rows_match_jax_buffer(dp):
    leaves = _leaves(1)
    want, Lpad = _jax_buffer(leaves, 8)
    t = [torch.from_numpy(a) for a in leaves]
    full = tfu._flatten_group(t, 8, Lpad, torch.float32)
    np.testing.assert_array_equal(full.numpy(), want)
    per = 8 // dp
    for d in range(dp):
        rows = (d * per, (d + 1) * per)
        # into a dirty buffer: the padding must be written too
        out = torch.full((per * Lpad,), 7.0)
        tfu._flatten_group(t, 8, Lpad, torch.float32, rows=rows, out=out)
        np.testing.assert_array_equal(out.view(per, Lpad).numpy(),
                                      want[rows[0]:rows[1]])
        # ShardGroup.pack: the same rows from bf16 leaves, widened
        sg = tfu.ShardGroup([a.shape for a in leaves], torch.float32,
                            torch.device("cpu"), tpart.row_plan(dp, d))
        assert (sg.Lpad, sg.base, sg.numel) == (Lpad, rows[0] * Lpad,
                                                per * Lpad)
        sg.pack(t, sg.param)
        np.testing.assert_array_equal(sg.param.view(per, Lpad).numpy(),
                                      want[rows[0]:rows[1]])
        # each leaf's local block is one range of the padded leaf
        for leaf, blk, (off, r) in zip(leaves, sg.local_views(sg.param),
                                       sg.columns):
            padded = np.zeros(8 * r, np.float32)
            padded[:leaf.size] = leaf.reshape(-1)
            np.testing.assert_array_equal(
                blk.reshape(-1).numpy(),
                padded[d * per * r:(d + 1) * per * r])


def test_unflatten_and_moment_views_match_jax():
    leaves = _leaves(2)
    buf, Lpad = _jax_buffer(leaves, 8)
    want = jfu._unflatten_group(jnp.asarray(buf), leaves,
                                range(len(leaves)), 8)
    outs = [torch.empty(a.shape) for a in leaves]
    tfu._unflatten_group(torch.from_numpy(buf.copy()), outs, 8)
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o.numpy(), np.asarray(want[i]))
    # rank rows → their part of each leaf (the rest untouched)
    for d in range(4):
        part = [torch.full(a.shape, -1.0) for a in leaves]
        tfu._unflatten_group(torch.from_numpy(buf[2 * d:2 * d + 2].copy()),
                             part,
                             8, rows=(2 * d, 2 * d + 2))
        for a, o in zip(leaves, part):
            r = -(-a.size // 8)
            lo, hi = min(2 * d * r, a.size), min((2 * d + 2) * r, a.size)
            flat = o.reshape(-1).numpy()
            np.testing.assert_array_equal(flat[lo:hi],
                                          a.reshape(-1)[lo:hi])
            assert (np.delete(flat, np.arange(lo, hi)) == -1.0).all()
    # leaf_moment_views on a two-group tree (fp32 and bf16 leaves)
    tree = {"a": _leaves(3)[0], "b": _leaves(4)[1], "c": _leaves(5)[4]}
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": torch.from_numpy(tree["b"]).to(torch.bfloat16),
             "c": torch.from_numpy(tree["c"])}
    jtree = {"a": jnp.asarray(tree["a"]),
             "b": jnp.asarray(tree["b"], jnp.bfloat16),
             "c": jnp.asarray(tree["c"])}
    rng = np.random.default_rng(6)
    groups = [[tree["b"].size], [tree["a"].size, tree["c"].size]]
    bufs = [rng.standard_normal(8 * jfu._group_row_len(s, 8)).astype(
        np.float32) for s in groups]
    jst = jfu.FusedAdamState(count=jnp.int32(0),
                             m=tuple(jnp.asarray(b) for b in bufs),
                             v=tuple(jnp.asarray(-b) for b in bufs))
    tst = tfu.FusedAdamState(count=torch.tensor(0),
                             m=tuple(torch.from_numpy(b) for b in bufs),
                             v=tuple(torch.from_numpy(-b) for b in bufs))
    jm, jv = jfu.leaf_moment_views(jst, jtree)
    tm, tv = tfu.leaf_moment_views(tst, ttree)
    for k in tree:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
        np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]))


# --------------------------------------------------------------------- #
# K5 / K6 in the shard-local mode (plain versions)
# --------------------------------------------------------------------- #
LPAD = 8192                     # one row quantum: V * Lpad = 65536


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_shard_local_sqnorm_matches_jax(dp):
    rng = np.random.default_rng(dp)
    g = (rng.standard_normal(8 * LPAD) * 0.3).astype(np.float32)
    n = g.size // dp
    total = 0.0
    for d in range(dp):
        loc = g[d * n:(d + 1) * n]
        got = float(tfu.sqnorm(torch.from_numpy(loc)))
        np.testing.assert_allclose(got, float(jfu._run_sqnorm(
            jnp.asarray(loc))), rtol=1e-6)
        total += got
    np.testing.assert_allclose(total, float(jfu._run_sqnorm(
        jnp.asarray(g))), rtol=1e-6)


def _run_plain(name, g, p, m, v, scalars, seed):
    p_dt, c_dt, kw, _ = ADAM_CASES[name]
    T = torch.from_numpy
    return tfu.fused_adam_plain(
        T(g), T(p).to(getattr(torch, p_dt)), T(m), T(v), T(scalars),
        T(seed), b1=0.9, b2=0.999, eps=1e-8,
        cast_dtype=None if c_dt is None else getattr(torch, c_dt), **kw)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("name", sorted(ADAM_CASES))
def test_shard_local_fused_adam_matches_jax(name, dp):
    """The last rank's rows (its base the largest) against JAX's
    ``_run_group`` on the same rows and seed row; every rank's rows
    joined against one whole-buffer run."""
    p_dt, c_dt, kw, _ = ADAM_CASES[name]
    g, p, m, v, scalars, seed = adam_case(name, 8 * LPAD, seed=dp)
    n = g.size // dp
    whole = _run_plain(name, g, p, m, v, scalars, seed)
    parts = []
    for d in range(dp):
        sl = slice(d * n, (d + 1) * n)
        srow = np.array([seed[0], seed[1] + d * n], np.int32)
        parts.append(_run_plain(name, g[sl], p[sl], m[sl], v[sl], scalars,
                                srow))
    for k, w in enumerate(whole):
        if w is not None:
            joined = torch.cat([pt[k] for pt in parts])
            assert torch.equal(joined, w), k
    d = dp - 1
    sl = slice(d * n, (d + 1) * n)
    srow = np.array([seed[0], seed[1] + d * n], np.int32)
    jp_dt = getattr(jnp, p_dt)
    jpn, jmn, jvn, jcn = jfu._run_group(
        jnp.asarray(g[sl]), jnp.asarray(p[sl], jp_dt), jnp.asarray(m[sl]),
        jnp.asarray(v[sl]), jnp.asarray(scalars)[None],
        jnp.asarray(srow)[None], b1=0.9, b2=0.999, eps=1e-8, wd=kw["wd"],
        coupled=kw["coupled"], use_inv=kw["use_inv"],
        use_coeff=kw["use_coeff"], one_pass=kw["one_pass"], sr=kw["sr"],
        cast=c_dt is not None, out_dtype=jp_dt,
        cast_dtype=None if c_dt is None else getattr(jnp, c_dt))
    pn, mn, vn, cn = parts[d]
    ge = g[sl].astype(np.float64) * \
        (scalars[4] if kw["use_inv"] else 1.0) * \
        (scalars[3] if kw["use_coeff"] else 1.0)
    p64 = _np(torch.from_numpy(p[sl]).to(getattr(torch, p_dt))).astype(
        np.float64)
    if kw["coupled"]:
        ge = ge + kw["wd"] * p64

    def ulps_of(a, b, t1, t2):
        mag = np.maximum.reduce([np.abs(a), np.abs(b), np.abs(t1),
                                 np.abs(t2)])
        return float(ulps(mag + np.abs(a - b), mag, "fp32").max())
    assert ulps_of(_np(mn), np.asarray(jmn), 0.1 * ge, 0.9 * m[sl]) <= 4
    assert ulps_of(_np(vn), np.asarray(jvn), 0.001 * ge * ge,
                   0.999 * v[sl]) <= 4
    if kw["sr"]:
        pa, pb = _np(pn), np.asarray(jpn, np.float32)
        assert np.mean(pa == pb) >= 0.999, np.mean(pa == pb)
        assert ulps(pa, pb, "bf16").max() <= 1
    else:
        # The last add's operands: p and the update u * lr (~ pn - p).
        assert ulps_of(_np(pn), np.asarray(jpn), p64,
                       _np(pn).astype(np.float64) - p64) <= 4
    if c_dt is not None:
        assert ulps(_np(cn), np.asarray(jcn, np.float32),
                    "bf16" if c_dt == "bfloat16" else "fp16").max() <= 1


@pytest.mark.parametrize("base", [0, 3 * 65536, 2 ** 31 - 1000,
                                  2 ** 32 - 5000])
def test_sr_noise_is_jax_noise_at_every_element(base):
    """The stochastic-rounding noise of a rank's rows: the hash of the
    V-layout index (base + i, wrapping as uint32) xor the seed, equal to
    JAX's at every element — the base passed as the int32 of the seed
    row, as the engine passes it."""
    seed = np.int32(-123456789)
    n = 8192
    idx = (np.uint64(base) + np.arange(n, dtype=np.uint64)) & \
        np.uint64(0xFFFFFFFF)
    want = np.asarray(jfu._hash_u32(jnp.asarray(idx.astype(np.uint32)) ^
                                    jnp.uint32(seed.view(np.uint32))))
    want = want & 0xFFFF
    b32 = tfu._int32(base)
    tidx = (torch.tensor(b32, dtype=torch.int64) & 0xFFFFFFFF) + \
        torch.arange(n, dtype=torch.int64)
    got = tfu._hash_u32((tidx & 0xFFFFFFFF) ^
                        (torch.tensor(int(seed)) & 0xFFFFFFFF)) & 0xFFFF
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # and the full SR pass at that base, against JAX's kernel
    g, p, m, v, scalars, _ = adam_case("master_free_sr", n, seed=3)
    srow = np.array([seed, b32], np.int32)
    pn = _run_plain("master_free_sr", g, p, m, v, scalars, srow)[0]
    jpn = jfu._run_group(
        jnp.asarray(g), jnp.asarray(p, jnp.bfloat16), jnp.asarray(m),
        jnp.asarray(v), jnp.asarray(scalars)[None], jnp.asarray(srow)[None],
        b1=0.9, b2=0.999, eps=1e-8, wd=0.01, coupled=False, use_inv=False,
        use_coeff=True, one_pass=True, sr=True, cast=False,
        out_dtype=jnp.bfloat16, cast_dtype=None)[0]
    pa, pb = _np(pn), np.asarray(jpn, np.float32)
    assert np.mean(pa == pb) >= 0.999
    assert ulps(pa, pb, "bf16").max() <= 1


# --------------------------------------------------------------------- #
# Partition: the row plan, stage-3 specs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_row_plan_is_the_jax_flat_shard(dp):
    n = 8 * LPAD
    mesh = build_mesh(devices=jax.devices()[:dp])
    sh = NamedSharding(mesh, jpart._leaf_spec((n,), dp, "data")
                       if dp > 1 else P())
    slices = [idx[0] for idx in sh.devices_indices_map((n,)).values()]
    for d in range(dp):
        plan = tpart.row_plan(dp, d)
        lo, hi = plan.elements(LPAD)
        assert (slices[d].start or 0, slices[d].stop or n) == (lo, hi)
        assert plan.rows_per_rank == 8 // dp


@pytest.mark.parametrize("dp,stage", [(1, 2), (2, 0), (2, 1), (4, 3)])
def test_describe_sharding_reads_as_jax(dp, stage):
    jcfg = jgpt2.GPT2_CONFIGS["gpt2-tiny"]
    jp = jgpt2.gpt2_init(jax.random.PRNGKey(0), jcfg)
    tp = tgpt2.gpt2_init(dataclasses.replace(
        tgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32),
        torch.Generator().manual_seed(0), "cpu")
    mesh = build_mesh(devices=jax.devices()[:dp])
    state = jfu.fused_adam(1e-3).init(jp)
    sh = jpart.zero_shardings(state, mesh,
                              "data" if stage >= 1 and dp > 1 else None)
    want = jpart.describe_sharding(state, sh)
    got = tpart.describe_sharding(tp, dp, stage)
    assert got == f"{want} (stage {stage}, dp {dp})"


# --------------------------------------------------------------------- #
# Config
# --------------------------------------------------------------------- #
ZERO_BLOCKS = [
    {"stage": 3},
    {"stage": 3, "prefetch_depth": 2, "grad_sync": "explicit"},
    {"stage": 2, "reduce_scatter": False},
    {"stage": 2, "grad_sync": "declarative", "overlap_comm": True,
     "reduce_bucket_size": 1000},
    {"stage": 3, "reduce_scatter": False},
    {"stage": 2, "reduce_scatter": False, "grad_sync": "explicit"},
    {"stage": 3, "prefetch_depth": -1},
    {"stage": 1, "grad_sync": "eager"},
    True,
]


def _zero(mod, block, world):
    d = {"train_batch_size": 8 * world, "zero_optimization": block}
    try:
        c = mod.DeepSpeedConfig(json.loads(json.dumps(d)), world_size=world)
    except Exception as e:                      # noqa: BLE001
        return ("error", type(e).__name__, str(e))
    return ("ok", c.zero_optimization_stage, vars(c.zero_config))


@pytest.mark.parametrize("i", range(len(ZERO_BLOCKS)))
def test_zero_block_parses_as_jax(i):
    for world in (1, 2, 4):
        assert _zero(tconfig, ZERO_BLOCKS[i], world) == \
            _zero(jconfig, ZERO_BLOCKS[i], world)


def test_config_refuses_dp_not_dividing_8_and_moe_at_dp():
    # A dp that does not divide 8 is accepted since its port (JAX's
    # placement of the V-layout buffers: tests/test_torch_zero_dp3.py);
    # above 8 (JAX widens V to dp there) it is still refused.
    for world in (3, 5, 6, 7):
        c = tconfig.DeepSpeedConfig({"train_batch_size": 4 * world},
                                    world_size=world)
        assert c.unported_features() == []
    c = tconfig.DeepSpeedConfig({"train_batch_size": 64}, world_size=16)
    names = [f for f, _ in c.unported_features()]
    assert any("dp world of 16" in f for f in names), names
    for world in (1, 2, 4, 8):
        c = tconfig.DeepSpeedConfig({"train_batch_size": 8 * world,
                                     "zero_optimization": {"stage": 3}},
                                    world_size=world)
        assert c.unported_features() == []
    # MoE at dp > 1 (ep 1) is accepted since its port
    # (tests/test_torch_moe_dp.py); ep > 1 is still refused.
    c = tconfig.DeepSpeedConfig({"train_batch_size": 16,
                                 "moe": {"num_experts": 4}}, world_size=2)
    assert c.unported_features() == []
    c = tconfig.DeepSpeedConfig({"train_batch_size": 16, "moe": {
        "num_experts": 4, "expert_parallel_size": 2}}, world_size=2)
    assert [f for f, _ in c.unported_features()] == \
        ["moe.expert_parallel_size > 1"]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_config_refuses_preempt_save_at_dp(world):
    """The preemption save is accepted at any dp since the collective
    save (the handler records the signal; the ranks agree and save at
    the next step boundary: tests/test_torch_ckpt_writers.py), as are
    the block with it off and with no save_dir (no handler)."""
    def names(ck):
        c = tconfig.DeepSpeedConfig({"train_batch_size": 8 * world,
                                     "checkpoint": ck}, world_size=world)
        return [f for f, _ in c.unported_features()]
    assert names({"save_dir": "ckpt"}) == []     # preempt_save defaults on
    assert names({"save_dir": "ckpt", "preempt_save": False}) == []
    assert names({"preempt_save": True}) == []


# --------------------------------------------------------------------- #
# Stage 3's gather on a world-1 group
# --------------------------------------------------------------------- #
@pytest.fixture
def world1_group():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    yield
    dist.destroy_process_group()


def test_gather_cast_and_regather_saved(world1_group):
    rng = np.random.default_rng(0)
    w_np = rng.standard_normal((5, 7)).astype(np.float32)
    x_np = rng.standard_normal((3, 5)).astype(np.float32)
    sg = tfu.ShardGroup([(5, 7)], torch.float32, torch.device("cpu"),
                        tpart.row_plan(1, 0))
    sg.pack([torch.from_numpy(w_np)], sg.param)
    part = sg.local_views(sg.param)[0].detach().requires_grad_(True)
    x = torch.from_numpy(x_np).requires_grad_(True)
    calls = []

    def regather():
        calls.append(1)
        return tz3._gather(part.detach(), (5, 7), torch.float32)
    w = tz3.gather_cast(part, (5, 7), torch.float32)
    np.testing.assert_array_equal(w.detach().numpy(), w_np)
    with tz3.regather_saved({0: (regather, w)}):
        y = torch.tanh(x @ w).sum()
    del w
    g, gx = torch.autograd.grad(y, (part, x))
    assert calls, "the saved weight was not re-gathered"
    # the same loss without the hooks
    wt = torch.from_numpy(w_np).requires_grad_(True)
    gw, gx_want = torch.autograd.grad(torch.tanh(x @ wt).sum(), (wt, x))
    np.testing.assert_array_equal(gx.numpy(), gx_want.numpy())
    r = sg.columns[0][1]
    flat = np.zeros(8 * r, np.float32)
    flat[:35] = gw.numpy().reshape(-1)
    np.testing.assert_array_equal(g.reshape(-1).numpy(), flat)
    # Zero3Scan is ported (tests/test_torch_zero3_scan.py): it builds
    # unbound, and only a stage-3 engine across ranks binds it.
    spec = tz3.Zero3Scan()
    assert not spec.bound and spec.mode == "unbound"
