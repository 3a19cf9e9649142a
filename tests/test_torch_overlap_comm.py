"""Bucketed, overlapped gradient collectives (``overlap_comm`` with
``reduce_bucket_size``, ``runtime/zero/overlap.py``) at ZeRO stages 1-2
across gloo processes, on gpt2-tiny.

- dp 2, buckets of at most 40,000 elements (several a step): overlap
  on is bit-equal to overlap off (the losses, the parameter digest after
  every step, the final parameters and this rank's moments) at stages 1
  and 2 in fp32 (gas 2), in bf16 (gas 1), at stage 2 with
  ``reduce_scatter: false`` and with the MoE FFN (8 experts top-2) at
  stage 2; buckets of the last micro-step start from the grad hooks
  before the backward's last grad is in (``overlap_early`` > 0).
- dp 4 at stage 2 against the JAX engine on a 4-device mesh (which
  overlaps through XLA's scheduler), fp32: losses within 1e-5 relative
  and the final parameters within 1e-5 (tests/test_torch_dp.py's
  tolerances).
- The buckets, with the collectives faked on one process: made in the
  order the grads arrive, each started when the next grad would take it
  past ``reduce_bucket_size`` elements (a larger leaf alone) or at the
  last grad, covering every leaf once; every leaf's sum right at stage
  2 (each leaf's columns of the V layout) and in the all-reduce mode
  (a flat span, or a packed copy where the leaves are not side by side)
  over 2 micro-steps, in reverse and in shuffled order.
"""
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.fused_update import ShardGroup, FlatGroup
from deepspeed_tpu_torch.runtime.zero.overlap import GradBuckets
from deepspeed_tpu_torch.runtime.zero.partition import row_plan

import torch_dp_worker as W
from test_torch_dp import (jax_engine, jax_flat_params, jax_steps, load,
                           make_batches, params_np, save_params, spawn, wait)

BUCKET = 40_000
OVERLAP = {"overlap_comm": True, "reduce_bucket_size": BUCKET}
MOE = {"num_experts": 8, "top_k": 2, "capacity_factor": 1.25}
DP2 = {  # name: (precision, stage, gas, extra zero keys, moe)
    "s1_fp32": ("fp32", 1, 2, {}, None),
    "s2_fp32": ("fp32", 2, 2, {}, None),
    "s2_bf16_gas1": ("bf16", 2, 1, {}, None),
    "s2_allreduce": ("fp32", 2, 2, {"reduce_scatter": False}, None),
    "s2_moe": ("fp32", 2, 2, {}, MOE),
}
DP4 = [2]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("overlap")
    pnp = params_np()
    ppath = str(d / "params.npz")
    save_params(pnp, ppath)
    from test_torch_moe import _cfgs, _jax_params
    mpath = str(d / "moe_params.npz")
    save_params(_jax_params(_cfgs()[1]), mpath)
    for w, gas in ((2, 1), (2, 2), (4, 2)):
        np.save(str(d / f"b{w}_{gas}.npy"),
                make_batches(w, w + gas, steps=3)[:, :W.MICRO * gas * w])

    def job(name, pr, stage, gas, zero, world, on):
        return dict(name=name, precision=pr, stage=stage, gas=gas,
                    zero=dict(zero, **(OVERLAP if on else {})),
                    batches=str(d / f"b{world}_{gas}.npy"),
                    out=str(d / f"dp{world}_{name}_{'on' if on else 'off'}"))
    dense = [job(n, pr, st, gas, z, 2, on)
             for n, (pr, st, gas, z, moe) in DP2.items() if moe is None
             for on in (True, False)]
    moe = [dict(job(n, pr, st, gas, z, 2, on), moe=m)
           for n, (pr, st, gas, z, m) in DP2.items() if m is not None
           for on in (True, False)]
    dp4 = [job(f"s{st}", "fp32", st, 2, {}, 4, True) for st in DP4]
    procs = [spawn(d, 2, dense, "dense2", ppath),
             spawn(d, 2, moe, "moe2", mpath),
             spawn(d, 4, dp4, "dp4", ppath)]
    batches4 = np.load(str(d / "b4_2.npy"))
    jres = {}
    for st in DP4:
        eng = jax_engine("fp32", st, 4, pnp)
        rec = jax_steps(eng, batches4)
        rec["params"] = jax_flat_params(eng)
        jres[st] = rec
        del eng
    for p in procs:
        wait(p, timeout=400)
    port = {k: load(str(d / k), int(k[2])) for k in
            [f"dp2_{n}_{s}" for n in DP2 for s in ("on", "off")] +
            [f"dp4_s{st}_on" for st in DP4]}
    return port, jres


@pytest.mark.parametrize("name", list(DP2))
def test_overlap_on_is_bit_equal_to_off_at_dp2(runs, name):
    port, _ = runs
    on, off = port[f"dp2_{name}_on"], port[f"dp2_{name}_off"]
    for r in range(2):
        a, b = on[r], off[r]
        assert list(a["digest"]) == list(b["digest"])
        np.testing.assert_array_equal(a["loss"], b["loss"])
        np.testing.assert_array_equal(a["params"], b["params"])
        for k in a:
            if k[0] in "mv" and k[1:].isdigit():
                np.testing.assert_array_equal(a[k], b[k])
        assert min(a["overlap_early"]) > 0, a["overlap_early"]
        assert list(b["overlap_early"]) == [-1] * len(b["loss"])
    assert list(on[0]["digest"]) == list(on[1]["digest"])


@pytest.mark.parametrize("stage", DP4)
def test_overlap_at_dp4_matches_jax(runs, stage):
    port, jres = runs
    got, want = port[f"dp4_s{stage}_on"], jres[stage]
    np.testing.assert_allclose(got[0]["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got[0]["params"], want["params"], atol=1e-5)
    assert min(got[0]["overlap_early"]) > 0
    for r in got[1:]:
        np.testing.assert_array_equal(r["params"], got[0]["params"])


class _Work:
    def wait(self):
        pass


class _FakeDist:
    """dp 2 with two equal inputs, on one process: an all-reduce doubles
    its tensor, a reduce-scatter gives rank 0's rows doubled; each call
    is recorded."""

    def __init__(self):
        self.calls = []

    def all_reduce(self, t, async_op=False):
        self.calls.append(t.numel())
        t.mul_(2)
        return _Work()

    def reduce_scatter_tensor(self, out, full, async_op=False):
        self.calls.append(full.numel())
        out.copy_(2 * full[:out.shape[0]])
        return _Work()


SHAPES = [(300,), (40, 50), (7,), (120, 10), (5000,), (3, 4)]
ORDERS = {"reverse": [5, 4, 3, 2, 1, 0], "shuffled": [2, 5, 0, 3, 1, 4]}


def _drive(monkeypatch, reduce_scatter, order, gas=1):
    """GradBuckets over SHAPES (one group, buckets of 2100 elements),
    the hooks' grads arriving in ``order`` for ``gas`` micro-steps.
    Returns the buckets, the fake collectives, the grads and the
    groups."""
    from deepspeed_tpu_torch.runtime.zero import overlap
    fake = _FakeDist()
    monkeypatch.setattr(overlap, "dist", fake)
    sizes = [int(np.prod(s)) for s in SHAPES]
    leaves = [torch.zeros(s) for s in SHAPES]
    shards = [ShardGroup(SHAPES, torch.float32, torch.device("cpu"),
                         row_plan(2, 0))]
    groups = [FlatGroup(leaves, torch.float32, torch.device("cpu"), None)]
    bk = GradBuckets([list(range(len(SHAPES)))], sizes, 2100,
                     reduce_scatter, shards, groups,
                     groups[0].views(groups[0].grad))
    gen = torch.Generator().manual_seed(0)
    grads = [[torch.randn(s, generator=gen) for s in SHAPES]
             for _ in range(gas)]
    for m in range(gas):
        bk.open(first=m == 0, last=m == gas - 1)
        for leaf in order[:-1]:
            bk.hook(leaf)(grads[m][leaf])
        # the last leaf's grad reaches the step through close()
        bk.close(grads[m])
    bk.wait()
    return bk, fake, grads, shards[0], groups[0]


@pytest.mark.parametrize("reduce_scatter", [True, False])
def test_buckets_cover_each_leaf_once_in_reverse_order(monkeypatch,
                                                       reduce_scatter):
    bk, fake, _, sg, _ = _drive(monkeypatch, reduce_scatter,
                                ORDERS["reverse"])
    sizes = [int(np.prod(s)) for s in SHAPES]
    # buckets in arrival order, each started when the next grad would
    # take it past 2100 elements: [5] 12, [4] 5000 (a larger leaf
    # alone), [3, 2] 1207, [1] 2000, [0] 300 (at the last grad)
    runs = [[5], [4], [3, 2], [1], [0]]
    want = [sum(sg.columns[j][1] for j in run) * sg.shards
            if reduce_scatter else sum(sizes[j] for j in run)
            for run in runs]
    assert fake.calls == want
    assert bk.launched == len(runs)
    # the buckets the grads before the last one closed start inside the
    # backward, before the last grad is in ([1] and [0] start at it)
    assert bk.early == 3


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("reduce_scatter", [True, False])
def test_buckets_sum_every_leaf_in_any_arrival_order(monkeypatch,
                                                     reduce_scatter, order):
    gas = 2
    bk, fake, grads, sg, grp = _drive(monkeypatch, reduce_scatter,
                                      ORDERS[order], gas=gas)
    total = [sum(g[j] for g in grads) for j in range(len(SHAPES))]
    if reduce_scatter:
        # every micro-step reduce-scatters; rank 0's rows accumulate
        want = sg.pack([2 * t for t in total], torch.zeros(sg.numel))
        np.testing.assert_allclose(sg.grad.numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert len(fake.calls) == gas * bk.launched
    else:
        # the window's sums, all-reduced once (packed where a bucket's
        # leaves are not side by side in the flat buffer)
        for v, t in zip(grp.views(grp.grad), total):
            np.testing.assert_allclose(v.numpy(), 2 * t.numpy(),
                                       rtol=1e-6, atol=1e-6)
        assert len(fake.calls) == bk.launched
    assert bk.early >= 1
