"""ZeRO stage 3 with ZeRO-Offload at dp 2: the port's engine as two gloo
processes (``tests/torch_dp_worker.py``, the harness of
tests/test_torch_dp.py) against the JAX stage-3 offload engine on a
2-device CPU mesh, on gpt2-tiny at 4 layers (fp32, gas 2, micro 2 a
rank, dropout 0, AdamW, clipping 1.0, WarmupLR, 5 steps).

The host holds each rank's partition of the masters and moments, split
along each leaf's first dim that dp divides (JAX's ``stage3_param_specs``
rule; past the layer axis for a leaf a bound ``Zero3Scan`` covers); the
card holds the same split of the compute-dtype params, gathers each leaf
at its use (or each layer, under the scan) and reduce-scatters the fp32
grads straight into the rank's partition.

- Stage 3 offload, without and with the scan: losses within 1e-5
  relative and params within 1e-5 absolute of JAX's stage-3 offload
  engine (the JAX reference, ``tests/test_zero3.py::TestStage3Offload``,
  holds its stage-3 offload trajectory to stage-2 offload's at 1e-6),
  and the host partitions joined along their axes within 1e-5 of JAX's
  host masters and moments; the card holds under the whole parameter
  count; every rank the same params; ``overlap_comm`` (the serial step
  at dp > 1) the same bits over 3 steps; the port's stage-2 offload's
  losses within 1e-5 over 3 steps.
- A save after 3 steps resumes bit-equal.
- The partition axes equal JAX's stage-3 dims for every leaf, with and
  without the scan.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime.zero import partition as jpart
from deepspeed_tpu.runtime.zero import stage3 as jz3

from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.zero import offload as toff
from deepspeed_tpu_torch.runtime.zero.partition import covered_leaves
from deepspeed_tpu_torch.runtime.zero import stage3 as tz3
from torch_jax_native import jax_native  # noqa: F401 (autouse)

import torch_dp_worker as W
from test_torch_dp import jax_flat_params, load, save_params, spawn, wait
from test_torch_offload import team_of_one  # noqa: F401 (the JAX side's)

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
SHORT = 3          # steps of the overlapped and stage-2 comparisons
OFFLOAD = {"cpu_offload": True}


def jax_params():
    """gpt2-tiny's params at 4 layers as numpy (both sides' start)."""
    cfg = dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"],
                              num_layers=LAYERS, dtype=torch.float32)
    return jax.tree_util.tree_map(
        lambda t: t.numpy(), tgpt2.gpt2_init(
            cfg, torch.Generator().manual_seed(0), "cpu"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero3_offload")
    pnp = jax_params()
    ppath = str(d / "params.npz")
    save_params(pnp, ppath)
    batches = np.random.default_rng(12).integers(
        0, 512, (STEPS, W.MICRO * W.GAS * 2, 33)).astype(np.int32)
    np.save(str(d / "b.npy"), batches)
    ckpt = str(d / "ckpt")

    def job(name, stage=3, scan=None, zero=OFFLOAD, **kw):
        return dict(dict(name=name, precision="fp32", stage=stage,
                         zero=zero, layers=LAYERS, scan=scan,
                         batches=str(d / "b.npy"), out=str(d / name)), **kw)
    # Two dp 2 worlds at once; the overlapped and stage-2 runs take
    # SHORT steps.
    first = [job("s3"), job("s3_scan", scan={"depth": 1},
                            save=dict(dir=ckpt, after=SAVE_AT)),
             job("s3_scan_resume", scan={"depth": 1}, load=ckpt,
                 first=SAVE_AT)]
    second = [job("s3_overlap", zero=dict(OFFLOAD, overlap_comm=True),
                  steps=SHORT),
              job("s2", stage=2, steps=SHORT)]
    jobs = first + second
    procs = [spawn(d, 2, first, "dp2a", ppath),
             spawn(d, 2, second, "dp2b", ppath)]
    jcfg = dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"],
                               num_layers=LAYERS, dtype=jnp.float32,
                               fused_kernels=False, hidden_dropout=0.0,
                               attn_dropout=0.0)
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, pnp),
        config=W.ds_config("fp32", 2, 3, OFFLOAD),
        mesh=build_mesh(devices=jax.devices()[:2]))
    jres = {"loss": np.asarray([float(eng.train_batch(b))
                                for b in batches])}
    jres["params"] = jax_flat_params(eng)
    off = eng._offload
    jres["host"] = [np.asarray(x) for x in off.masters + off.opt.exp_avg +
                    off.opt.exp_avg_sq]
    for p in procs:
        wait(p)
    return {j["name"]: load(j["out"], 2) for j in jobs}, jres


@pytest.mark.parametrize("name", ["s3", "s3_scan"])
def test_stage3_offload_matches_jax(runs, name):
    port, jres = runs
    got = port[name][0]
    np.testing.assert_allclose(got["loss"], jres["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["params"], jres["params"], atol=1e-5)


@pytest.mark.parametrize("name,scan", [("s3", False), ("s3_scan", True)])
def test_host_partitions_join_to_jax_state(runs, name, scan):
    port, jres = runs
    want = jres["host"]
    n = len(want) // 3
    shapes = [w.shape for w in want[:n]]
    covered = covered_leaves(jax_params(),
                             tz3.Zero3Scan().covers if scan else None)
    ranks = port[name]
    for kind, ws in zip(("hp", "hm", "hv"), (want[:n], want[n:2 * n],
                                             want[2 * n:])):
        for i, (shape, w) in enumerate(zip(shapes, ws)):
            ax = toff._partition_axis(shape, 2, int(covered[i]))
            parts = [r[f"{kind}{i}"] for r in ranks]
            got = parts[0] if ax is None else np.concatenate(parts, ax)
            np.testing.assert_allclose(got, w, atol=1e-5)
    full = sum(int(np.prod(s)) for s in shapes)
    assert int(ranks[0]["dev_param_elems"]) < full


@pytest.mark.parametrize("name", ["s3", "s3_overlap", "s3_scan",
                                  "s3_scan_resume", "s2"])
def test_every_rank_holds_the_same_params(runs, name):
    ranks = runs[0][name]
    for r in ranks[1:]:
        assert list(r["digest"]) == list(ranks[0]["digest"])
        np.testing.assert_array_equal(r["params"], ranks[0]["params"])


def test_overlap_is_the_serial_step(runs):
    a, b = runs[0]["s3"][0], runs[0]["s3_overlap"][0]
    assert list(a["digest"][:SHORT]) == list(b["digest"])
    np.testing.assert_array_equal(a["loss"][:SHORT], b["loss"])


def test_stage3_offload_matches_stage2_offload(runs):
    a, b = runs[0]["s3"][0], runs[0]["s2"][0]
    np.testing.assert_allclose(a["loss"][:SHORT], b["loss"], rtol=1e-5)


def test_save_resumes_bit_equal(runs):
    want = runs[0]["s3_scan"][0]
    for r in runs[0]["s3_scan_resume"]:
        np.testing.assert_array_equal(r["loss"], want["loss"][SAVE_AT:])
        np.testing.assert_array_equal(r["params"], want["params"])


@pytest.mark.parametrize("scan", [False, True])
def test_partition_axes_are_jax_stage3_dims(scan):
    pnp = jax_params()
    covers = jz3.Zero3Scan().covers if scan else None
    specs = jpart.stage3_param_specs(pnp, 2, "data", scan_paths=covers)
    want = [jpart.spec_dp_dim(sp, "data") for sp in
            jax.tree_util.tree_leaves(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))]
    tparams = jax.tree_util.tree_map(torch.from_numpy, pnp)
    starts = [int(c) for c in covered_leaves(
        tparams, tz3.Zero3Scan().covers if scan else None)]
    off = toff.ZeroOffloadOptimizer(
        tparams, "AdamW", {"lr": 1e-3}, lambda s: 1e-3, torch.float32,
        partition_rank=0, partition_num=2, axis_starts=starts)
    assert off._axes == want


def test_whole_leaf_gathers_by_a_cast_and_all_reduces_its_grad():
    """A leaf no dim of which dp divides is held whole (``DimPart`` with
    no dim): its gather is a cast (no collective), its grad is
    all-reduced in fp32; a split leaf in the same call goes through the
    one all-gather. On a one-rank gloo group."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        rng = np.random.default_rng(6)
        whole = torch.from_numpy(rng.standard_normal((3, 5)).astype(
            np.float32)).requires_grad_(True)
        split = torch.from_numpy(rng.standard_normal((4, 6)).astype(
            np.float32)).requires_grad_(True)
        codecs = [tz3.DimPart((3, 5), None), tz3.DimPart((4, 6), 1)]
        a, b = tz3.gather_parts([whole, split], codecs, torch.bfloat16)
        assert torch.equal(a, whole.detach().to(torch.bfloat16))
        assert torch.equal(b, split.detach().to(torch.bfloat16))
        ga, gb = torch.autograd.grad((a.float() * 3).sum() +
                                     (b.float() * 2).sum(), [whole, split])
        assert ga.dtype == gb.dtype == torch.float32
        assert torch.equal(ga, torch.full((3, 5), 3.0))
        assert torch.equal(gb, torch.full((4, 6), 2.0))
    finally:
        dist.destroy_process_group()
