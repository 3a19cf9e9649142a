"""The port's block-sparse attention against the JAX package's, on the
CPU: the layout generators and the LUT builder (numpy on both sides),
the LUT kernels' function (``ops/sparse_flash.py``; the JAX side runs the
Pallas kernels in interpret mode, the port its plain versions through
the same autograd Function the card runs), the layout-gated flash mode,
the routing of ``flash_attention(layout=...)`` and ``SparseSelfAttention``,
and the slice: gpt2-tiny at sequence 512 with a Fixed unidirectional
layout, its loss and gradients and two fp32 ``train_batch`` steps
against the JAX engine. Inputs are numpy arrays from a seed; both sides
get the same int32 dropout seed and, for random layouts, the same
``random.seed``.

Tolerances (as tests/test_torch_flash_attention.py): fp32 outputs and
gradients within 1e-5 of the largest magnitude of each; bf16 within
2**-7 of it (the JAX kernels round p to bf16 at running maxima over its
super-tiles, the port's plain version at the row maximum); lse within
1e-5 absolute. Layouts, LUTs and tile picks are equal.
"""
import dataclasses
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops import flash_attention as jf
from deepspeed_tpu.ops import sparse_flash as jsf
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu_torch import ops
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import flash_attention as tf
from deepspeed_tpu_torch.ops import sparse_flash as tsf
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.fused_update import tree_flatten

B, NH, D, S = 2, 4, 32, 512
SEED = -1234567
REL_TOL = {"fp32": 1e-5, "bf16": 2.0 ** -7}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}

LAYOUT_CASES = [
    ("DenseSparsityConfig", dict(block=16), 64),
    ("FixedSparsityConfig", dict(block=16, num_local_blocks=2,
                                 attention="unidirectional"), 128),
    ("FixedSparsityConfig", dict(block=16, num_local_blocks=4,
                                 num_global_blocks=2,
                                 horizontal_global_attention=True), 128),
    ("FixedSparsityConfig", dict(block=16, different_layout_per_head=True,
                                 num_local_blocks=4,
                                 num_different_global_patterns=4), 128),
    ("VariableSparsityConfig", dict(block=16, num_random_blocks=2,
                                    local_window_blocks=[1, 2, 3],
                                    global_block_indices=[0, 5],
                                    global_block_end_indices=[2, 6],
                                    different_layout_per_head=True), 160),
    ("VariableSparsityConfig", dict(block=16, num_random_blocks=1,
                                    attention="unidirectional"), 128),
    ("BigBirdSparsityConfig", dict(block=16, num_random_blocks=2,
                                   different_layout_per_head=True), 128),
    ("BigBirdSparsityConfig", dict(block=16, num_random_blocks=1,
                                   attention="unidirectional"), 128),
    ("BSLongformerSparsityConfig", dict(block=16,
                                        global_block_indices=[0, 3]), 128),
    ("BSLongformerSparsityConfig", dict(block=16,
                                        num_sliding_window_blocks=5,
                                        attention="unidirectional"), 128),
]


@pytest.mark.parametrize("i", range(len(LAYOUT_CASES)))
def test_layouts_equal_jax(i):
    name, kw, seq = LAYOUT_CASES[i]
    out = []
    for mod in (tsa, jsa):
        random.seed(i)
        out.append(getattr(mod, name)(num_heads=4, **kw).make_layout(seq))
    np.testing.assert_array_equal(out[0], out[1])


def _fixed(nH=NH, seq=S, local=2):
    return tsa.FixedSparsityConfig(num_heads=nH, block=128,
                                   num_local_blocks=local,
                                   attention="unidirectional"
                                   ).make_layout(seq)


def _bigbird(seed=3, seq=S):
    random.seed(seed)
    return tsa.BigBirdSparsityConfig(num_heads=NH, block=128,
                                     num_random_blocks=1,
                                     different_layout_per_head=True
                                     ).make_layout(seq)


@pytest.mark.parametrize("qw, w", [(1, 1), (1, 2), (2, 2)])
def test_build_flat_luts_equal_jax(qw, w):
    for lay in (_fixed(seq=1024), _bigbird(seq=1024)):
        got = tsf.build_flat_luts(lay, widen=w, qwiden=qw)
        want = jsf.build_flat_luts(lay, widen=w, qwiden=qw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    lay = _fixed()
    lay[1, 2, :] = 0                               # an empty q row
    assert tsf.build_flat_luts(lay) is None is jsf.build_flat_luts(lay)


def test_tile_picks_equal_jax():
    path = tsa.FixedSparsityConfig(num_heads=12, block=128,
                                   num_local_blocks=4,
                                   attention="unidirectional"
                                   ).make_layout(4096)
    for lay in (path, _fixed(), _bigbird(seq=2048)):
        assert tsf.pick_tile(lay) == jsf.pick_tile(lay)
        assert tsf.pick_widen(lay) == jsf.pick_widen(lay)
        for qw, kw in ((1, 1), (2, 4)):
            assert tsf.supertile_nnz(lay, qw, kw) == \
                jsf.supertile_nnz(lay, qw, kw)
        assert tf._lut_fits_smem(lay) == jf._lut_fits_smem(lay)
    assert tsf.pick_tile(path) == (2, 8)
    assert tsf.resolve_tile(path, 128) == (2, 8)
    assert tsf.resolve_tile(path, 128, widen=4) == (1, 4)


def test_plan_tables_follow_the_layout():
    """The kernels' CSR LUTs and fused dq-partial slots: row offsets
    index the row-major LUT; each visited tile pair has one slot,
    numbered k-tile by k-tile, and each q-tile lists its slots in k
    order."""
    lay = _bigbird()
    plan = tsf.sparse_plan(lay, S, torch.bfloat16, True, "cpu", 2, 2)
    qid, kid, nnz = tsf.build_flat_luts(lay, 2, 2)[:3]
    rp = plan.row_ptr.numpy()
    for h in range(NH):
        for q2 in range(rp.shape[1] - 1):
            assert (qid[h, rp[h, q2]:rp[h, q2 + 1]] == q2).all()
        assert rp[h, -1] == nnz[h]
    pairs = tsf.tile_pairs(lay, 128, 64, True)
    assert plan.slots_per_head == pairs.sum((1, 2)).max()
    nt = pairs.shape[-1]
    for h in range(NH):
        slot, seen = {}, 0
        for kt in range(nt):
            assert plan.slot_base[h, kt] == seen
            for qt in range(nt):
                if pairs[h, qt, kt]:
                    slot[qt, kt] = seen
                    seen += 1
        for qt in range(nt):
            got = plan.rslots[h, plan.rslot_ptr[h, qt]:
                              plan.rslot_ptr[h, qt + 1]].tolist()
            assert got == [slot[qt, kt] for kt in range(nt)
                           if pairs[h, qt, kt]]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, NH, D)).astype(np.float32)
            for _ in range(4)]


def _bh(x, dt):
    return jnp.asarray(x, JDT[dt]).transpose(0, 2, 1, 3).reshape(
        B * NH, S, D)


def _back(x):
    return np.asarray(x.astype(jnp.float32)).reshape(
        B, NH, S, D).transpose(0, 2, 1, 3)


def _assert_close(got, want, dt):
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.dtype == TDT[dt]
        err = np.abs(a.float().numpy() - b).max() / np.abs(b).max()
        assert err <= REL_TOL[dt], (name, err)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("causal, drop, tile", [
    (True, 0.0, (1, 1)), (True, 0.1, (2, 2)), (False, 0.0, (1, 2)),
    (False, 0.1, (2, 1))])
def test_sparse_flash_forward_and_grads_match_jax(dt, causal, drop, tile):
    """The LUT kernels' function at an explicit (qwiden, widen), on a
    BigBird layout (random blocks, a layout per head)."""
    q, k, v, do = _inputs(tile[0] * 10 + tile[1] + causal)
    lay = _bigbird()
    scale = 1.0 / math.sqrt(D)
    qw, w = tile
    o, vjp = jax.vjp(lambda a, b, c: jsf.sparse_flash_attention(
        a, b, c, lay, causal=causal, scale=scale, seed=jnp.int32(SEED),
        dropout=drop, widen=w, qwiden=qw), *(_bh(x, dt) for x in (q, k, v)))
    want = [_back(o)] + [_back(g) for g in vjp(_bh(do, dt))]
    leaves = [torch.from_numpy(x).to(TDT[dt]).requires_grad_()
              for x in (q, k, v)]
    ops.reset_launch_counts()
    ot = tsf.sparse_flash_attention(
        *leaves, lay, causal=causal, scale=scale,
        seed=torch.tensor(SEED, dtype=torch.int32), dropout=drop, widen=w,
        qwiden=qw)
    ot.backward(torch.from_numpy(do).to(TDT[dt]))
    assert sum(ops.launch_counts().values()) == 0     # CPU: no kernels
    _assert_close([ot.detach()] + [t.grad for t in leaves], want, dt)


def test_sparse_lse_and_fused_backward_match_jax():
    """The forward's lse against ``_sparse_fwd``, and the fused backward
    (the path ``DS_SPARSE_FUSED_BWD=1`` takes) against
    ``_sparse_bwd_fused``, fp32, causal, dropout 0.1, super-tile (2, 2)."""
    q, k, v, do = _inputs(7)
    lay = _fixed()
    scale = 1.0 / math.sqrt(D)
    qt_, kt_, vt_, dot_ = (_bh(x, "fp32") for x in (q, k, v, do))
    luts = tuple(jnp.asarray(a) for a in jsf.build_flat_luts(lay, 2, 2))
    seed = jnp.full((1, 1), SEED, jnp.int32)
    o, lse = jsf._sparse_fwd(qt_, kt_, vt_, *luts[:4], seed, scale, True,
                             NH, 256, 256, 0.1, 2, 2)
    jdq, jdk, jdv = jsf._sparse_bwd_fused(qt_, kt_, vt_, o, lse, dot_, luts,
                                          seed, scale, True, NH, 256, 256,
                                          0.1, 2, 2)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tseed = torch.tensor(SEED, dtype=torch.int32)
    to, tlse = tsf.sparse_flash_fwd(tq, tk, tv, lay, True, scale, 0.1,
                                    tseed, 2, 2)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse)[:, 0],
                               atol=1e-5, rtol=0)
    delta = tf.flash_delta(tdo, to)
    got = tsf.sparse_flash_bwd_fused(tq, tk, tv, tdo, tlse, delta, lay, True,
                                     scale, 0.1, tseed, 2, 2)
    _assert_close([to] + list(got),
                  [_back(o)] + [_back(g) for g in (jdq, jdk, jdv)], "fp32")


def test_sparse_backward_env_selects_fused(monkeypatch):
    """``DS_SPARSE_FUSED_BWD=1`` takes the fused backward, as in JAX;
    both backwards give the same gradients."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(9))
    grads, calls = [], []
    for env in ("0", "1"):
        monkeypatch.setenv("DS_SPARSE_FUSED_BWD", env)
        assert tsf.use_fused_bwd() == (env == "1")
        for name in ("sparse_flash_bwd_fused", "sparse_flash_bwd_dq"):
            fn = getattr(tsf, name)
            monkeypatch.setattr(tsf, name, lambda *a, _f=fn, _n=name: (
                calls.append(_n), _f(*a))[1])
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        tsf.sparse_flash_attention(*leaves, _fixed(), causal=True,
                                   scale=0.2).backward(do)
        grads.append([t.grad for t in leaves])
        monkeypatch.undo()
    assert calls == ["sparse_flash_bwd_dq", "sparse_flash_bwd_fused"]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_row_with_no_kept_key_gives_zeros():
    """A causal layout whose q-block 1 keeps only a block above the
    diagonal: every pair of its rows is masked. The JAX LUT kernel's
    online softmax starts that row at exp(-1e30 - -1e30) = 1 and no later
    tile wipes it, so it returns the mean of the visited block's v; the
    port gives exact zeros (ROADMAP §3). Every other row agrees."""
    q, k, v, _ = _inputs(19)
    lay = np.eye(4, dtype=np.int32)[None].repeat(NH, 0)
    lay[:, 1, 1], lay[:, 1, 2], lay[:, 2, 1] = 0, 1, 1
    scale = 1.0 / math.sqrt(D)
    want = _back(jsf.sparse_flash_attention(
        *(_bh(x, "fp32") for x in (q, k, v)), lay, causal=True, scale=scale,
        widen=1, qwiden=1))
    got = tsf.sparse_flash_attention(*(torch.from_numpy(x)
                                       for x in (q, k, v)), lay, causal=True,
                                     scale=scale).numpy()
    assert not got[:, 128:256].any()
    np.testing.assert_allclose(want[:, 128:256],
                               np.broadcast_to(v[:, 256:384].mean(
                                   1, keepdims=True), (B, 128, NH, D)),
                               atol=1e-5)
    rows = np.r_[0:128, 256:S]
    np.testing.assert_allclose(got[:, rows], want[:, rows],
                               atol=1e-5 * np.abs(want[:, rows]).max())


@pytest.mark.parametrize("causal, drop", [(True, 0.1), (False, 0.0)])
def test_gated_mode_matches_jax_flash_sparse(causal, drop):
    """The layout-gated kernels' function against the JAX
    ``_flash_sparse``, on a layout with an empty k-column (which
    ``flash_attention`` routes to the gated mode, not the LUTs)."""
    q, k, v, do = _inputs(11 + causal)
    lay = _fixed(local=4).astype(np.int32)
    lay[:, :, 1] = 0                                # k-block 1: no query
    assert not tf._lut_fits_smem(lay)
    scale = 1.0 / math.sqrt(D)
    o, vjp = jax.vjp(lambda a, b, c: jf._flash_sparse(
        a, b, c, jnp.asarray(lay), jnp.int32(SEED), scale, causal, drop),
        *(_bh(x, "fp32") for x in (q, k, v)))
    want = [_back(o)] + [_back(g) for g in vjp(_bh(do, "fp32"))]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ot = tf.flash_sparse(*leaves, torch.from_numpy(lay),
                         torch.tensor(SEED, dtype=torch.int32), scale, causal,
                         drop)
    ot.backward(torch.from_numpy(do))
    got = [ot.detach()] + [t.grad for t in leaves]
    _assert_close(got, want, "fp32")
    assert not got[2][:, 128:256].any() and not got[3][:, 128:256].any()
    # flash_attention routes this layout to the gated mode
    routed = tf.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=causal, layout=lay)
    if drop == 0.0:
        torch.testing.assert_close(routed, ot.detach(), rtol=0, atol=0)


def test_flash_layout_mode_routes_and_runs():
    """``flash_attention(layout=...)`` routes as the JAX one: a 128-block
    layout whose LUTs fit runs the LUT kernels, one with an empty column
    the gated mode, a 16-block layout or a mask dense attention with the
    layout as a mask; each equals the JAX routing's result."""
    q, k, v, _ = _inputs(13)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    mask = np.where(np.random.default_rng(0).random((B, 1, 1, S)) < 0.1,
                    -1e30, 0.0).astype(np.float32)
    small = tsa.FixedSparsityConfig(num_heads=NH, block=16,
                                    num_local_blocks=4).make_layout(S)
    gated = _fixed().astype(np.int32)
    gated[:, :, 1] = 0
    cases = [(_fixed(), None, tsf.sparse_flash_attention),
             (gated, None, tf.flash_sparse),
             (small, None, None), (_fixed(), mask, None)]
    for lay, m, route in cases:
        taken = []
        if route is not None:
            mod = tsf if route is tsf.sparse_flash_attention else tf
            orig = getattr(mod, route.__name__)
            setattr(mod, route.__name__,
                    lambda *a, **kw: (taken.append(1), orig(*a, **kw))[1])
        try:
            got = tf.flash_attention(tq, tk, tv, causal=True, layout=lay,
                                     mask=None if m is None
                                     else torch.from_numpy(m))
        finally:
            if route is not None:
                setattr(mod, route.__name__, orig)
        want = jf.flash_attention(jq, jk, jv, causal=True, layout=lay,
                                  mask=None if m is None else jnp.asarray(m))
        assert taken == ([1] if route is not None else [])
        plain = tf.flash_attention_plain(tq, tk, tv, causal=True, layout=lay,
                                         mask=None if m is None
                                         else torch.from_numpy(m))
        for out in (got, plain):
            np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                       atol=1e-5 * np.abs(want).max(), rtol=0)
    with pytest.raises(ValueError, match="incompatible"):
        tf.flash_attention(tq, tk, tv, layout=np.ones((NH, 3, 3)))
    with pytest.raises(ValueError, match="empty"):
        tsf.sparse_flash_attention(tq, tk, tv, gated, scale=0.2)


def test_sparse_self_attention_matches_jax():
    """``SparseSelfAttention`` from a ds_config section, with a key
    padding mask, an rpe bias or a multiplicative attention mask (dense
    routes), and without (the LUT route), against the JAX module."""
    q, k, v, _ = _inputs(17)
    section = {"mode": "bslongformer", "block": 128,
               "global_block_indices": [0, 2]}
    tm = tsa.SparseSelfAttention.from_config(section, NH)
    jm = jsa.SparseSelfAttention.from_config(section, NH)
    np.testing.assert_array_equal(tm.get_layout(S), jm.get_layout(S))
    pad = np.ones((B, S), np.float32)
    pad[1, 400:] = 0
    rpe = np.random.default_rng(1).standard_normal((S, S)).astype(np.float32)
    keep = (np.random.default_rng(2).random((S, S)) < 0.9).astype(np.float32)
    for kw in ({}, {"key_padding_mask": pad}, {"rpe": rpe},
               {"attn_mask": keep}):
        got = tm(*(torch.from_numpy(x) for x in (q, k, v)),
                 **{n: torch.from_numpy(a) for n, a in kw.items()})
        want = jm(*(jnp.asarray(x) for x in (q, k, v)),
                  **{n: jnp.asarray(a) for n, a in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5 * np.abs(want).max(), rtol=0)
    ref = tsa.sparse_self_attention.sparse_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), tm.get_layout(S))
    np.testing.assert_allclose(ref.numpy(), np.asarray(
        jsa.sparse_self_attention.sparse_attention_reference(
            *(jnp.asarray(x) for x in (q, k, v)), jm.get_layout(S))),
        atol=1e-5, rtol=0)


# --------------------------------------------------------------------- #
# The slice: gpt2-tiny at sequence 512 with a Fixed unidirectional layout
# --------------------------------------------------------------------- #
SECTION = {"mode": "fixed", "block": 128, "num_local_blocks": 2,
           "num_global_blocks": 1, "attention": "unidirectional"}


def _sparse_fn(mod, sparse_attention):
    ssa = mod.SparseSelfAttention.from_config(SECTION, 4)

    def attention_fn(q, k, v, mask=None, causal=False, attn_dropout=0.0,
                     rng=None, deterministic=True):
        return sparse_attention(q, k, v, ssa.get_layout(q.shape[1]),
                                causal=causal, mask=mask,
                                attn_dropout=attn_dropout, rng=rng,
                                deterministic=deterministic)
    return attention_fn


def _slice_cfgs():
    off = dict(hidden_dropout=0.0, attn_dropout=0.0, max_seq_length=512)
    return (dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"],
                                dtype=torch.float32, **off),
            dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"],
                                dtype=jnp.float32, **off))


@pytest.fixture(scope="module")
def slice_params():
    return jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0), _slice_cfgs()[1]))


def test_slice_gpt2_loss_and_grads_match_jax(slice_params):
    tcfg, jcfg = _slice_cfgs()
    batch = np.random.default_rng(0).integers(0, 512, (2, 513)) \
        .astype(np.int32)
    jfn = _sparse_fn(jsa, jsa.sparse_attention)
    jl, jg = jax.value_and_grad(
        lambda p: jgpt2.gpt2_loss_fn(jcfg, attention_fn=jfn)(
            p, jnp.asarray(batch), None))(
        jax.tree_util.tree_map(jnp.asarray, slice_params))
    tp = convert.from_jax_params(slice_params)
    assert tp["wpe"].shape == (512, tcfg.hidden_size)
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_()
    loss = tgpt2.gpt2_loss_fn(tcfg, attention_fn=_sparse_fn(
        tsa, tsa.sparse_attention))(tp, torch.from_numpy(batch), None)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for g, jgl in zip(grads, jax.tree_util.tree_leaves(jg)):
        jgl = np.asarray(jgl)
        np.testing.assert_allclose(g.numpy(), jgl,
                                   atol=1e-5 * np.abs(jgl).max())


def test_slice_train_batch_matches_jax_engine(slice_params):
    """Two fp32 steps (gas 2 x micro-batch 2 x 512, AdamW, clip 1.0)
    through ``initialize`` → ``train_batch`` with the sparse closure on
    both sides; the JAX engine on a one-device mesh."""
    tcfg, jcfg = _slice_cfgs()
    ds = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-4, "weight_decay": 0.01}},
          "sparse_attention": SECTION}
    batches = [np.random.default_rng(i).integers(0, 512, (4, 513))
               .astype(np.int32) for i in range(2)]
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=_sparse_fn(
            jsa, jsa.sparse_attention)),
        model_params=jax.tree_util.tree_map(jnp.asarray, slice_params),
        config=ds, mesh=build_mesh(devices=jax.devices()[:1]))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg, attention_fn=_sparse_fn(
            tsa, tsa.sparse_attention)),
        model_params=convert.from_jax_params(slice_params), config=ds,
        device="cpu")
    assert teng.config.sparse_attention == jeng.config.sparse_attention
    jl = [float(jeng.train_batch(b)) for b in batches]
    tl = [float(teng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for t, j in zip(tree_flatten(teng.state.params)[0],
                    jax.tree_util.tree_leaves(jeng.state.params)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=1e-5)
