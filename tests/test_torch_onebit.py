"""1-bit Adam in the port (``deepspeed_tpu_torch/ops/onebit.py`` and the
engine's 1-bit step) against the JAX package (``ops/onebit.py``,
``_build_onebit_train_step``), on the same numpy-seeded inputs.

- ``_compress`` at dp 1, 3 and 8 (chunk widths, per-chunk L1 scales over
  the real elements, a leaf smaller than dp on one scale) within 2 fp32
  ulp of JAX's scales (the two sum the chunks in other orders), and
  ``transmitted + error`` within an ulp of ``compensated`` (of the scale
  where that is larger); ``torch.sign``
  of a zero is zero, as ``jnp.sign`` gives.
- ``onebit_adam_update`` teacher-forced against JAX's at dp 1: the warmup
  elementwise within 1e-6 (fp32); the compression stage elementwise
  within 1e-6 wherever ``|compensated|`` exceeds ``FLIP_FLOOR`` of its
  chunk's scale, and elsewhere (a sign taken of a value at rounding
  level) within the flip bound ``2.5 * lr * scale / (sqrt(v) + eps)``.
- The flat ``OnebitAdam`` step against ``onebit_reference_step`` (the
  leaf-by-leaf plain reference the card holds it against) at dp 1, 2, 3
  and 4 (ranks as threads, the all-reduce summing in rank order) in both
  phases: within 4 fp32 ulp of the larger operand, for the error buffers
  of the largest scale (the chunk sums are reduced in other orders; at
  dp 3, 1/3 is not a power of two, so the warmup's mean is a multiply on
  one side and a divide on the other).
- ``examples/gpt2/ds_config_onebit.json`` on gpt2-tiny (bf16 from its
  path, and fp32 with its bf16 block off) against the JAX engine: the 20
  warmup steps' losses and the first compressed step's within the
  training tolerances (fp32 1e-5), the params after the warmup as
  ``test_torch_optimizers.assert_params`` holds them (the training
  tolerance; the key bias and at most 0.01% of the other elements,
  Adam's moves of rounding-level grads, within 2·steps·lr), then a
  compressed step.
- The engine at dp 1 on gpt2-tiny in fp32, fp16 and bf16 across
  ``freeze_step`` against the JAX engine: the losses of every step up to
  and including the first compressed one (computed before its update),
  with equal fp16 scale and skip sequences; the params after the warmup
  within the training tolerances; then from JAX's state one compressed
  step each: the variance bit-unchanged, the params within the
  tolerances plus 1e-5 of the element's update ``u = lr * scale /
  (sqrt(v) + eps)`` (large where the frozen variance is small), but
  where a sign flipped (at most ``MAX_FLIP_SHARE`` of the elements
  outside the key bias, each within ``2.5 * u``).
- The overflow skip keeps params, m, v, both error buffers and the step
  in both phases (leaf level and the engine); ``comm_bytes`` as JAX's.
- Refusals: ZeRO stage 1 and master-free bf16 (``ValueError``), the
  forward/backward/step trio (``NotImplementedError``), OnebitAdam with
  sparse gradients (``ValueError``).
- Checkpoints in the JAX layout both ways at dp 1 after the freeze (the
  worker error nonzero): the loaded state equals the saved one bit for
  bit and the next step's loss agrees; a JAX save from dp 2 loads into
  the port at dp 1 with the fresh worker error kept (a warning), as JAX
  keeps it.
"""
import json
import logging
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import onebit as jonebit
from deepspeed_tpu_torch.ops import onebit as tonebit
from deepspeed_tpu_torch.ops.fused_update import FlatGroup, tree_flatten
from deepspeed_tpu_torch.runtime.engine import _leaf_paths

from test_torch_optimizers import (assert_params, engine_batches,
                                   engine_cfgs, engine_ds, flat, jax_engine,
                                   jax_history, port_engine, port_history)

FREEZE = 2
LR = 1e-3
ONEBIT = {"type": "OneBitAdam", "params": {"lr": LR, "freeze_step": FREEZE,
                                           "weight_decay": 0.01}}
ATOL = {"fp32": 1e-5, "fp16": 1e-3, "bf16": 1e-2}
RTOL = {"fp32": 1e-5, "fp16": 1e-3, "bf16": 1e-2}
# fp16 from 2^20: gpt2-tiny's first three steps overflow (as in
# tests/test_torch_optimizers.py), and a skip does not advance the
# 1-bit step count.
FP16_SKIPS = 3
# A compensated value below this share of its chunk's scale is at
# rounding level: its sign may differ between two correct programs.
FLIP_FLOOR = 1e-4
MAX_FLIP_SHARE = 1e-3
SHAPES = [(7, 5), (2,), (13,), (3, 4, 2), (64,)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread for this module (gpt2-tiny's ops
    are small; under parallel test workers every worker's intra-op team
    would contend for the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params_np():
    from deepspeed_tpu.models import gpt2 as jgpt2
    return jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0),
                                    engine_cfgs("fp32")[1]))


def _ulp(x):
    x = np.abs(np.asarray(x, np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(x, 1e-38))) - 23)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# --------------------------------------------------------------------- #
# _compress, sign, comm_bytes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("chunks", [1, 3, 8])
@pytest.mark.parametrize("shape", [(7, 5), (2,), (1000,), (33, 17)])
def test_compress_matches_jax(chunks, shape):
    rng = np.random.default_rng(chunks * 100 + len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    e = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    jt, je = (np.asarray(a) for a in jonebit._compress(
        jnp.asarray(x), jnp.asarray(e), chunks=chunks))
    tt, te = tonebit._compress(_t(x), _t(e), chunks=chunks)
    scale = np.abs(jt).max()
    assert np.abs(tt.numpy() - jt).max() <= 2 * _ulp(scale)
    comp = x + e
    mag = np.maximum(np.abs(comp), scale)
    assert (np.abs(te.numpy() - je) <= 2 * _ulp(mag)).all()
    # the signs are the compensated value's (nothing at rounding level
    # here), so each chunk's magnitude is one scale
    np.testing.assert_array_equal(np.sign(tt.numpy()), np.sign(x + e))
    # (error = compensated - transmitted rounds at the scale's ulp)
    assert (np.abs((tt + te).numpy() - comp) <= _ulp(mag)).all()
    k, width, counts = tonebit.chunk_counts(int(np.prod(shape)), chunks)
    if chunks > 1 and np.prod(shape) >= chunks:
        flat_abs = np.abs(tt.numpy().reshape(-1))
        for c in range(k):
            part = flat_abs[c * width:(c + 1) * width]
            if part.size:
                assert np.ptp(part) == 0.0
    else:
        assert k == 1


def test_compress_per_chunk_scale():
    """35 elements in 4 chunks of 9: the last chunk's scale divides by
    its 8 real elements (JAX ``tests/test_onebit.py``)."""
    x = np.random.default_rng(3).standard_normal((7, 5)).astype(np.float32)
    t, err = tonebit._compress(_t(x), torch.zeros(7, 5), chunks=4)
    got = np.abs(t.numpy().reshape(-1))
    rows = np.pad(x.reshape(-1), (0, 1)).reshape(4, 9)
    np.testing.assert_allclose(got[:9], np.abs(rows[0]).mean(), rtol=1e-6)
    np.testing.assert_allclose(got[27:], np.abs(rows[3]).sum() / 8,
                               rtol=1e-6)
    np.testing.assert_allclose(x, (t + err).numpy(), atol=1e-6)


def test_sign_of_zero_is_zero():
    x = torch.tensor([0.0, -0.0, 2.0, -3.0])
    assert torch.sign(x).tolist() == np.asarray(
        jnp.sign(jnp.asarray(x.numpy()))).tolist() == [0.0, 0.0, 1.0, -1.0]


def test_init_state_as_jax():
    tree = {"a": np.ones((3, 2), np.float32), "b": {"c": np.ones(5, np.float32)}}
    j = jonebit.init_state(jax.tree_util.tree_map(jnp.asarray, tree))
    t = tonebit.init_state({"a": _t(tree["a"]), "b": {"c": _t(tree["b"]["c"])}})
    assert int(t.step) == int(j.step) == 0 and t.step.dtype == torch.int32
    for name in tonebit.STATE_BUFFERS:
        got = tree_flatten(getattr(t, name))[0]
        want = jax.tree_util.tree_leaves(getattr(j, name))
        assert [tuple(x.shape) for x in got] == [x.shape for x in want]
        assert all(x.dtype == torch.float32 and not x.any() for x in got)


@pytest.mark.parametrize("n, chunks", [(1000, 1), (1000, 8), (7, 8),
                                       (124439808, 2)])
def test_comm_bytes_as_jax(n, chunks):
    for compressed in (False, True):
        assert tonebit.comm_bytes(n, compressed=compressed, chunks=chunks) \
            == jonebit.comm_bytes(n, compressed=compressed, chunks=chunks)
    assert tonebit.compression_ratio(n, chunks) == \
        jonebit.compression_ratio(n, chunks)


# --------------------------------------------------------------------- #
# The update, leaf by leaf, against JAX's
# --------------------------------------------------------------------- #
def _update_inputs(seed, compressed):
    rng = np.random.default_rng(seed)

    def leaves(scale):
        return [(rng.standard_normal(s) * scale).astype(np.float32)
                for s in SHAPES]
    p, g = leaves(0.5), leaves(0.05)
    m = leaves(0.01)
    v = [np.abs(x) + 1e-6 for x in leaves(1e-3)]
    werr, serr = leaves(0.003), leaves(0.003)
    if not compressed:
        werr = serr = [np.zeros_like(x) for x in werr]
    step = FREEZE if compressed else FREEZE - 1
    return p, g, m, v, werr, serr, step


@pytest.mark.parametrize("phase", ["warmup", "compressed"])
@pytest.mark.parametrize("clip", [0.0, 0.1])
def test_update_matches_jax(phase, clip):
    compressed = phase == "compressed"
    p, g, m, v, werr, serr, step = _update_inputs(7, compressed)
    kw = dict(lr=LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              freeze_step=FREEZE, clip=clip)
    jst = jonebit.OnebitState(
        step=jnp.asarray(step, jnp.int32), m=[jnp.asarray(x) for x in m],
        v=[jnp.asarray(x) for x in v],
        worker_error=[jnp.asarray(x) for x in werr],
        server_error=[jnp.asarray(x) for x in serr])
    jp, jst2, jaux = jonebit.onebit_adam_update(
        [jnp.asarray(x) for x in g], jst, [jnp.asarray(x) for x in p], **kw)
    tst = tonebit.OnebitState(
        step=torch.tensor(step, dtype=torch.int32), m=[_t(x) for x in m],
        v=[_t(x) for x in v], worker_error=[_t(x) for x in werr],
        server_error=[_t(x) for x in serr])
    tp, tst2, taux = tonebit.onebit_adam_update(
        [_t(x) for x in g], tst, [_t(x) for x in p], **kw)
    assert int(tst2.step) == int(jst2.step) == step + 1
    np.testing.assert_allclose(float(taux["grad_norm"]),
                               float(jaux["grad_norm"]), rtol=1e-6)
    assert not bool(taux["overflow"])
    if compressed:
        for a, b in zip(tst2.v, v):
            np.testing.assert_array_equal(a.numpy(), b)
    for i in range(len(SHAPES)):
        got = [tp[i], tst2.m[i], tst2.v[i], tst2.worker_error[i],
               tst2.server_error[i]]
        want = [jp[i], jst2.m[i], jst2.v[i], jst2.worker_error[i],
                jst2.server_error[i]]
        d = [np.abs(a.numpy() - np.asarray(b)) for a, b in zip(got, want)]
        if not compressed:
            assert max(x.max() for x in d) <= 1e-6, (i, [x.max() for x in d])
            continue
        # The worker's compensated value, and each element's scales
        # (JAX's): where it is at rounding level its sign may flip, and
        # the flip moves what is sent by 2 * scale.
        coeff = 1.0 if not clip else min(
            1.0, clip / (float(jaux["grad_norm"]) + 1e-6))
        comp = 0.9 * m[i] + 0.1 * g[i] * coeff + werr[i]
        s_srv = np.abs(np.asarray(jst2.m[i])).max()
        s_wrk = np.abs(np.asarray(jst2.worker_error[i]) + comp).max()
        ok = np.abs(comp) > FLIP_FLOOR * s_wrk
        bound = 2.5 * LR * max(s_srv, s_wrk) / (np.sqrt(v[i]) + 1e-8)
        assert (d[0][ok] <= 1e-6).all(), (i, d[0][ok].max())
        assert (d[0] <= np.maximum(bound, 1e-6)).all(), i
        for k in (1, 3, 4):
            assert (d[k][ok] <= 1e-6).all() or k == 4, (i, k)
            assert (d[k] <= 2.5 * max(s_srv, s_wrk) + 1e-6).all(), (i, k)


# --------------------------------------------------------------------- #
# The flat step against the leaf-by-leaf reference
# --------------------------------------------------------------------- #
def _rank_threads(dp, fn):
    """``fn(rank, all_reduce)`` on ``dp`` threads, the all-reduce summing
    every rank's tensor in rank order (None at dp 1)."""
    bar = threading.Barrier(dp)
    slots = [None] * dp
    out, errs = [None] * dp, []

    def all_reduce_for(r):
        def all_reduce(t):
            slots[r] = t.clone()
            bar.wait()
            total = slots[0].clone()
            for s in slots[1:]:
                total = total + s
            bar.wait()
            t.copy_(total)
            return t
        return all_reduce

    def run(r):
        try:
            out[r] = fn(r, all_reduce_for(r) if dp > 1 else None)
        except BaseException as e:     # noqa: BLE001
            errs.append(e)
            bar.abort()
    ths = [threading.Thread(target=run, args=(r,)) for r in range(dp)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    if errs:
        raise errs[0]
    return out


@pytest.mark.parametrize("dp", [1, 2, 3, 4])
@pytest.mark.parametrize("phase", ["warmup", "compressed"])
def test_flat_step_matches_reference(dp, phase):
    compressed = phase == "compressed"
    p, _, m, v, _, serr, step = _update_inputs(11, compressed)
    rng = np.random.default_rng(dp)
    g = [[(rng.standard_normal(s) * 0.02).astype(np.float32)
          for s in SHAPES] for _ in range(dp)]
    werr = [[(rng.standard_normal(s) * 0.003).astype(np.float32)
             for s in SHAPES] for _ in range(dp)]

    def cat(xs):
        return torch.cat([_t(x).reshape(-1) for x in xs])

    def rank(r, all_reduce):
        opt = tonebit.OnebitAdam(LR, weight_decay=0.01, freeze_step=FREEZE)
        grp = FlatGroup([_t(x) for x in p], torch.float32,
                        torch.device("cpu"), None)
        st = opt.init([grp], dp)
        for buf, xs in ((grp.grad, g[r]), (st.m[0], m), (st.v[0], v),
                        (st.worker_error[0], werr[r]),
                        (st.server_error[0], serr)):
            buf.copy_(cat(xs))
        st = st._replace(step=torch.tensor(step, dtype=torch.int32))
        lr = torch.tensor(LR)
        st2, norm, overflow = opt.step([grp], st, lr=lr,
                                       compressed=compressed, clip=1.0,
                                       all_reduce=all_reduce)
        ref = tonebit.OnebitState(
            torch.tensor(step, dtype=torch.int32), [_t(x) for x in m],
            [_t(x) for x in v], [_t(x) for x in werr[r]],
            [_t(x) for x in serr])
        rp, rs, aux = tonebit.onebit_reference_step(
            opt, [_t(x) for x in p], [_t(x) for x in g[r]], ref, lr, dp=dp,
            all_reduce=all_reduce, clip=1.0)
        got = [grp.param, st2.m[0], st2.v[0], st2.worker_error[0],
               st2.server_error[0]]
        want = [torch.cat([x.reshape(-1) for x in xs])
                for xs in (rp, rs.m, rs.v, rs.worker_error,
                           rs.server_error)]
        return ([x.numpy().copy() for x in got], [x.numpy() for x in want],
                (int(st2.step), int(rs.step), float(norm),
                 float(aux["grad_norm"]), bool(overflow)))

    res = _rank_threads(dp, rank)
    for got, want, (s1, s2, n1, n2, ovf) in res:
        assert s1 == s2 == step + 1 and not ovf
        assert abs(n1 - n2) <= 4 * _ulp(n2)
        scale = np.abs(want[1]).max()
        for k, (a, b) in enumerate(zip(got, want)):
            mag = np.maximum(np.abs(a), np.abs(b))
            if k >= 3:
                # an error buffer: compensated - scale * sign rounds at
                # the scale's ulp
                mag = np.maximum(mag, scale)
            assert (np.abs(a - b) <= 4 * _ulp(mag)).all(), \
                (k, np.abs(a - b).max())
    # every rank ends with the same params, m, v and server error
    for got, _, _ in res[1:]:
        for k in (0, 1, 2, 4):
            np.testing.assert_array_equal(got[k], res[0][0][k])


# --------------------------------------------------------------------- #
# Overflow
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("phase", ["warmup", "compressed"])
def test_overflow_keeps_every_buffer(phase):
    compressed = phase == "compressed"
    p, g, m, v, werr, serr, step = _update_inputs(5, compressed)
    g[3][1, 2, 0] = np.nan
    st = tonebit.OnebitState(torch.tensor(step, dtype=torch.int32),
                             [_t(x) for x in m], [_t(x) for x in v],
                             [_t(x) for x in werr], [_t(x) for x in serr])
    tp, st2, aux = tonebit.onebit_adam_update(
        [_t(x) for x in g], st, [_t(x) for x in p], lr=LR,
        freeze_step=FREEZE, clip=1.0)
    assert bool(aux["overflow"]) and int(st2.step) == step
    for a, b in zip(tp + st2.m + st2.v + st2.worker_error +
                    st2.server_error, p + m + v + werr + serr):
        np.testing.assert_array_equal(a.numpy(), b)
    # the flat step
    opt = tonebit.OnebitAdam(LR, freeze_step=FREEZE)
    grp = FlatGroup([_t(x) for x in p], torch.float32, torch.device("cpu"),
                    torch.bfloat16)
    fst = opt.init([grp])
    for buf, xs in ((grp.grad, g), (fst.m[0], m), (fst.v[0], v),
                    (fst.worker_error[0], werr), (fst.server_error[0], serr)):
        buf.copy_(torch.cat([_t(x).reshape(-1) for x in xs]))
    fst = fst._replace(step=torch.tensor(step, dtype=torch.int32))
    before = [t.clone() for t in (grp.param, grp.cast, fst.m[0], fst.v[0],
                                  fst.worker_error[0], fst.server_error[0])]
    fst2, norm, overflow = opt.step([grp], fst, lr=torch.tensor(LR),
                                    compressed=compressed, clip=1.0)
    assert bool(overflow) and int(fst2.step) == step
    for a, b in zip((grp.param, grp.cast, fst2.m[0], fst2.v[0],
                     fst2.worker_error[0], fst2.server_error[0]), before):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# The engine against the JAX engine
# --------------------------------------------------------------------- #
def _jax_onebit_leaves(jeng):
    st = jax.device_get(jeng.state.opt_state)
    return {name: [np.asarray(x) for x in jax.tree_util.tree_leaves(
        getattr(st, name))] for name in tonebit.STATE_BUFFERS}, \
        int(st.step)


def _port_onebit_leaves(teng):
    st = teng.state.opt_state
    return {name: [x.detach().numpy().copy() for x in
                   teng._group_bufs_to_leaves(list(getattr(st, name)))]
            for name in tonebit.STATE_BUFFERS}, int(st.step)


def _force_port_state(teng, jeng):
    """The port's params and 1-bit state set to the JAX engine's."""
    leaves, step = _jax_onebit_leaves(jeng)
    bufs = {name: teng._leaves_to_group_bufs(
        [x[0] if name == "worker_error" else x for x in xs])
        for name, xs in leaves.items()}
    teng.set_train_state(
        jax.tree_util.tree_map(np.asarray,
                               jax.device_get(jeng.state.params)),
        tonebit.OnebitState(step=step, **bufs),
        step=int(jeng.state.step), loss_scale=float(jeng.state.loss_scale),
        growth_count=int(jeng.state.growth_count),
        hysteresis=int(jeng.state.hysteresis),
        skipped_steps=int(jeng.state.skipped_steps))


def _assert_compressed_params(precision, teng, jeng, v_leaves, m_leaves):
    """Params after a compressed step from the same state. Each element
    moves by ``u = lr * scale / (sqrt(v) + eps)`` (``scale`` the |m| its
    chunk sent, bounded here by the largest of its leaf), which is large
    where the frozen variance is small, so the two programs are held to
    the precision's tolerance plus 1e-5 of ``u`` (the scales are sums in
    other orders); where a sign flipped, within ``2.5 * u``, and outside
    the key bias at most ``MAX_FLIP_SHARE`` of the elements."""
    H = engine_cfgs("fp32")[0].hidden_size
    jl = jax.tree_util.tree_leaves(jax.device_get(jeng.state.params))
    flips = total = 0
    for path, a, b, v, m in zip(_leaf_paths(teng.state.params),
                                tree_flatten(teng.state.params)[0], jl,
                                v_leaves, m_leaves):
        d = np.abs(flat([a]) - flat([b])).reshape(tuple(a.shape))
        u = LR * np.abs(m).max() / (np.sqrt(v) + 1e-8)
        assert (d <= 2.5 * u + ATOL[precision]).all(), (path, d.max())
        bad = d > ATOL[precision] + 1e-5 * u
        if path.endswith("qkv_bias"):
            bad[..., H:2 * H] = False
        flips += int(bad.sum())
        total += d.size
    assert flips <= MAX_FLIP_SHARE * total, (flips, total)


@pytest.mark.parametrize("precision", ["fp32", "fp16", "bf16"])
def test_engine_across_freeze_matches_jax(precision, params_np):
    ds = engine_ds(precision, ONEBIT)
    skips = FP16_SKIPS if precision == "fp16" else 0
    warm = skips + FREEZE
    batches = engine_batches(warm + 2)
    jeng = jax_engine(precision, ds, params_np)
    teng = port_engine(precision, ds, params_np)
    assert teng._onebit and type(teng.optimizer).__name__ == "OnebitAdam"
    jh = jax_history(jeng, batches[:warm])
    th = port_history(teng, batches[:warm])
    assert teng.onebit_comm_bytes == tonebit.step_comm_bytes(
        [int(np.prod(s)) for s in teng._leaf_shapes], 1, False)
    # the warmup: losses, fp16 scales and skips, params, state
    np.testing.assert_allclose([h[0] for h in th], [h[0] for h in jh],
                               rtol=RTOL[precision])
    assert [h[1:] for h in th] == [h[1:] for h in jh]
    if precision == "fp16":
        assert jh[skips - 1][2] == skips and jh[-1][2] == skips, jh
    jl = jax.tree_util.tree_leaves(jax.device_get(jeng.state.params))
    for a, b in zip(tree_flatten(teng.state.params)[0], jl):
        np.testing.assert_allclose(flat([a]), flat([b]),
                                   atol=ATOL[precision])
    (tb, ts), (jb, js) = _port_onebit_leaves(teng), _jax_onebit_leaves(jeng)
    assert ts == js == FREEZE
    # the first compressed step's loss (before its update)
    jl5 = float(jeng.train_batch(batches[warm]))
    tl5 = float(teng.train_batch(batches[warm]))
    np.testing.assert_allclose(tl5, jl5, rtol=RTOL[precision])
    assert int(teng.state.opt_state.step) == FREEZE + 1
    assert teng.onebit_comm_bytes == tonebit.step_comm_bytes(
        [int(np.prod(s)) for s in teng._leaf_shapes], 1, True)
    # one more compressed step from JAX's state on both
    _force_port_state(teng, jeng)
    v_before = [t.clone() for t in teng.state.opt_state.v]
    jv = _jax_onebit_leaves(jeng)[0]["v"]
    jeng.train_batch(batches[warm + 1])
    teng.train_batch(batches[warm + 1])
    for a, b in zip(teng.state.opt_state.v, v_before):
        assert torch.equal(a, b)
    _assert_compressed_params(precision, teng, jeng, jv,
                              _jax_onebit_leaves(jeng)[0]["m"])
    werr = _port_onebit_leaves(teng)[0]["worker_error"]
    assert max(np.abs(x).max() for x in werr) > 0


EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "gpt2", "ds_config_onebit.json")


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_example_config_trains_past_freeze(precision, params_np):
    """``examples/gpt2/ds_config_onebit.json`` (8 rows at gas 1, clip 1.0,
    lr 0.002, freeze_step 20) on gpt2-tiny, both engines: bf16 from the
    file's path as it is, fp32 with its bf16 block off. The 20 warmup
    steps' losses and the params after them as the training tolerances
    (fp32 1e-5), the 21st loss (before the first compressed update) too;
    then the step compresses and the loss stays finite."""
    with open(EXAMPLE) as f:
        ds = json.load(f)
    freeze = ds["optimizer"]["params"]["freeze_step"]
    config = EXAMPLE if precision == "bf16" else dict(ds,
                                                      bf16={"enabled": False})
    batches = engine_batches(freeze + 1, rows=ds["train_batch_size"])
    jeng = jax_engine(precision, config, params_np)
    teng = port_engine(precision, config, params_np)
    jh = jax_history(jeng, batches[:freeze])
    th = port_history(teng, batches[:freeze])
    np.testing.assert_allclose([h[0] for h in th], [h[0] for h in jh],
                               rtol=RTOL[precision])
    # (20 Adam steps at lr 0.002 turn rounding-level grads into O(lr)
    # moves: 2 of 131,072 elements of one leaf read 1.10e-5 in fp32)
    assert_params(precision, teng, jeng, ds["optimizer"]["params"]["lr"],
                  sign_flips=True, steps=freeze)
    np.testing.assert_allclose(float(teng.train_batch(batches[freeze])),
                               float(jeng.train_batch(batches[freeze])),
                               rtol=RTOL[precision])
    assert int(teng.state.opt_state.step) == freeze + 1
    assert teng.onebit_comm_bytes < 4 * teng._groups[0].numel // 16
    assert np.isfinite(float(teng.last_metrics["grad_norm"]))


def test_engine_overflow_skips_in_both_phases(params_np):
    """A non-finite loss (NaN in the embedding) skips the step: params,
    every state buffer and the 1-bit step kept, the skip counted; in
    warmup and after the freeze."""
    ds = engine_ds("fp32", ONEBIT)
    teng = port_engine("fp32", ds, params_np)
    batches = engine_batches(FREEZE + 2)
    for phase_steps in (1, FREEZE + 1):
        while teng.global_steps < phase_steps:
            teng.train_batch(batches[teng.global_steps])
        wte = teng.state.params["wte"]
        saved_row = wte[0].clone()
        before = [t.clone() for t in teng._groups[0].param.unsqueeze(0)]
        bufs = _port_onebit_leaves(teng)[0]
        with torch.no_grad():
            wte[0].fill_(float("nan"))
        nan_params = teng._groups[0].param.clone()
        step = int(teng.state.opt_state.step)
        skipped = int(teng.state.skipped_steps)
        batch = batches[0].copy()
        batch[:, 0] = 0
        teng.train_batch(batch)
        assert bool(teng.last_metrics["overflow"])
        assert int(teng.state.opt_state.step) == step
        assert int(teng.state.skipped_steps) == skipped + 1
        assert torch.equal(teng._groups[0].param.isnan(),
                           nan_params.isnan())
        for k, xs in _port_onebit_leaves(teng)[0].items():
            for a, b in zip(xs, bufs[k]):
                np.testing.assert_array_equal(a, b)
        with torch.no_grad():
            wte[0].copy_(saved_row)
        assert torch.equal(teng._groups[0].param, before[0])


def test_refusals(params_np):
    base = dict(engine_ds("fp32", ONEBIT))
    with pytest.raises(ValueError, match="ZeRO stage 0"):
        port_engine("fp32", dict(base, zero_optimization={"stage": 1}),
                    params_np)
    with pytest.raises(ValueError, match="master-free"):
        port_engine("bf16", dict(base, bf16={"enabled": True,
                                             "stochastic_rounding": True}),
                    params_np)
    with pytest.raises(ValueError, match="OnebitAdam"):
        port_engine("fp32", dict(base, sparse_gradients=True), params_np)
    eng = port_engine("fp32", base, params_np)
    mb = engine_batches(1, rows=2)[0]
    for call in (lambda: eng.forward(mb), lambda: eng.backward(),
                 lambda: eng.step()):
        with pytest.raises(NotImplementedError, match="train_batch"):
            call()
    # eval_batch works
    assert np.isfinite(float(eng.eval_batch(mb)))


# --------------------------------------------------------------------- #
# Checkpoints
# --------------------------------------------------------------------- #
def _assert_states_equal(a, b):
    (ab, astep), (bb, bstep) = a, b
    assert astep == bstep
    for name in tonebit.STATE_BUFFERS:
        for x, y in zip(ab[name], bb[name]):
            np.testing.assert_array_equal(np.asarray(x).reshape(-1),
                                          np.asarray(y).reshape(-1))


def test_checkpoint_both_ways(params_np, tmp_path):
    ds = engine_ds("fp32", ONEBIT)
    batches = engine_batches(FREEZE + 3)
    head, nxt = batches[:FREEZE + 2], batches[FREEZE + 2]
    jeng = jax_engine("fp32", ds, params_np)
    jax_history(jeng, head)
    jeng.save_checkpoint(str(tmp_path / "jax"))
    teng = port_engine("fp32", ds, params_np)
    port_history(teng, head)
    teng.save_checkpoint(str(tmp_path / "port"))
    # JAX save -> port: the state bit for bit, the next loss
    tres = port_engine("fp32", ds, params_np)
    assert tres.load_checkpoint(str(tmp_path / "jax"))[0] is not None
    _assert_states_equal(_port_onebit_leaves(tres), _jax_onebit_leaves(jeng))
    assert max(np.abs(x).max() for x in
               _port_onebit_leaves(tres)[0]["worker_error"]) > 0
    for a, b in zip(tree_flatten(tres.state.params)[0],
                    jax.tree_util.tree_leaves(
                        jax.device_get(jeng.state.params))):
        np.testing.assert_array_equal(flat([a]), flat([b]))
    np.testing.assert_allclose(float(tres.train_batch(nxt)),
                               float(jeng.train_batch(nxt)), rtol=1e-5)
    assert tres.global_steps == jeng.global_steps
    # port save -> JAX: the state bit for bit, the next loss
    jres = jax_engine("fp32", ds, params_np)
    assert jres.load_checkpoint(str(tmp_path / "port"))[0] is not None
    _assert_states_equal(_jax_onebit_leaves(jres), _port_onebit_leaves(teng))
    np.testing.assert_allclose(float(jres.train_batch(nxt)),
                               float(teng.train_batch(nxt)), rtol=1e-5)


def test_load_at_another_dp_keeps_fresh_worker_error(params_np, tmp_path):
    """A JAX save from a dp 2 mesh loads into the port at dp 1: m, v, the
    server error and the step load; the worker error (saved [2, ...])
    keeps its current, fresh value with a warning per leaf, as the JAX
    engine keeps a leaf whose saved shape differs."""
    from deepspeed_tpu.parallel.topology import build_mesh
    import deepspeed_tpu
    from deepspeed_tpu.models import gpt2 as jgpt2
    from deepspeed_tpu.models.transformer import dense_attention as jdense
    ds = dict(engine_ds("fp32", ONEBIT), train_batch_size=8)
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(engine_cfgs("fp32")[1],
                                 attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params_np),
        config=ds, mesh=build_mesh(devices=jax.devices()[:2]))
    for b in engine_batches(FREEZE + 2, rows=8):
        eng.train_batch(b)
    eng.save_checkpoint(str(tmp_path))
    jb, jstep = _jax_onebit_leaves(eng)
    assert jb["worker_error"][0].shape[0] == 2
    teng = port_engine("fp32", dict(ds, train_batch_size=4), params_np)
    from deepspeed_tpu_torch.utils.logging import logger
    warned = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda rec: warned.append(rec.getMessage())
    logger.addHandler(handler)
    try:
        assert teng.load_checkpoint(str(tmp_path))[0] is not None
    finally:
        logger.removeHandler(handler)
    tb, tstep = _port_onebit_leaves(teng)
    assert tstep == jstep
    for name in ("m", "v", "server_error"):
        for x, y in zip(tb[name], jb[name]):
            np.testing.assert_array_equal(x, y)
    assert all(not x.any() for x in tb["worker_error"])
    assert sum("keeping current value" in w for w in warned) == \
        len(tb["worker_error"])
    assert np.isfinite(float(teng.train_batch(engine_batches(1)[0])))
