"""The port's training slice against the JAX package on gpt2-tiny:
the chunked cross-entropy head, the GPT-2 loss and its gradients, and
``initialize()`` → ``train_batch`` against the JAX ``DeepSpeedEngine``
on a one-device mesh, from the same parameters (``models/convert.py``).

Both sides: dropout 0, ``attention_fn=dense_attention`` on the JAX side
(the port's CPU default, ``auto_attention``, is dense attention), fused
AdamW, WarmupLR, gradient clipping 1.0, gas 2, 5 steps. Tolerances:

- chunked CE: loss and both gradients within 1e-5 (fp32);
- GPT-2 loss within 1e-5 relative, every gradient within 1e-5 of the
  largest gradient of its leaf (fp32), with dense attention and — at
  S = 128 — with flash attention on both sides (the JAX Pallas kernels in
  interpret mode, the port's plain versions through its autograd
  Function; measured gaps in ROADMAP §3);
- fp32 engine, JAX kernels on (Pallas interpret): every step's loss
  within 1e-5 relative, final params within 1e-5 absolute (lr 1e-4);
  the same over 3 steps with ``gelu_exact=True`` (the erf form);
- fp16 engine from initial_scale_power 32: skipped-step count and
  loss-scale sequence equal, losses within 1e-3 relative;
- bf16 engine with fp32 masters: losses within 1e-2 relative;
- a JAX mid-run state (params and ``FusedAdamState``) carried into the
  port resumes with the next steps' losses within 1e-5 relative, and the
  conversion round-trips bit for bit.

The fp16 and bf16 JAX engines run with ``fused_kernels=False``: the JAX
package documents both settings as the same arithmetic
(``models/transformer.py``) and the Pallas kernels themselves are held
in tests/test_torch_training_kernels.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.ops.flash_attention import flash_attention as jflash
from deepspeed_tpu.ops import cross_entropy as jce
from deepspeed_tpu.ops.fused_update import leaf_moment_views
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import cross_entropy as tce
from deepspeed_tpu_torch.ops.flash_attention import flash_attention as tflash
from deepspeed_tpu_torch.ops.fused_update import tree_flatten

STEPS = 5
RESUME_AT = 3
PRECISIONS = {"fp32": (torch.float32, jnp.float32),
              "fp16": (torch.float16, jnp.float16),
              "bf16": (torch.bfloat16, jnp.bfloat16)}


def _cfgs(precision):
    tdt, jdt = PRECISIONS[precision]
    off = dict(hidden_dropout=0.0, attn_dropout=0.0)
    return (dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=tdt,
                                **off),
            dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=jdt,
                                fused_kernels=precision == "fp32", **off))


def _ds(precision):
    ds = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-4, "weight_decay": 0.01}},
          "scheduler": {"type": "WarmupLR", "params": {
              "warmup_num_steps": 3, "warmup_max_lr": 1e-4}}}
    if precision == "fp16":
        ds["fp16"] = {"enabled": True, "initial_scale_power": 32}
    if precision == "bf16":
        ds["bf16"] = {"enabled": True}
    return ds


def _batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, (4, 33)).astype(np.int32)
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def params_np():
    return jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0), _cfgs("fp32")[1]))


def _jax_run(precision, params_np, snapshot_at=None):
    _, jcfg = _cfgs(precision)
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params_np),
        config=_ds(precision), mesh=build_mesh(devices=jax.devices()[:1]))
    hist, snap = [], None
    for i, b in enumerate(_batches()):
        if i == snapshot_at:
            st = jax.device_get(eng.state)
            snap = dict(params=st.params, count=st.opt_state.count,
                        m=st.opt_state.m, v=st.opt_state.v, step=st.step,
                        jstate=eng.state.opt_state,
                        jparams=eng.state.params)
        loss = float(eng.train_batch(b))
        hist.append((loss, float(eng.state.loss_scale),
                     int(eng.state.skipped_steps)))
    return hist, jax.device_get(eng.state.params), snap


def _port_engine(precision, params_np):
    tcfg, _ = _cfgs(precision)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg),
        model_params=convert.from_jax_params(params_np),
        config=_ds(precision), device="cpu")
    return eng


def _port_run(eng, batches):
    hist = []
    for b in batches:
        loss = float(eng.train_batch(b))
        hist.append((loss, float(eng.state.loss_scale),
                     int(eng.state.skipped_steps)))
    return hist


@pytest.fixture(scope="module")
def fp32_runs(params_np):
    jhist, jparams, snap = _jax_run("fp32", params_np,
                                    snapshot_at=RESUME_AT)
    eng = _port_engine("fp32", params_np)
    thist = _port_run(eng, _batches())
    return jhist, jparams, snap, thist, eng


def test_chunked_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((48, 32)).astype(np.float32)
    w = (rng.standard_normal((100, 32)) * 0.3).astype(np.float32)
    t = rng.integers(0, 100, 48)
    jl, (jdx, jdw) = jax.value_and_grad(
        lambda a, b: jce.chunked_softmax_xent(a, b, jnp.asarray(t), 4),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = tce.chunked_softmax_xent(xt, wt, torch.from_numpy(t), 4)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), atol=1e-5)
    assert tce.pick_chunks(8192, 50304) == jce.pick_chunks(8192, 50304) == 4


def _loss_and_grads_match(params_np, batch, jattn, tattn):
    tcfg, jcfg = _cfgs("fp32")
    jl, jg = jax.value_and_grad(
        lambda p: jgpt2.gpt2_loss_fn(jcfg, attention_fn=jattn)(
            p, jnp.asarray(batch), None))(
        jax.tree_util.tree_map(jnp.asarray, params_np))
    tp = convert.from_jax_params(params_np)
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_()
    loss = tgpt2.gpt2_loss_fn(tcfg, attention_fn=tattn)(
        tp, torch.from_numpy(batch), None)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for g, jgl in zip(grads, jax.tree_util.tree_leaves(jg)):
        jgl = np.asarray(jgl)
        np.testing.assert_allclose(g.numpy(), jgl,
                                   atol=1e-5 * np.abs(jgl).max())


def test_gpt2_loss_and_grads_match_jax(params_np):
    _loss_and_grads_match(params_np, _batches()[0], jdense, None)
    assert tgpt2.gpt2_flops_per_token(tgpt2.GPT2_CONFIGS["gpt2-small"]) == \
        jgpt2.gpt2_flops_per_token(jgpt2.GPT2_CONFIGS["gpt2-small"])


def test_gpt2_loss_and_grads_with_flash_match_jax(params_np):
    """S = 128: the flash path on both sides (fused backward)."""
    batch = np.random.default_rng(0).integers(0, 512, (2, 129)) \
        .astype(np.int32)
    _loss_and_grads_match(params_np, batch, jflash, tflash)


def test_fp32_train_batch_matches_jax_engine(fp32_runs):
    jhist, jparams, _, thist, eng = fp32_runs
    np.testing.assert_allclose([h[0] for h in thist], [h[0] for h in jhist],
                               rtol=1e-5)
    for t, j in zip(tree_flatten(eng.state.params)[0],
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=1e-5)
    assert int(eng.state.step) == STEPS and eng.global_steps == STEPS


def test_fp32_train_batch_gelu_exact_matches_jax_engine(params_np):
    """``gelu_exact=True`` (the erf form; JAX kernels on, Pallas
    interpret) for 3 steps: losses within 1e-5 relative, final params
    within 1e-5."""
    tcfg, jcfg = (dataclasses.replace(c, gelu_exact=True)
                  for c in _cfgs("fp32"))
    batches = _batches()[:3]
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params_np),
        config=_ds("fp32"), mesh=build_mesh(devices=jax.devices()[:1]))
    jl = [float(jeng.train_batch(b)) for b in batches]
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg),
        model_params=convert.from_jax_params(params_np),
        config=_ds("fp32"), device="cpu")
    tl = [float(teng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for t, j in zip(tree_flatten(teng.state.params)[0],
                    jax.tree_util.tree_leaves(
                        jax.device_get(jeng.state.params))):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=1e-5)


def test_fp16_skips_and_loss_scales_match_jax(params_np):
    jhist, _, _ = _jax_run("fp16", params_np)
    thist = _port_run(_port_engine("fp16", params_np), _batches())
    assert [h[1:] for h in thist] == [h[1:] for h in jhist]
    assert thist[-1][2] > 0                      # 2^32 overflows in fp16
    np.testing.assert_allclose([h[0] for h in thist], [h[0] for h in jhist],
                               rtol=1e-3)


def test_bf16_master_losses_match_jax(params_np):
    jhist, _, _ = _jax_run("bf16", params_np)
    eng = _port_engine("bf16", params_np)
    thist = _port_run(eng, _batches())
    np.testing.assert_allclose([h[0] for h in thist], [h[0] for h in jhist],
                               rtol=1e-2)
    # fp32 masters, a bf16 copy refreshed by the optimizer pass
    master = tree_flatten(eng.state.params)[0]
    cast = tree_flatten(eng.state.cast_params)[0]
    assert all(m.dtype == torch.float32 for m in master)
    assert all(torch.equal(c, m.to(torch.bfloat16))
               for c, m in zip(cast, master))


def test_fused_adam_state_conversion_round_trips(fp32_runs):
    snap = fp32_runs[2]
    params = snap["params"]
    ported = convert.from_jax_fused_adam_state(snap["count"], snap["m"],
                                               snap["v"], params)
    count, m, v = convert.to_jax_fused_adam_state(ported, params)
    assert count == snap["count"]
    for a, b in zip(m + v, tuple(snap["m"]) + tuple(snap["v"])):
        np.testing.assert_array_equal(a, b)
    # the port's flat layout is the per-leaf moments, concatenated
    jm, jv = leaf_moment_views(snap["jstate"], snap["jparams"])
    for flat, tree in ((ported.m[0], jm), (ported.v[0], jv)):
        want = np.concatenate([np.asarray(l).reshape(-1)
                               for l in jax.tree_util.tree_leaves(tree)])
        np.testing.assert_array_equal(flat, want)


def test_resume_from_a_converted_jax_mid_run_state(fp32_runs, params_np):
    jhist, _, snap, _, _ = fp32_runs
    eng = _port_engine("fp32", params_np)
    eng.set_train_state(
        params=snap["params"],
        opt_state=convert.from_jax_fused_adam_state(
            snap["count"], snap["m"], snap["v"], snap["params"]),
        step=int(snap["step"]))
    thist = _port_run(eng, _batches()[RESUME_AT:])
    np.testing.assert_allclose([h[0] for h in thist],
                               [h[0] for h in jhist[RESUME_AT:]], rtol=1e-5)
