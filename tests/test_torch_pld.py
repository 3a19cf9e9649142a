"""Progressive layer drop in the port (``runtime/progressive_layer_drop.py``,
``models/transformer.apply_blocks``'s ``pld_theta`` and ``layer_valid``,
the engine's ``progressive_layer_drop`` block) against the JAX package.

- ``theta_at`` at steps {0, 1, 10, 10^6}: exactly JAX's (fp64 on both
  sides for an int step).
- A pinned keep vector: the port's ``apply_blocks(layer_valid=keep)``
  against JAX's, output and gradients within 1e-5 of the largest
  magnitude (fp32, 4 layers). The keep draws themselves differ from
  JAX's (other generators), so they are not compared.
- theta = 1 keeps every layer: bit-equal to no PLD at dropout 0.1.
- Each layer's keep frequency over 400 draws within 4.5 binomial
  standard deviations of ``1 - (l+1)/L * (1 - theta)`` (plus 1/n).
- A skipped layer runs no block (no LayerNorm call) and its params'
  gradients are zero; the engine with PLD trains (the loss falls), a
  resume repeats the draws, MoE with PLD raises (as in JAX), and a loss
  without ``pld_theta`` trains with JAX's warning.
"""
import dataclasses
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop as JPLD
from deepspeed_tpu_torch import moe as tmoe
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop as TPLD
from deepspeed_tpu_torch.utils.logging import logger
from torch_jax_native import jax_native  # noqa: F401 (autouse)

TCFG = dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"],
                           dtype=torch.float32)
PLD = {"enabled": True, "theta": 0.5, "gamma": 0.1}


def recording_loss(cfg):
    """``gpt2_loss_fn(cfg)`` that also records the layers each call keeps
    (``pld_keep`` on the generator it is handed, which it does not
    advance)."""
    inner, log = tgpt2.gpt2_loss_fn(cfg), []

    def loss_fn(params, batch, rng=None, pld_theta=None):
        if pld_theta is not None and rng is not None:
            keep = tt.pld_keep(cfg.num_layers, pld_theta, rng)
            log.append(tuple(i for i, k in enumerate(keep) if k))
        return inner(params, batch, rng, pld_theta=pld_theta)
    return loss_fn, log


@pytest.mark.parametrize("step", [0, 1, 10, 10 ** 6])
def test_theta_at_matches_jax(step):
    for theta, gamma in ((0.5, 0.001), (0.25, 0.01), (1.0, 0.001)):
        assert TPLD(theta, gamma).theta_at(step) == \
            JPLD(theta, gamma).theta_at(step)


def test_schedule_state_matches_jax():
    t, j = TPLD(0.5, 0.01), JPLD(0.5, 0.01)
    assert t.get_theta() == j.get_theta() == 1.0
    for step in (3, 40):
        t.update_state(step)
        j.update_state(step)
        assert t.get_state() == j.get_state()
    ds = {"train_batch_size": 8, "progressive_layer_drop": PLD}
    tc = tconfig.DeepSpeedConfig(ds, world_size=1).pld_config
    jc = jconfig.DeepSpeedConfig(ds, world_size=1).pld_config
    assert vars(tc) == vars(jc)
    assert not tconfig.DeepSpeedConfig(
        {"train_batch_size": 8}, world_size=1).pld_config.enabled


@pytest.mark.parametrize("keep", [[1, 0, 1, 1], [0, 1, 1, 0], [0, 0, 0, 0]])
def test_pinned_keep_vector_matches_jax_layer_valid(keep):
    jcfg = dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"], num_layers=4,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(TCFG, num_layers=4)
    stacked = jax.tree_util.tree_map(
        np.asarray, jt.init_block_params(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(sum(keep))
    x = rng.standard_normal((2, 16, 128)).astype(np.float32)
    dy = rng.standard_normal((2, 16, 128)).astype(np.float32)

    def jfn(p, xx):
        return jnp.sum(jt.apply_blocks(p, xx, jcfg,
                                       layer_valid=jnp.asarray(keep)) * dy)
    jy = jt.apply_blocks(jax.tree_util.tree_map(jnp.asarray, stacked),
                         jnp.asarray(x), jcfg, layer_valid=jnp.asarray(keep))
    jgp, jgx = jax.grad(jfn, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, stacked), jnp.asarray(x))
    tp = convert.from_jax_params(stacked)
    for t in tp.values():
        t.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    ty = tt.apply_blocks(tp, xt, tcfg, layer_valid=keep)
    inputs = [xt] + list(tp.values())
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        inputs, torch.autograd.grad((ty * torch.from_numpy(dy)).sum(),
                                    inputs, allow_unused=True))]
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-5 * np.abs(np.asarray(jy)).max())
    want = [np.asarray(jgx)] + [np.asarray(jgp[k]) for k in tp]
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30))
    for layer, k in enumerate(keep):
        if not k:       # a skipped layer's params get zero gradients
            assert all(float(g[layer].abs().max()) == 0.0
                       for g in grads[1:])


def _params():
    return tt.init_block_params(TCFG, torch.Generator().manual_seed(0),
                                "cpu")


def test_theta_one_is_no_pld_bit_equal():
    params = _params()
    x = torch.randn(2, 32, 128, generator=torch.Generator().manual_seed(2))
    outs = []
    for theta in (None, 1.0):
        outs.append(tt.apply_blocks(params, x, TCFG,
                                    rng=torch.Generator().manual_seed(4),
                                    deterministic=False, pld_theta=theta))
    assert tt.pld_keep(2, 1.0, torch.Generator().manual_seed(4)) == \
        [True, True]
    assert torch.equal(outs[0], outs[1])


def test_keep_frequency_tracks_theta():
    """Per-layer frequency over n = 400 draws (fresh generator states, as
    the micro-steps give) within 4.5 binomial standard deviations plus
    1/n of ``1 - (l+1)/L (1 - theta)``."""
    L, theta, n = 8, 0.3, 400
    hits = np.zeros(L)
    for s in range(n):
        hits += tt.pld_keep(L, theta, torch.Generator().manual_seed(s))
    for l in range(L):
        p = 1.0 - (l + 1) / L * (1.0 - theta)
        bound = 4.5 * math.sqrt(p * (1 - p) / n) + 1.0 / n
        assert abs(hits[l] / n - p) <= bound, (l, hits[l] / n, p, bound)
    # deeper layers drop more often, as the schedule says
    assert hits[0] > hits[-1]


def test_skipped_layer_runs_no_block():
    """With 8 layers and theta 0.3, draws that skip layers: the
    LayerNorm calls count the kept layers exactly (two a kept layer),
    and a skipped layer's params get zero gradients."""
    cfg = dataclasses.replace(TCFG, num_layers=8)
    params = tt.init_block_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    for t in params.values():
        t.requires_grad_()
    calls = {"n": 0}
    base = tt.KERNEL_OPS

    def counted(*a, **k):
        calls["n"] += 1
        return base.ln(*a, **k)
    ops = base._replace(ln=counted)
    x = torch.randn(2, 32, 128, generator=torch.Generator().manual_seed(2))
    skipped = 0
    for seed in range(4):
        calls["n"] = 0
        y = tt.apply_blocks(params, x, cfg,
                            rng=torch.Generator().manual_seed(seed),
                            deterministic=False, ops=ops, pld_theta=0.3)
        kept = [i for i, k in enumerate(tt.pld_keep(
            8, 0.3, torch.Generator().manual_seed(seed))) if k]
        assert calls["n"] == len(kept)
        grads = torch.autograd.grad(y.sum(), list(params.values()))
        for layer in set(range(8)) - set(kept):
            skipped += 1
            assert all(float(g[layer].abs().max()) == 0.0 for g in grads)
        for layer in kept:
            assert float(grads[0][layer].abs().max()) > 0.0
    assert skipped > 0


def test_moe_with_pld_raises_as_in_jax():
    cfg = dataclasses.replace(TCFG, moe=tmoe.MoEConfig(num_experts=4))
    params = tt.init_block_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    x = torch.zeros(1, 8, 128)
    for kw in ({"pld_theta": 0.5, "rng": torch.Generator()},
               {"layer_valid": [1, 1]}):
        with pytest.raises(ValueError, match="do not compose with "
                           "progressive layer drop"):
            tt.apply_blocks(params, x, cfg, deterministic=False, **kw)


# --------------------------------------------------------------------- #
# The engine
# --------------------------------------------------------------------- #
def _ds(extra=None):
    ds = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "steps_per_print": 10 ** 9,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
          "progressive_layer_drop": PLD}
    ds.update(extra or {})
    return ds


def _engine(cfg=TCFG, ds=None, loss_fn=None):
    return deepspeed_tpu_torch.initialize(
        model=loss_fn or recording_loss(cfg)[0],
        model_params=tgpt2.gpt2_init(cfg, torch.Generator().manual_seed(0),
                                     "cpu"),
        config=ds or _ds(), device="cpu", rng=11)[0]


BATCH = np.random.default_rng(0).integers(0, 64, (4, 65))


@pytest.mark.parametrize("extra", [None, {"zero_optimization": {
    "stage": 2, "cpu_offload": True}}], ids=["device", "offload"])
def test_engine_with_pld_trains(extra):
    """gpt2-tiny (2 layers; theta 0.5, gamma 0.1: theta falls from 1 to
    0.69 over 8 steps) on one repeated batch: the engine hands theta to
    the loss on the one-card path and the offload path, layers drop, and
    the loss falls."""
    loss_fn, log = recording_loss(TCFG)
    eng = _engine(ds=_ds(extra), loss_fn=loss_fn)
    assert eng._accepts_pld and eng.progressive_layer_drop is not None
    losses = [float(eng.train_batch(BATCH)) for _ in range(8)]
    assert len(log) == 16            # two micro-steps a step
    assert any(len(k) < 2 for k in log)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert eng.progressive_layer_drop.get_theta() == \
        eng.progressive_layer_drop.theta_at(8)


def test_resume_repeats_the_pld_draws(tmp_path):
    loss_fn, first = recording_loss(TCFG)
    eng = _engine(loss_fn=loss_fn)
    losses = [float(eng.train_batch(BATCH)) for _ in range(2)]
    eng.save_checkpoint(str(tmp_path))
    losses += [float(eng.train_batch(BATCH)) for _ in range(3)]
    loss_fn, log = recording_loss(TCFG)
    again = _engine(loss_fn=loss_fn)
    again.load_checkpoint(str(tmp_path))
    resumed = [float(again.train_batch(BATCH)) for _ in range(3)]
    assert log == first[4:] and any(len(k) < 2 for k in log)
    assert resumed == losses[2:]


def test_loss_without_pld_theta_trains_with_a_warning():
    inner = tgpt2.gpt2_loss_fn(TCFG)

    def loss_fn(params, batch, rng=None):
        return inner(params, batch, rng)
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logger.addHandler(handler)
    try:
        eng = _engine(loss_fn=loss_fn)
    finally:
        logger.removeHandler(handler)
    assert not eng._accepts_pld
    assert any("takes no pld_theta" in m for m in seen), seen
    assert np.isfinite(float(eng.train_batch(BATCH)))


def test_remat_and_pld_compose():
    """``full`` with PLD: the same losses, bit for bit, as ``none`` with
    PLD (the keep draws come from the generator's state, which remat
    does not move)."""
    out = []
    for policy in ("none", "full"):
        loss_fn, log = recording_loss(dataclasses.replace(
            TCFG, remat_policy=policy))
        eng = _engine(loss_fn=loss_fn)
        out.append(([float(eng.train_batch(BATCH)) for _ in range(3)], log))
    assert out[0] == out[1]
