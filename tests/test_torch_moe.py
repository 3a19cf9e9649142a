"""The port's MoE at expert-parallel size 1 (``moe/layer.py``, the MoE
blocks of ``models/transformer.py``, ``gpt2_loss_fn``'s aux losses and
the engine's ``moe_*`` metrics) against the JAX package on the CPU, from
the same numpy inputs and the same weights (``models/convert.py``).

The strict checks run in fp32, where the two sides route every token
alike: routing is a discrete choice, and in bf16 a rounding difference
in the hidden state can flip a near-tie between two experts. The bf16
check therefore first asserts that both sides made the same routing
(expert choices, gates within 1e-6, the same drops), then holds the
outputs to the bf16 tolerance.

Tolerances: fp32 outputs, stats and gradients within 1e-5 of the
largest magnitude of their leaf (losses 1e-5 relative); expert token
counts and drop fractions equal; bf16 outputs 2 ulp floored at 1e-5
(tests/torch_cases.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import moe as jmoe
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu_torch import moe as tmoe
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.ops.fused_update import tree_flatten
from deepspeed_tpu_torch.runtime import config as tconfig
from torch_cases import assert_close

STEPS = 5
E, K_TOP, CF = 8, 2, 1.25


def _moe(pkg, **kw):
    base = dict(num_experts=E, top_k=K_TOP, capacity_factor=CF)
    base.update(kw)
    return pkg.MoEConfig(**base)


def _cfgs(freq=1, grouped="auto", **moe_kw):
    off = dict(hidden_dropout=0.0, attn_dropout=0.0)
    tcfg = dataclasses.replace(
        tgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32,
        moe=_moe(tmoe, grouped_gemm=grouped, **moe_kw), moe_layer_freq=freq,
        **off)
    jcfg = dataclasses.replace(
        jgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=jnp.float32,
        moe=_moe(jmoe, grouped_gemm=grouped, **moe_kw), moe_layer_freq=freq,
        scan_layers=freq == 1, fused_kernels=False, **off)
    return tcfg, jcfg


def _jax_params(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(seed), jcfg))


# --------------------------------------------------------------------- #
# Routing
# --------------------------------------------------------------------- #
def test_capacity_and_layer_indices_match_jax():
    for args in [(128, 8, 2, 1.0), (128, 8, 2, 1.25), (128, 8, 1, np.inf),
                 (128, 8, 2, 100.0), (4, 8, 1, 0.1), (8192, 8, 2, 1.25),
                 (64, 8, 2, 1.25)]:
        assert tlayer.expert_capacity(*args) == \
            jlayer.expert_capacity(*args), args
    assert tlayer.expert_capacity(8192, 8, 2, 1.25) == 2560
    for L in range(1, 7):
        for freq in range(1, 4):
            assert tlayer.moe_layer_indices(L, freq) == \
                jlayer.moe_layer_indices(L, freq)


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_topk_matches_jax(top_k):
    rng = np.random.default_rng(top_k)
    x = rng.standard_normal((96, 64)).astype(np.float32)
    w = (rng.standard_normal((64, E)) * 0.3).astype(np.float32)
    got = tlayer.router_topk(torch.from_numpy(x), torch.from_numpy(w), top_k)
    want = jlayer.router_topk(jnp.asarray(x), jnp.asarray(w), top_k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, j in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-6,
                                   rtol=1e-5)
    if top_k == 1:
        assert (got[0].numpy() == 1.0).all()


def test_router_ties_take_the_lower_expert_first():
    """A zero router makes every probability equal: lax.top_k's order."""
    x = np.ones((5, 16), np.float32)
    w = np.zeros((16, E), np.float32)
    got = tlayer.router_topk(torch.from_numpy(x), torch.from_numpy(w), 2)[1]
    want = jlayer.router_topk(jnp.asarray(x), jnp.asarray(w), 2)[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == [0, 1]).all()


@pytest.mark.parametrize("T, k, capacity", [(6, 1, 4), (200, 2, 40),
                                            (200, 2, 13), (64, 1, 64)])
def test_dispatch_plan_matches_jax(T, k, capacity):
    rng = np.random.default_rng(T + k)
    # skewed choices (so experts overflow), k distinct experts per token
    idx = np.stack([rng.permutation(E)[:k] if rng.random() < 0.5 else
                    np.arange(k) for _ in range(T)]).astype(np.int32)
    dest, keep, counts = tlayer._dispatch_plan(torch.from_numpy(idx).long(),
                                               E, capacity)
    jd, jk, jc = jlayer._dispatch_plan(jnp.asarray(idx), E, capacity)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert counts.dtype == torch.float32


# --------------------------------------------------------------------- #
# The MoE FFN sublayer
# --------------------------------------------------------------------- #
def _ffn_case(seed, B=2, S=40, H=64, F=96):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    p = {"router_kernel": rng.standard_normal((H, E)) * 0.6,
         "moe_fc_kernel": rng.standard_normal((E, H, F)) * H ** -0.5,
         "moe_fc_bias": rng.standard_normal((E, F)) * 0.1,
         "moe_out_kernel": rng.standard_normal((E, F, H)) * F ** -0.5,
         "moe_out_bias": rng.standard_normal((E, H)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    dy = rng.standard_normal((B, S, H)).astype(np.float32)
    return x, p, dy


@pytest.mark.parametrize("grouped", [True, "auto"])
def test_moe_ffn_matches_jax(grouped):
    """fp32: output, stats and every gradient (x, router, experts)."""
    x, p, dy = _ffn_case(1)
    tcfg, jcfg = _cfgs(grouped=grouped, capacity_factor=0.75)

    def jfn(xx, pp):
        y, st = jlayer.moe_ffn(pp, xx, jcfg)
        return y, st
    (jy, jst), vjp = jax.vjp(jfn, jnp.asarray(x),
                             jax.tree_util.tree_map(jnp.asarray, p))
    zero_st = jax.tree_util.tree_map(jnp.zeros_like, jst)
    jgx, jgp = vjp((jnp.asarray(dy), zero_st))

    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    y, st = tlayer.moe_ffn(pt, xt, tcfg)
    names = sorted(pt)
    grads = torch.autograd.grad(y, [xt] + [pt[n] for n in names],
                                torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-5 * np.abs(np.asarray(jy)).max())
    np.testing.assert_array_equal(st["expert_tokens"].numpy(),
                                  np.asarray(jst["expert_tokens"]))
    assert float(st["drop_fraction"]) == float(jst["drop_fraction"]) > 0
    for name in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(st[name].detach()), float(jst[name]),
                                   rtol=1e-5)
    for g, jg in zip(grads, [jgx] + [jgp[n] for n in names]):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg,
                                   atol=1e-5 * np.abs(jg).max(), rtol=0)


def test_moe_ffn_bf16_matches_jax_where_routing_agrees():
    x, p, _ = _ffn_case(2)
    tcfg, jcfg = _cfgs(grouped=True)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    T = x.shape[0] * x.shape[1]
    # same routing first: the router reads the same bf16 tokens in fp32
    g, idx, _, _ = tlayer.router_topk(xt.reshape(T, -1).float(),
                                      torch.from_numpy(p["router_kernel"]),
                                      K_TOP)
    jg, jidx, _, _ = jlayer.router_topk(xb.reshape(T, -1)
                                        .astype(jnp.float32),
                                        jnp.asarray(p["router_kernel"]),
                                        K_TOP)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)
    jy, jst = jlayer.moe_ffn(jax.tree_util.tree_map(jnp.asarray, p), xb,
                             jcfg)
    y, st = tlayer.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                           xt, tcfg)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(st["expert_tokens"].numpy(),
                                  np.asarray(jst["expert_tokens"]))
    assert float(st["drop_fraction"]) == float(jst["drop_fraction"])
    assert_close(y.float().numpy(), np.asarray(jy.astype(jnp.float32)),
                 "bf16")


def test_dropped_tokens_get_zero_output_and_gradient():
    """Capacity 1 per expert: most tokens drop. A token whose choices
    all dropped gets exactly 0 from the MoE FFN, and exactly 0 gradient
    through it (its slot is the drop row; its gates multiply zeros)."""
    x, p, dy = _ffn_case(4, B=1, S=32)
    tcfg, _ = _cfgs(capacity_factor=0.1)
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    y, st = tlayer.moe_ffn(pt, xt, tcfg)
    (gx,) = torch.autograd.grad(y, [xt], torch.from_numpy(dy))
    T = 32
    idx = tlayer.router_topk(xt.detach().reshape(T, -1),
                             pt["router_kernel"], K_TOP)[1]
    keep = tlayer._dispatch_plan(idx, E, 1)[1]
    dropped = ~keep.reshape(K_TOP, T).any(0)
    assert dropped.sum() > 0 and float(st["drop_fraction"]) > 0.5
    assert (y.detach().reshape(T, -1)[dropped] == 0).all()
    assert (gx.reshape(T, -1)[dropped] == 0).all()
    assert (gx.reshape(T, -1)[~dropped] != 0).any()


def test_single_expert_equals_the_dense_block():
    """num_experts 1, top_k 1, capacity inf: the MoE model with the
    dense FFN's weights as its one expert gives the dense model's
    logits (the grouped path on the CPU: fp32 within 1e-5)."""
    tcfg, _ = _cfgs(grouped=True, num_experts=1, top_k=1,
                    capacity_factor=float("inf"), aux_loss_weight=0.0,
                    z_loss_weight=0.0)
    dense_cfg = dataclasses.replace(tcfg, moe=None)
    dp = tgpt2.gpt2_init(dense_cfg, torch.Generator().manual_seed(0), "cpu")
    mp = tgpt2.gpt2_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    blocks = dict(mp["blocks"])
    for src, dst in (("fc_kernel", "moe_fc_kernel"),
                     ("fc_bias", "moe_fc_bias"),
                     ("fc_out_kernel", "moe_out_kernel"),
                     ("fc_out_bias", "moe_out_bias")):
        blocks[dst] = dp["blocks"][src][:, None]
    mp = {**{k: dp[k] for k in dp if k != "blocks"}, "blocks": blocks}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (4, 32)))
    for cfg_grouped in (tcfg, dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, grouped_gemm="auto"))):
        lm = tgpt2.gpt2_apply(mp, tokens, cfg_grouped)
        ld = tgpt2.gpt2_apply(dp, tokens, dense_cfg)
        np.testing.assert_allclose(lm.numpy(), ld.numpy(), rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------------- #
# GPT-2 with MoE blocks
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("freq", [1, 2])
def test_gpt2_moe_loss_and_grads_match_jax(freq):
    tcfg, jcfg = _cfgs(freq=freq)
    params_np = _jax_params(jcfg)
    batch = np.random.default_rng(freq).integers(0, 512, (4, 33)) \
        .astype(np.int32)

    def jloss(p):
        loss, aux = jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense)(
            p, jnp.asarray(batch), None)
        return loss, aux
    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params_np))
    tp = convert.from_jax_params(params_np)
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_()
    loss, aux = tgpt2.gpt2_loss_fn(tcfg)(tp, torch.from_numpy(batch), None)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_array_equal(aux["moe"]["expert_tokens"].numpy(),
                                  np.asarray(jaux["moe"]["expert_tokens"]))
    assert float(aux["moe"]["drop_fraction"]) == \
        float(jaux["moe"]["drop_fraction"])
    n_moe = len(tlayer.moe_layer_indices(tcfg.num_layers, freq))
    assert tp["blocks"]["moe_fc_kernel"].shape[0] == n_moe
    assert ("fc_kernel" in tp["blocks"]) == (freq > 1)
    for g, jgl in zip(grads, jax.tree_util.tree_leaves(jg)):
        jgl = np.asarray(jgl)
        np.testing.assert_allclose(g.numpy(), jgl,
                                   atol=1e-5 * np.abs(jgl).max(), rtol=0)


# --------------------------------------------------------------------- #
# The engine: train_batch against the JAX engine
# --------------------------------------------------------------------- #
def _ds(grouped="auto", **moe_kw):
    moe = {"num_experts": E, "top_k": K_TOP, "capacity_factor": CF,
           "grouped_gemm": grouped}
    moe.update(moe_kw)
    return {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_num_steps": 3, "warmup_max_lr": 1e-3}},
            "moe": moe}


def _batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, (4, 33)).astype(np.int32)
            for _ in range(STEPS)]


MOE_METRICS = ("moe_expert_tokens", "moe_drop_fraction", "moe_aux_loss",
               "moe_z_loss")


@pytest.mark.parametrize("grouped", ["auto", True])
def test_fp32_train_batch_matches_jax_engine(grouped):
    tcfg, jcfg = _cfgs(grouped=grouped)
    params_np = _jax_params(jcfg)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params_np),
        config=_ds(grouped), mesh=build_mesh(devices=jax.devices()[:1]))
    jmetrics = []
    record = jeng._record_telemetry

    def capture(metrics, *args):
        jmetrics.append(jax.device_get(metrics))
        return record(metrics, *args)
    jeng._record_telemetry = capture
    jloss = [float(jeng.train_batch(b)) for b in _batches()]

    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg),
        model_params=convert.from_jax_params(params_np),
        config=_ds(grouped), device="cpu")
    tloss, tmetrics = [], []
    for b in _batches():
        tloss.append(float(teng.train_batch(b)))
        tmetrics.append(teng.last_metrics)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert jloss[-1] < jloss[0]
    for tm, jm in zip(tmetrics, jmetrics):
        assert all(isinstance(tm[k], torch.Tensor) for k in MOE_METRICS)
        np.testing.assert_array_equal(tm["moe_expert_tokens"].numpy(),
                                      np.asarray(jm["moe_expert_tokens"]))
        assert float(tm["moe_drop_fraction"]) == \
            float(jm["moe_drop_fraction"])
        for k in ("moe_aux_loss", "moe_z_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5)
    jparams = jax.device_get(jeng.state.params)
    for t, j in zip(tree_flatten(teng.state.params)[0],
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=1e-5)
    # the MoE tree's fused Adam state carries across both ways
    st = jax.device_get(jeng.state)
    ported = convert.from_jax_fused_adam_state(
        st.opt_state.count, st.opt_state.m, st.opt_state.v, st.params)
    count, m, v = convert.to_jax_fused_adam_state(ported, st.params)
    assert count == st.opt_state.count
    for a, b in zip(m + v, tuple(st.opt_state.m) + tuple(st.opt_state.v)):
        np.testing.assert_array_equal(a, b)


# The train_moe recipe of chip_smoke.py (AdamW 6e-4, betas 0.9/0.95, wd
# 0.01, clip 1.0, WarmupLR linear over 10 steps to 6e-4, gas 2, the
# Markov token stream, 8 experts top-2 at capacity factor 1.25) cut to
# gpt2-tiny's width, micro-batch 4 x 64 tokens and dropout 0.
RECIPE_STEPS, RECIPE_MICRO, RECIPE_SEQ = 12, 4, 64


def _recipe_ds():
    return {"train_batch_size": 2 * RECIPE_MICRO,
            "train_micro_batch_size_per_gpu": RECIPE_MICRO,
            "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
            "optimizer": {"type": "AdamW", "params": {
                "lr": 6e-4, "betas": [0.9, 0.95], "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_num_steps": 10, "warmup_max_lr": 6e-4,
                "warmup_type": "linear"}},
            "moe": {"num_experts": E, "top_k": K_TOP, "capacity_factor": CF}}


def _markov_batches(vocab_size, seed=0):
    """chip_smoke.token_stream's chain: a fixed successor map over half
    the vocab, followed with probability 0.9."""
    rng = np.random.default_rng(seed)
    n = vocab_size // 2
    vocab = rng.choice(vocab_size, n, replace=False)
    succ = rng.permutation(n)
    B = 2 * RECIPE_MICRO
    out = []
    for _ in range(RECIPE_STEPS):
        toks = np.empty((B, RECIPE_SEQ + 1), np.int64)
        cur = rng.integers(0, n, B)
        for t in range(RECIPE_SEQ + 1):
            toks[:, t] = cur
            jump = rng.random(B) < 0.1
            cur = np.where(jump, rng.integers(0, n, B), succ[cur])
        out.append(vocab[toks].astype(np.int32))
    return out


def test_train_moe_recipe_drop_fraction_matches_jax_over_12_steps():
    """The train_moe recipe for 12 steps on both engines (fp32): the drop
    fraction and the expert token counts are equal at every step and the
    losses agree within 1e-5 relative, so the drop fraction's course on
    the card (a climb from 0.08 to about 0.4 at gpt2-small) is the
    recipe's, not the port's. It climbs here too, during the warmup, to
    more than three times its first value."""
    tcfg, jcfg = _cfgs()
    params_np = _jax_params(jcfg, seed=3)
    batches = _markov_batches(tcfg.vocab_size)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params_np),
        config=_recipe_ds(), mesh=build_mesh(devices=jax.devices()[:1]))
    jmetrics = []
    record = jeng._record_telemetry

    def capture(metrics, *args):
        jmetrics.append(jax.device_get(metrics))
        return record(metrics, *args)
    jeng._record_telemetry = capture
    jloss = [float(jeng.train_batch(b)) for b in batches]
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg),
        model_params=convert.from_jax_params(params_np),
        config=_recipe_ds(), device="cpu")
    tloss, tdrop = [], []
    for b, jm in zip(batches, jmetrics):
        tloss.append(float(teng.train_batch(b)))
        tm = teng.last_metrics
        np.testing.assert_array_equal(tm["moe_expert_tokens"].numpy(),
                                      np.asarray(jm["moe_expert_tokens"]))
        tdrop.append(float(tm["moe_drop_fraction"]))
    jdrop = [float(m["moe_drop_fraction"]) for m in jmetrics]
    assert tdrop == jdrop, (tdrop, jdrop)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert max(tdrop) > 3 * tdrop[0]


# --------------------------------------------------------------------- #
# Config and what raises
# --------------------------------------------------------------------- #
MOE_BLOCKS = [
    {}, {"num_experts": 8}, {"num_experts": 8, "top_k": 3},
    {"num_experts": 1, "top_k": 2}, {"num_experts": 8,
                                     "capacity_factor": 0},
    {"num_experts": 8, "capacity_factor": True},
    {"num_experts": 8, "aux_loss_weight": -1},
    {"num_experts": 8, "z_loss_weight": "x"},
    {"num_experts": 8, "grouped_gemm": "sometimes"},
    {"num_experts": 6, "expert_parallel_size": 4},
    {"num_experts": 0, "expert_parallel_size": 2},
    {"num_experts": -1}, {"num_experts": 8, "expert_parallel_size": 0},
    {"num_experts": 8, "capacity_factor": float("inf"), "top_k": 1,
     "grouped_gemm": True},
]


@pytest.mark.parametrize("i", range(len(MOE_BLOCKS)))
def test_moe_config_parity(i):
    def parse(mod):
        try:
            c = mod.MoeConfig({"moe": MOE_BLOCKS[i]})
        except mod.DeepSpeedConfigError as e:
            return ("error", str(e))
        return ("ok", dict(vars(c)))
    assert parse(tconfig) == parse(jconfig)


def test_from_ds_config_matches_jax():
    ds = _ds(True, aux_loss_weight=0.5, top_k=1)
    got = tmoe.MoEConfig.from_ds_config(
        tconfig.DeepSpeedConfig(ds).moe_config)
    want = jmoe.MoEConfig.from_ds_config(
        jconfig.DeepSpeedConfig(ds, world_size=1).moe_config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_moe_raises_where_the_port_has_no_path():
    tcfg, _ = _cfgs()
    params = tgpt2.gpt2_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    # expert parallelism: the ds_config block, the model, the layer
    with pytest.raises(NotImplementedError, match="slice 6"):
        deepspeed_tpu_torch.initialize(
            model=tgpt2.gpt2_loss_fn(tcfg), model_params=params,
            config=_ds(expert_parallel_size=2), device="cpu")
    ep2 = dataclasses.replace(tcfg, moe=_moe(tmoe, expert_parallel_size=2))
    with pytest.raises(NotImplementedError, match="slice 6"):
        tgpt2.gpt2_loss_fn(ep2)
    x = torch.zeros(1, 4, tcfg.hidden_size)
    with pytest.raises(NotImplementedError, match="slice 6"):
        tlayer.moe_ffn({}, x, ep2)
    # grouped_gemm False has no CUDA path (checked before anything
    # touches the device, so it runs anywhere)
    off = dataclasses.replace(tcfg, moe=_moe(tmoe, grouped_gemm=False))
    with pytest.raises(NotImplementedError, match="no CUDA path"):
        deepspeed_tpu_torch.initialize(
            model=tgpt2.gpt2_loss_fn(off), model_params=params,
            config=_ds(False), device="cuda")
    # a moe block with a dense model behind it
    dense = dataclasses.replace(tcfg, moe=None)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(dense),
        model_params=tgpt2.gpt2_init(dense, torch.Generator().manual_seed(0),
                                     "cpu"),
        config=_ds(), device="cpu")
    with pytest.raises(ValueError, match="moe"):
        eng.train_batch(_batches()[0])
    # the serving path has no MoE blocks
    from deepspeed_tpu_torch.inference import decode
    with pytest.raises(NotImplementedError, match="MoE"):
        decode._check_cfg(tcfg)
