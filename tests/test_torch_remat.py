"""Activation recomputation in the port (``TransformerConfig.remat_policy``,
``models/remat.py``) against the JAX package's ``remat_policy`` and
against the port's own ``none``, on gpt2-tiny with weights from
``models/convert.py``.

- Each of ``none``, ``full``, ``dots``, ``dots_flash`` and ``attn``:
  ``gpt2_loss_fn``'s loss and every gradient against JAX with the same
  policy, fp32, dropout 0, within 1e-5 (loss relative; gradients of the
  leaf's largest), with dense attention on both sides, and at S = 128
  with flash attention (the JAX Pallas kernels in interpret mode).
- Each policy against the port's ``none`` at dropout 0.1 from the same
  generator, on the dense and the flash route: loss and gradients bit
  for bit (one CPU thread: the embedding's backward adds in thread
  order above one).
- Which steps a policy re-runs: the LayerNorm, GELU and flash forward
  calls of one loss and backward (the CPU counterpart of the card's
  K3f/K4f/K1 launch table), and what each policy holds between the
  passes.
- Three engine steps with ``full`` (gas 2) against the JAX engine with
  ``full``: fp32 1e-5, fp16 1e-3 with equal loss scales and skips, bf16
  1e-2 (relative, losses).
- MoE with ``full``: bit-equal to the port's MoE ``none`` at dropout
  0.1, the same expert counts and drops; within 1e-5 of JAX (fp32).
- A block-sparse ``attention_fn`` under ``full``: bit-equal to ``none``.
"""
import contextlib
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
from deepspeed_tpu.ops.flash_attention import flash_attention as jflash
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu_torch import moe as tmoe
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import remat
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops.fused_update import tree_flatten
from deepspeed_tpu_torch.ops.sparse_attention import (SparseSelfAttention,
                                                      sparse_attention)

POLICIES = ["none", "full", "dots", "dots_flash", "attn"]
PRECISIONS = {"fp32": (torch.float32, jnp.float32),
              "fp16": (torch.float16, jnp.float16),
              "bf16": (torch.bfloat16, jnp.bfloat16)}


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _cfgs(policy="none", precision="fp32", dropout=0.0, **kw):
    tdt, jdt = PRECISIONS[precision]
    off = dict(hidden_dropout=dropout, attn_dropout=dropout,
               remat_policy=policy)
    jkw = dict(off, fused_kernels=precision == "fp32")
    jkw.update(kw.get("j", {}))
    return (dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=tdt,
                                **off, **kw.get("t", {})),
            dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=jdt,
                                **jkw))


@pytest.fixture(scope="module")
def params_np():
    return jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0), _cfgs()[1]))


def _batch(S=32, B=2, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S + 1)) \
        .astype(np.int32)


def _port_loss_grads(tcfg, params_np, batch, gen=None, attention_fn=None,
                     ops=None):
    tp = convert.from_jax_params(params_np)
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_()
    out = tgpt2.gpt2_loss_fn(tcfg, attention_fn=attention_fn, ops=ops)(
        tp, torch.from_numpy(batch), gen)
    loss, aux = out if isinstance(out, tuple) else (out, None)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), [g.detach() for g in grads], aux


# --------------------------------------------------------------------- #
# Each policy against JAX's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("route", ["dense", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_loss_and_grads_match_jax(params_np, policy, route):
    tcfg, jcfg = _cfgs(policy)
    if route == "dense":
        batch, jattn, tattn = _batch(), jdense, None
    else:
        batch, jattn, tattn = _batch(128), jflash, tfa.flash_attention
    jl, jg = jax.value_and_grad(
        lambda p: jgpt2.gpt2_loss_fn(jcfg, attention_fn=jattn)(
            p, jnp.asarray(batch), None))(
        jax.tree_util.tree_map(jnp.asarray, params_np))
    loss, grads, _ = _port_loss_grads(tcfg, params_np, batch,
                                      attention_fn=tattn)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for g, jgl in zip(grads, jax.tree_util.tree_leaves(jg)):
        jgl = np.asarray(jgl)
        np.testing.assert_allclose(g.numpy(), jgl,
                                   atol=1e-5 * np.abs(jgl).max())


def test_unknown_policy_raises_as_in_jax():
    tcfg, jcfg = _cfgs("sometimes")
    with pytest.raises(ValueError, match="unknown remat policy"):
        tgpt2.gpt2_loss_fn(tcfg)
    from deepspeed_tpu.models.transformer import _remat_policy
    with pytest.raises(ValueError, match="unknown remat policy"):
        _remat_policy("sometimes")


# --------------------------------------------------------------------- #
# Each policy against the port's none, with dropout
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("route", ["dense", "flash"])
@pytest.mark.parametrize("policy", POLICIES[1:])
def test_policy_bit_equal_to_none_with_dropout(params_np, policy, route):
    batch = _batch(128)
    attn = None if route == "dense" else tfa.flash_attention
    out = {}
    with one_thread():
        for pol in ("none", policy):
            tcfg, _ = _cfgs(pol, dropout=0.1)
            out[pol] = _port_loss_grads(tcfg, params_np, batch,
                                        torch.Generator().manual_seed(7),
                                        attention_fn=attn)
    assert torch.equal(out["none"][0], out[policy][0])
    for a, b in zip(out["none"][1], out[policy][1]):
        assert torch.equal(a, b)


def _counting_ops():
    counts = {"ln": 0, "res_ln": 0, "bias_gelu": 0}
    base = tt.KERNEL_OPS

    def counted(name):
        fn = getattr(base, name)

        def call(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return call
    ops = base._replace(**{n: counted(n) for n in counts})
    return ops, counts


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_reruns_the_expected_forward_steps(params_np, policy,
                                                  monkeypatch):
    """One loss and backward of gpt2-tiny (L = 2) on the flash route:
    ``none`` runs each LayerNorm, GELU and flash forward once a layer
    (plus ln_f); ``full``, ``dots`` and ``attn`` run the layers' again in
    the backward; ``dots_flash`` all but the flash forward (the table
    of the card's K3f/K4f/K1 launches)."""
    L = 2
    flash_fwd = {"n": 0}
    real = tfa.flash_attention_fwd

    def fwd(*a, **k):
        flash_fwd["n"] += 1
        return real(*a, **k)
    monkeypatch.setattr(tfa, "flash_attention_fwd", fwd)
    ops, counts = _counting_ops()
    tcfg, _ = _cfgs(policy, dropout=0.1)
    _port_loss_grads(tcfg, params_np, _batch(128),
                     torch.Generator().manual_seed(1),
                     attention_fn=tfa.flash_attention, ops=ops)
    again = 0 if policy == "none" else 1
    assert counts == {"ln": L * (1 + again) + 1, "res_ln": L * (1 + again),
                      "bias_gelu": L * (1 + again)}, counts
    assert flash_fwd["n"] == L * (1 + (again if policy != "dots_flash"
                                       else 0))


@pytest.mark.parametrize("route", ["dense", "flash"])
@pytest.mark.parametrize("policy", POLICIES[1:])
def test_policy_holds_what_it_saves(params_np, policy, route, monkeypatch):
    """What a block's region holds between the passes for the steps it
    re-runs, and which steps: ``full`` only the input; ``dots`` and
    ``attn`` also the products (the dense route's QKᵀ and PV under
    ``dots`` only); ``dots_flash`` does not re-run the flash forward."""
    regions = []
    real = remat.Recompute.forward

    def forward(self, params, inputs):
        regions.append(self)
        return real(self, params, inputs)
    monkeypatch.setattr(remat.Recompute, "forward", forward)
    tcfg, _ = _cfgs(policy, dropout=0.1)
    attn = None if route == "dense" else tfa.flash_attention
    _port_loss_grads(tcfg, params_np, _batch(128),
                     torch.Generator().manual_seed(1), attention_fn=attn)
    assert len(regions) == 2
    r = regions[0]
    held = set(r._held)
    if policy == "full":
        assert held == {"x"}
        assert {"ln1", "qkv", "proj", "res_ln", "fc", "gelu"} <= r._rerun
    else:
        assert {"x", "pr", "z"} <= held and "qkv" not in r._rerun
    assert "fc_out" not in r._rerun and "ln1" in r._rerun
    if route == "flash":
        assert ("attn" in r._rerun) == (policy != "dots_flash")
    else:
        assert ("qk" in r._rerun) == (policy in ("full", "attn"))
        assert ("pv" in r._rerun) == (policy in ("full", "attn"))


# --------------------------------------------------------------------- #
# The engine with full
# --------------------------------------------------------------------- #
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


@pytest.mark.parametrize("precision, rtol", [("fp32", 1e-5), ("fp16", 1e-3),
                                             ("bf16", 1e-2)])
def test_full_train_batch_matches_jax_engine(params_np, precision, rtol):
    tcfg, jcfg = _cfgs("full", precision)
    if precision != "fp32":
        jcfg = dataclasses.replace(jcfg, fused_kernels=False)
    batches = [_batch(32, 4, s) for s in range(3)]
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params_np),
        config=_ds(precision), mesh=build_mesh(devices=jax.devices()[:1]))
    jh = []
    for b in batches:
        jh.append((float(jeng.train_batch(b)), float(jeng.state.loss_scale),
                   int(jeng.state.skipped_steps)))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg),
        model_params=convert.from_jax_params(params_np),
        config=_ds(precision), device="cpu")
    th = []
    for b in batches:
        th.append((float(teng.train_batch(b)), float(teng.state.loss_scale),
                   int(teng.state.skipped_steps)))
    assert [h[1:] for h in th] == [h[1:] for h in jh]
    finite = [i for i, h in enumerate(jh) if np.isfinite(h[0])]
    np.testing.assert_allclose([th[i][0] for i in finite],
                               [jh[i][0] for i in finite], rtol=rtol)
    if precision == "fp32":
        for t, j in zip(tree_flatten(teng.state.params)[0],
                        jax.tree_util.tree_leaves(
                            jax.device_get(jeng.state.params))):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                       atol=1e-5)


# --------------------------------------------------------------------- #
# MoE and block-sparse attention under full
# --------------------------------------------------------------------- #
def _moe_cfgs(policy, dropout=0.0):
    moe = dict(num_experts=4, top_k=2, capacity_factor=1.25)
    return _cfgs(policy, dropout=dropout, t={"moe": tmoe.MoEConfig(**moe)},
                 j={"moe": jmoe.MoEConfig(**moe), "fused_kernels": False})


def test_moe_full_bit_equal_to_none_with_dropout():
    tcfg, jcfg = _moe_cfgs("none", 0.1)
    params_np = jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0), jcfg))
    out = {}
    with one_thread():
        for pol in ("none", "full"):
            out[pol] = _port_loss_grads(
                dataclasses.replace(tcfg, remat_policy=pol), params_np,
                _batch(64), torch.Generator().manual_seed(3))
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)
    for name, v in out["none"][2]["moe"].items():
        assert torch.equal(v, out["full"][2]["moe"][name]), name


def test_moe_full_matches_jax():
    tcfg, jcfg = _moe_cfgs("full")
    params_np = jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0), jcfg))
    batch = _batch(32, 4, 2)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense)(
            p, jnp.asarray(batch), None), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params_np))
    loss, grads, aux = _port_loss_grads(tcfg, params_np, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_array_equal(aux["moe"]["expert_tokens"].numpy(),
                                  np.asarray(jaux["moe"]["expert_tokens"]))
    assert float(aux["moe"]["drop_fraction"]) == \
        float(jaux["moe"]["drop_fraction"])
    for g, jgl in zip(grads, jax.tree_util.tree_leaves(jg)):
        jgl = np.asarray(jgl)
        np.testing.assert_allclose(g.numpy(), jgl,
                                   atol=1e-5 * np.abs(jgl).max(), rtol=0)


def test_sparse_attention_full_bit_equal_to_none(params_np):
    """A block-sparse ``attention_fn`` (the Fixed layout at block 128:
    the LUT kernels' route, their plain versions on the CPU) composes
    with every policy; ``full`` re-runs it in the backward pass."""
    sa = SparseSelfAttention.from_config(
        {"mode": "fixed", "block": 128, "num_local_blocks": 1,
         "attention": "unidirectional"}, 4)
    layout = sa.get_layout(128)

    def attn(q, k, v, **kw):
        return sparse_attention(q, k, v, layout, **kw)
    out = {}
    with one_thread():
        for pol in ("none", "full"):
            tcfg, _ = _cfgs(pol, dropout=0.1)
            out[pol] = _port_loss_grads(tcfg, params_np, _batch(128),
                                        torch.Generator().manual_seed(5),
                                        attention_fn=attn)
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_stage3_weights_are_regathered_not_held(policy):
    """Under ZeRO stage 3's ``regather_saved`` the regions hand the
    gathered weights to its hooks: after the forward pass nothing holds
    a gathered leaf (a weakref to it dies), the backward pass re-gathers
    them, and the gradients are those of the same run without remat."""
    import gc
    import weakref
    from deepspeed_tpu_torch.runtime.zero.stage3 import regather_saved
    tcfg, _ = _cfgs(policy, dropout=0.1)
    src = tt.init_block_params(tcfg, torch.Generator().manual_seed(0),
                               "cpu")
    x = torch.randn(2, 32, 128, generator=torch.Generator().manual_seed(1))
    out = {}
    for pol in ("none", policy):
        cfg = dataclasses.replace(tcfg, remat_policy=pol)
        parts = {k: v.clone().requires_grad_() for k, v in src.items()}
        calls = {"n": 0}

        def regather(k):
            calls["n"] += 1
            return src[k].clone()
        gathered = {k: p * 1.0 for k, p in parts.items()}   # non-leaf
        refs = [weakref.ref(t) for t in gathered.values()]
        with regather_saved({i: ((lambda k=k: regather(k)), gathered[k])
                             for i, k in enumerate(gathered)}):
            y = tt.apply_blocks(dict(gathered), x, cfg,
                                rng=torch.Generator().manual_seed(2),
                                deterministic=False)
        del gathered
        gc.collect()
        assert all(r() is None for r in refs), pol
        grads = torch.autograd.grad(y.sum(), list(parts.values()))
        assert calls["n"] > 0
        out[pol] = [g.detach() for g in grads]
    for a, b in zip(out["none"], out[policy]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", POLICIES[1:])
def test_regions_are_freed_after_the_backward_pass(params_np, policy,
                                                   monkeypatch):
    """Nothing outlives a step: a node that saves its own output (the
    softmax, the fused residual LayerNorm) must not hold its region
    through a packed tensor, in the forward graph or the re-run's."""
    import gc
    import weakref
    refs = []
    real = remat.Recompute.forward

    def forward(self, params, inputs):
        refs.append(weakref.ref(self))
        return real(self, params, inputs)
    monkeypatch.setattr(remat.Recompute, "forward", forward)
    tcfg, _ = _cfgs(policy, dropout=0.1)
    for attn in (None, tfa.flash_attention):
        _port_loss_grads(tcfg, params_np, _batch(128),
                         torch.Generator().manual_seed(1), attention_fn=attn)
    gc.collect()
    assert len(refs) == 4 and all(r() is None for r in refs)
