"""The port's BERT family (``deepspeed_tpu_torch/models/bert.py``) against
the JAX package's, on bert-tiny with the same weights
(``models/convert.py``).

- ``bert_apply`` (final hidden states) and ``bert_mlm_loss_fn`` in fp32
  (1e-5 absolute on the states, relative on the loss) and bf16 (the
  states' error norm within 1e-2 of theirs; the loss within 1e-2
  relative): post-LN and pre-LN, with and without an ``attention_mask``,
  with and without segment ids. Both sides run dense attention (the
  port's CPU default; the JAX flash function routes a mask dense too).
- The post-LN block under every ``remat_policy``: loss and every
  gradient BIT-EQUAL to ``none``, with dropout and a padding mask.
- ``initialize(model=bert_mlm_loss_fn(cfg))`` against the JAX engine on
  ``examples/bert/train.py``'s ds_config (ZeRO-1, Adam lr 3e-3, clipping
  1.0, WarmupLR) for 5 steps of its MLM batches, dropout 0: in fp32
  (post-LN and pre-LN) every loss within 1e-5 relative and the final
  params within 1e-5 absolute; in bf16 (the example's block) every loss
  within 1e-2 relative (tests/test_torch_training.py's tolerances).
- The K3b repair: a residual LayerNorm whose sum ``s`` goes unused
  reaches ``layer_norm_backward`` with gs None, and its plain version
  then gives the gradients of a zero gs launch bit for bit.
- BERT with MoE raises as in JAX."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models.remat import SAVEABLE
from deepspeed_tpu_torch.ops import fused_elementwise as fe

STEPS = 5
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# examples/bert/train.py's ds_config (bf16 block added per precision).
EXAMPLE_DS = {
    "train_batch_size": 8,
    "gradient_accumulation_steps": 1,
    "zero_optimization": {"stage": 1},
    "gradient_clipping": 1.0,
    "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 10}},
    "steps_per_print": 10 ** 9,
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the remat cases compare bits (the embedding's
    backward adds in thread order above one), and both engines train
    here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(precision, pre_ln, **kw):
    tdt, jdt = DTYPES[precision]
    t = dataclasses.replace(tbert.BERT_CONFIGS["bert-tiny"], dtype=tdt,
                            pre_layer_norm=pre_ln, **kw)
    j = dataclasses.replace(jbert.BERT_CONFIGS["bert-tiny"], dtype=jdt,
                            pre_layer_norm=pre_ln,
                            fused_kernels=precision == "fp32", **kw)
    return t, j


@pytest.fixture(scope="module")
def params_np():
    _, jcfg = _cfgs("fp32", False)
    p = jax.tree_util.tree_map(np.asarray,
                               jbert.bert_init(jax.random.PRNGKey(0), jcfg))
    # Spread the LayerNorm params off 1 and 0, so a swapped scale or
    # bias shows.
    rng = np.random.default_rng(5)
    for tree in (p, p["blocks"]):
        for k in list(tree):
            if "ln" in k and not isinstance(tree[k], dict):
                tree[k] = (tree[k] + 0.1 * rng.standard_normal(
                    tree[k].shape)).astype(np.float32)
    return p


def synthetic_mlm(n, vocab, seq, mask_prob=0.15, seed=0):
    """examples/bert/train.py's MLM batches."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, vocab, size=(n, seq)).astype(np.int32)
    labels = np.full((n, seq), -100, np.int32)
    mask = rng.random((n, seq)) < mask_prob
    labels[mask] = tokens[mask]
    tokens = tokens.copy()
    tokens[mask] = 3          # [MASK]
    return tokens, labels


def _inputs(seq=64):
    tokens, labels = synthetic_mlm(2, 512, seq)
    rng = np.random.default_rng(1)
    seg = rng.integers(0, 2, size=tokens.shape).astype(np.int32)
    keep = np.ones(tokens.shape, np.int32)
    keep[1, 45:] = 0
    return tokens, labels, seg, keep


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("pre_ln", [False, True], ids=["postln", "preln"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("segments", [False, True], ids=["noseg", "seg"])
def test_bert_apply_and_mlm_loss_match_jax(params_np, precision, pre_ln,
                                           masked, segments):
    tcfg, jcfg = _cfgs(precision, pre_ln)
    tokens, labels, seg, keep = _inputs()
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    tp = convert.from_jax_params(params_np)
    seg_t = torch.from_numpy(seg).long() if segments else None
    seg_j = jnp.asarray(seg) if segments else None
    keep_t = torch.from_numpy(keep) if masked else None
    keep_j = jnp.asarray(keep) if masked else None
    ref = np.asarray(jbert.bert_apply(
        jp, jnp.asarray(tokens), jcfg, segment_ids=seg_j,
        attention_mask=keep_j).astype(jnp.float32))
    with torch.no_grad():
        out = tbert.bert_apply(tp, torch.from_numpy(tokens).long(), tcfg,
                               segment_ids=seg_t, attention_mask=keep_t)
    out = out.float().numpy()
    assert out.shape == ref.shape == (2, 64, 128)
    batch_j = (jnp.asarray(tokens), jnp.asarray(labels)) + \
        ((keep_j,) if masked else ())
    batch_t = (torch.from_numpy(tokens).long(),
               torch.from_numpy(labels).long()) + \
        ((keep_t,) if masked else ())
    jl = float(jbert.bert_mlm_loss_fn(jcfg)(jp, batch_j, None))
    with torch.no_grad():
        tl = float(tbert.bert_mlm_loss_fn(tcfg)(tp, batch_t, None))
    if precision == "fp32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    else:
        assert np.linalg.norm(out - ref) <= 1e-2 * np.linalg.norm(ref)
        np.testing.assert_allclose(tl, jl, rtol=1e-2)


def test_segment_ids_and_mask_change_the_states(params_np):
    """The segment table and the mask reach the states (both sides
    agree above; here they are shown not to be no-ops)."""
    tcfg, _ = _cfgs("fp32", False)
    tokens, _, seg, keep = _inputs()
    tp = convert.from_jax_params(params_np)
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        base = tbert.bert_apply(tp, t, tcfg)
        with_seg = tbert.bert_apply(tp, t, tcfg,
                                    segment_ids=torch.from_numpy(seg).long())
        masked = tbert.bert_apply(tp, t, tcfg,
                                  attention_mask=torch.from_numpy(keep))
    assert not torch.allclose(base, with_seg)
    assert torch.equal(masked[0], base[0])          # row 0 keeps all
    assert not torch.allclose(masked[1], base[1])


# --------------------------------------------------------------------- #
# remat: every policy bit-equal to none on the post-LN program
# --------------------------------------------------------------------- #
def _loss_and_grads(params_np, policy):
    tcfg, _ = _cfgs("fp32", False, remat_policy=policy)
    tokens, labels, _, keep = _inputs()
    tp = {k: v.requires_grad_() if not isinstance(v, dict) else
          {kk: vv.requires_grad_() for kk, vv in v.items()}
          for k, v in convert.from_jax_params(params_np).items()}
    loss = tbert.bert_mlm_loss_fn(tcfg)(
        tp, (torch.from_numpy(tokens).long(), torch.from_numpy(labels).long(),
             torch.from_numpy(keep)),
        torch.Generator().manual_seed(11))
    loss.backward()
    grads = {k: v.grad for k, v in tp.items() if not isinstance(v, dict)}
    grads.update({f"blocks.{k}": v.grad for k, v in tp["blocks"].items()})
    return loss.detach(), grads


@pytest.fixture(scope="module")
def no_remat(params_np):
    return _loss_and_grads(params_np, "none")


@pytest.mark.parametrize("policy", sorted(SAVEABLE))
def test_postln_remat_bit_equal_to_none(params_np, no_remat, policy):
    loss, grads = _loss_and_grads(params_np, policy)
    ref_loss, ref_grads = no_remat[0], dict(no_remat[1])
    assert torch.equal(loss, ref_loss)
    assert sorted(grads) == sorted(ref_grads)
    # (the MLM loss takes no segment ids: the segment table gets none)
    assert grads.pop("wse") is None and ref_grads["wse"] is None
    for k in grads:
        assert torch.equal(grads[k], ref_grads[k]), k
    assert all(g.abs().sum() > 0 for g in grads.values())


# --------------------------------------------------------------------- #
# The engine against the JAX engine on the example's recipe
# --------------------------------------------------------------------- #
def _ds(precision):
    ds = dict(EXAMPLE_DS)
    if precision == "bf16":
        ds["bf16"] = {"enabled": True}
    return ds


def _batches(seq=128):
    tokens, labels = synthetic_mlm(8 * 16, 512, seq)
    return [(tokens[s * 8:s * 8 + 8], labels[s * 8:s * 8 + 8])
            for s in range(STEPS)]


def _runs(params_np, precision, pre_ln):
    off = dict(hidden_dropout=0.0, attn_dropout=0.0)
    tcfg, jcfg = _cfgs(precision, pre_ln, **off)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jbert.bert_mlm_loss_fn(jcfg),
        model_params=jax.tree_util.tree_map(jnp.asarray, params_np),
        config=_ds(precision), mesh=build_mesh(devices=jax.devices()[:1]))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tbert.bert_mlm_loss_fn(tcfg),
        model_params=convert.from_jax_params(params_np),
        config=_ds(precision), device="cpu")
    jl, tl = [], []
    for b in _batches():
        jl.append(float(jeng.train_batch(b)))
        tl.append(float(teng.train_batch(
            tuple(torch.from_numpy(x).long() for x in b))))
    return tl, jl, teng.full_params(), jax.device_get(jeng.state.params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("pre_ln", [False, True], ids=["postln", "preln"])
def test_fp32_engine_matches_jax_on_the_example_recipe(params_np, pre_ln):
    tl, jl, tparams, jparams = _runs(params_np, "fp32", pre_ln)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    tf, jf = _flat(tparams), _flat(jparams)
    assert sorted(tf) == sorted(jf)
    for k in jf:
        np.testing.assert_allclose(tf[k].detach().float().numpy(),
                                   np.asarray(jf[k], np.float32), atol=1e-5,
                                   err_msg=k)


def test_bf16_engine_matches_jax_on_the_example_recipe(params_np):
    tl, jl, _, _ = _runs(params_np, "bf16", False)
    np.testing.assert_allclose(tl, jl, rtol=1e-2)


# --------------------------------------------------------------------- #
# The K3b repair and the MoE refusal
# --------------------------------------------------------------------- #
def test_residual_layer_norm_without_s_cotangent_launches_no_gs(monkeypatch):
    torch.manual_seed(0)
    x = torch.randn(6, 40, dtype=torch.float32, requires_grad=True)
    d = torch.randn(6, 40, requires_grad=True)
    sc = (1 + 0.1 * torch.randn(40)).requires_grad_()
    bi = (0.1 * torch.randn(40)).requires_grad_()
    gy = torch.randn(6, 40)
    seen = []
    real = fe.layer_norm_backward

    def spy(s, scale, dy, gs, eps):
        seen.append(gs)
        return real(s, scale, dy, gs, eps)
    monkeypatch.setattr(fe, "layer_norm_backward", spy)
    _, y = fe.fused_residual_layer_norm(x, d, sc, bi)
    y.backward(gy)
    assert seen == [None]
    # the zero-gs launch (what autograd materialised before the repair)
    s = (x + d).detach()
    no_gs = real(s, sc.detach(), gy, None, 1e-5)
    zero_gs = real(s, sc.detach(), gy, torch.zeros_like(s), 1e-5)
    for a, b in zip(no_gs, zero_gs):
        assert torch.equal(a, b)
    assert torch.equal(x.grad, no_gs[0]) and torch.equal(d.grad, no_gs[0])
    assert torch.equal(sc.grad, no_gs[1]) and torch.equal(bi.grad, no_gs[2])
    # with both outputs used, gs arrives as before
    seen.clear()
    s2, y2 = fe.fused_residual_layer_norm(x, d, sc, bi)
    (s2.sum() + (y2 * gy).sum()).backward()
    assert seen[0] is not None and torch.equal(seen[0], torch.ones(6, 40))


def test_bert_with_moe_raises_as_jax(params_np):
    from deepspeed_tpu_torch.moe import MoEConfig
    tcfg, _ = _cfgs("fp32", False, moe=MoEConfig(num_experts=2))
    tokens, *_ = _inputs()
    with pytest.raises(NotImplementedError, match="BERT keeps the dense"):
        tbert.bert_apply(convert.from_jax_params(params_np),
                         torch.from_numpy(tokens).long(), tcfg)
