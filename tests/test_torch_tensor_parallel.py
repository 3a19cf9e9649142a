"""The port's tensor parallelism (Megatron column/row blocks, the
vocab-parallel embedding and head, ``param_shardings``) against JAX's
GSPMD program on the same mesh, on gpt2-tiny (fp32, dropout 0).

The port runs gloo worlds of ``tests/torch_dp_worker.py`` (``mesh``
jobs: rank = (d * sp + s) * mp + m, each rank holding its parts of the
leaves ``gpt2_param_shardings`` splits); the JAX side runs in this
process on ``build_mesh(mp=M, devices=jax.devices()[:M * D])``, one
engine per mesh, shared by the cases on it. Both start from JAX
``gpt2_init``'s parameters.

- ``gpt2_apply``'s logits and the loss's grads at mp 2 and 4 against
  JAX's jit over params placed by ``gpt2_param_shardings`` on a (1, mp)
  mesh (1e-5); bert-tiny's MLM loss and grads through
  ``bert_param_shardings`` against JAX's jit over params placed by
  ``bert_param_shardings`` on the same mesh, at vocabulary 512 and mp 2
  (split) and 510 and mp 4 (1e-5; JAX refuses a spec mp does not
  divide, so its 510-row ``wte`` and ``decoder_bias`` are placed whole,
  as its files keep them and as the port holds them), and at both
  vocabularies and mp 2 and 4 against the port's whole model (1e-6);
- the engine, 3 steps (gas 2, micro 2 a dp rank, AdamW with clipping and
  WarmupLR; JAX turns the fused Adam off under ``param_shardings`` and
  the port's ``AdamChain`` steps), at mp 2 x dp 1 (ZeRO 0), mp 2 x dp 2
  (ZeRO 1, 2 and 3 in one world) and mp 4 x dp 1 (ZeRO 0): losses within
  1e-5 relative and the whole params within 1e-5 of JAX's on the same
  mesh; every rank reports the same losses, and the model ranks' whole
  params are bit-equal;
- mp 2 against the port's own mp 1 run (1e-5), also with dropout 0.1
  (every rank draws the whole masks from the same generator and keeps
  its heads' part: mp 2 draws the masks of mp 1); the flash functions'
  dropout hash at a rank's heads (``heads=(h0, nH)``) is the whole
  launch's at those heads;
- fp16 at mp 2: JAX's skips and loss scales;
- the plain loss of JAX's ``test_mp_sharded_model_files`` (``w`` split
  on its rows, gathered whole for the forward) against JAX's engine.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import deepspeed_tpu
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.parallel.topology import build_mesh

import torch_dp_worker as W
from test_torch_dp import load, save_params, wait

STEPS = 3
JDT = {"fp32": jnp.float32, "fp16": jnp.float16}
# name: (mp, dp, precision, zero stage)
CASES = {
    "mp2": (2, 1, "fp32", 0),
    "mp2_fp16": (2, 1, "fp16", 0),
    "mp2dp2_z1": (2, 2, "fp32", 1),
    "mp2dp2_z2": (2, 2, "fp32", 2),
    "mp2dp2_z3": (2, 2, "fp32", 3),
    "mp4": (4, 1, "fp32", 0),
}
# (JAX's ZeRO stages under param_shardings run one optax program: the
# stage places the state, the arithmetic is the same)
JAX_OF = {"mp2dp2_z2": "mp2dp2_z1", "mp2dp2_z3": "mp2dp2_z1"}
# bert-tiny's vocabularies: 512 splits at mp 2 and 4, 510 at mp 2 only.
# Against JAX: (mp, vocab) split at mp 2, and whole at mp 4.
BERT_VOCABS = (512, 510)
BERT_CASES = ((2, 512), (4, 510))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jcfg(precision="fp32"):
    return dataclasses.replace(
        jgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=JDT[precision],
        fused_kernels=False, hidden_dropout=0.0, attn_dropout=0.0)


def jax_engine(name, params):
    mp, dp, prec, stage = CASES[name]
    cfg = jcfg(prec)
    mesh = build_mesh(mp=mp, devices=jax.devices()[:mp * dp])
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(cfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params),
        config=W.ds_config(prec, dp, stage,
                           extra={"mesh": {"model_parallel_size": mp}}),
        mesh=mesh, param_shardings=jgpt2.gpt2_param_shardings(cfg))
    return eng


def jax_run(eng, batches):
    rec = {"loss": [], "loss_scale": [], "skipped": []}
    for b in batches:
        rec["loss_scale"].append(float(eng.state.loss_scale))
        rec["loss"].append(float(eng.train_batch(b)))
        rec["skipped"].append(int(eng.state.skipped_steps))
    params = np.concatenate([
        np.asarray(x, np.float32).reshape(-1)
        for x in jax.tree_util.tree_leaves(jax.device_get(eng.state.params))])
    return {k: np.asarray(v) for k, v in rec.items()}, params


def jax_apply(params, tokens, mp):
    """JAX's logits and loss grads with the params placed by
    ``gpt2_param_shardings`` on a (1, mp) mesh."""
    cfg = jcfg()
    mesh = build_mesh(mp=mp, devices=jax.devices()[:mp])
    shard = jax.tree_util.tree_map(
        lambda spec: NamedSharding(mesh, spec),
        jgpt2.gpt2_param_shardings(cfg), is_leaf=lambda x: isinstance(x, JP))
    placed = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params),
                            shard)
    loss_fn = jgpt2.gpt2_loss_fn(cfg, attention_fn=jdense)
    t = jnp.asarray(tokens)
    with mesh:
        logits = jax.jit(lambda p: jgpt2.gpt2_apply(
            p, t[:, :-1], cfg, attention_fn=jdense))(placed)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, t, None)))(placed)
    flat = np.concatenate([np.asarray(g, np.float32).reshape(-1)
                           for g in jax.tree_util.tree_leaves(grads)])
    return np.asarray(logits), float(loss), flat


def bert_jcfg(vocab):
    return dataclasses.replace(
        jbert.BERT_CONFIGS["bert-tiny"], dtype=jnp.float32, vocab_size=vocab,
        fused_kernels=False, hidden_dropout=0.0, attn_dropout=0.0)


def jax_bert(params, inputs, mp):
    """JAX's bert-tiny MLM loss and grads with the params placed by
    ``bert_param_shardings`` on a (1, mp) mesh. JAX refuses a spec whose
    dim mp does not divide (its engine raises on bert at vocabulary 510
    and mp 4), so such a leaf is placed whole, as its checkpoint files
    keep it (``_effective_axes``) and as the port holds it."""
    cfg = bert_jcfg(params["wte"].shape[0])
    mesh = build_mesh(mp=mp, devices=jax.devices()[:mp])

    def place(spec, leaf):
        even = all(ax is None or leaf.shape[i] % mp == 0
                   for i, ax in enumerate(spec))
        return NamedSharding(mesh, spec if even else JP())
    shard = jax.tree_util.tree_map(
        place, jbert.bert_param_shardings(cfg), params,
        is_leaf=lambda x: isinstance(x, JP))
    loss_fn = jbert.bert_mlm_loss_fn(cfg, attention_fn=jdense)
    batch = (jnp.asarray(inputs["tokens"]), jnp.asarray(inputs["labels"]))
    placed = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params),
                            shard)
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, batch, None)))(placed)
    flat = np.concatenate([np.asarray(g, np.float32).reshape(-1)
                           for g in jax.tree_util.tree_leaves(grads)])
    return float(loss), flat


def mpfile_jax(batches):
    """JAX's ``test_mp_sharded_model_files`` engine on a dp 2 x mp 2 mesh,
    3 steps."""
    from jax.sharding import PartitionSpec as P
    params = {"w": jnp.arange(64 * 8, dtype=jnp.float32).reshape(64, 8),
              "b": jnp.zeros((8,), jnp.float32)}

    def loss_fn(p, batch, rng):
        x, y = batch
        h = x @ p["w"][:x.shape[-1], :]
        return jnp.mean((h.sum(-1) - y) ** 2)

    eng, *_ = deepspeed_tpu.initialize(
        model=loss_fn, model_params=params,
        config=W.ds_config("fp32", 2, 0,
                           extra={"mesh": {"model_parallel_size": 2}}),
        mesh=build_mesh(mp=2, devices=jax.devices()[:4]),
        param_shardings={"w": P("model", None), "b": P(None)})
    losses = [float(eng.train_batch((x, y))) for x, y in
              zip(batches["x"], batches["y"])]
    params = np.concatenate([np.asarray(v, np.float32).reshape(-1) for v in
                             jax.tree_util.tree_leaves(
                                 jax.device_get(eng.state.params))])
    return np.asarray(losses), params


def make_batches(dp, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (STEPS, W.MICRO * W.GAS * dp, 33)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp"))
    flat = jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0), jcfg()))
    pp = os.path.join(d, "p.npz")
    save_params(flat, pp)
    batches = {dp: make_batches(dp, 40 + dp) for dp in (1, 2)}
    for dp, b in batches.items():
        np.save(os.path.join(d, f"b{dp}.npy"), b)
    rng = np.random.default_rng(7)
    mpb = {"x": rng.normal(size=(STEPS, 2 * W.MICRO * W.GAS, 8))
           .astype(np.float32),
           "y": rng.integers(0, 4, (STEPS, 2 * W.MICRO * W.GAS))
           .astype(np.float32)}
    np.savez(os.path.join(d, "mpb.npz"), **mpb)
    bert_params, bert_paths = {}, []
    for i, vocab in enumerate(BERT_VOCABS):
        bert_params[vocab] = jax.tree_util.tree_map(
            np.asarray, jbert.bert_init(jax.random.PRNGKey(3 + i),
                                        bert_jcfg(vocab)))
        bert_paths.append([vocab, os.path.join(d, f"bert{vocab}.npz")])
        save_params(bert_params[vocab], bert_paths[-1][1])
    masked = rng.integers(0, min(BERT_VOCABS), (2, 16)).astype(np.int32)
    bert_inputs = {"tokens": masked, "labels": np.where(
        rng.random((2, 16)) < 0.3, masked, -100).astype(np.int32)}
    np.savez(os.path.join(d, "bert_inputs.npz"), **bert_inputs)
    applied_job = dict(apply=True, bert=bert_paths,
                       bert_inputs=os.path.join(d, "bert_inputs.npz"))

    def job(name, **kw):
        mp, dp, prec, stage = CASES.get(name, (1, 1, "fp32", 0))
        return dict(dict(name=name, precision=prec, stage=stage,
                         mesh={"mp": mp},
                         batches=os.path.join(d, f"b{dp}.npy"),
                         out=os.path.join(d, name)), **kw)
    worlds = {
        1: [job("mp1"), job("mp1_drop", dropout=0.1)],
        2: [job("apply2", mesh={"mp": 2}, **applied_job), job("mp2"),
            job("mp2_fp16"), job("mp2_drop", dropout=0.1, mesh={"mp": 2})],
        4: [job("apply4", mesh={"mp": 4}, **applied_job), job("mp2dp2_z1"),
            job("mp2dp2_z2"), job("mp2dp2_z3"), job("mp4"),
            job("mpfile", model="mpfile", mesh={"mp": 2},
                batches=os.path.join(d, "mpb.npz"))],
    }
    procs = [W.spawn_forked(d, w, jobs, f"w{w}", pp)
             for w, jobs in worlds.items()]
    jax_runs = {}
    for name in CASES:
        if name not in JAX_OF:
            jax_runs[name] = jax_run(jax_engine(name, flat),
                                     batches[CASES[name][1]])
    for name, twin in JAX_OF.items():
        jax_runs[name] = jax_runs[twin]
    tokens = batches[1][0]
    applied = {mp: jax_apply(flat, tokens, mp) for mp in (2, 4)}
    bert = {(mp, vocab): jax_bert(bert_params[vocab], bert_inputs, mp)
            for mp, vocab in BERT_CASES}
    jax_runs["mpfile"] = mpfile_jax(mpb)
    for p in procs:
        wait(p)
    port = {name: load(os.path.join(d, name), w)
            for w, jobs in worlds.items() for name in
            [j["name"] for j in jobs]}
    return {"port": port, "jax": jax_runs, "applied": applied,
            "bert": bert, "tokens": tokens}


@pytest.mark.parametrize("mp", [2, 4])
def test_apply_and_grads_match_jax_gspmd(runs, mp):
    logits, loss, grads = runs["applied"][mp]
    for r in runs["port"][f"apply{mp}"]:
        np.testing.assert_allclose(r["logits"], logits, atol=1e-5)
        np.testing.assert_allclose(float(r["loss"]), loss, rtol=1e-6)
        np.testing.assert_allclose(r["grads"], grads, atol=1e-5)
        assert r["bert_diff"].max() < 1e-6, r["bert_diff"]


@pytest.mark.parametrize("mp,vocab", BERT_CASES)
def test_bert_matches_jax_gspmd(runs, mp, vocab):
    loss, grads = runs["bert"][(mp, vocab)]
    for r in runs["port"][f"apply{mp}"]:
        np.testing.assert_allclose(float(r[f"bert{vocab}_loss"]), loss,
                                   rtol=1e-6)
        np.testing.assert_allclose(r[f"bert{vocab}_grads"], grads, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_jax_on_the_same_mesh(runs, name):
    port = runs["port"][name]
    jrec, jparams = runs["jax"][name]
    for r in port:
        np.testing.assert_array_equal(r["loss"], port[0]["loss"])
        # (the model ranks' whole params, gathered: bit-equal)
        np.testing.assert_array_equal(r["params"], port[0]["params"])
    np.testing.assert_allclose(port[0]["loss"], jrec["loss"], rtol=1e-5)
    np.testing.assert_allclose(port[0]["params"], jparams, atol=1e-5)
    if CASES[name][2] == "fp16":
        np.testing.assert_array_equal(port[0]["loss_scale"],
                                      jrec["loss_scale"])
        np.testing.assert_array_equal(port[0]["skipped"], jrec["skipped"])
        assert jrec["skipped"][-1] > 0


@pytest.mark.parametrize("suffix", ["", "_drop"])
def test_mp2_matches_the_ports_mp1(runs, suffix):
    a, b = runs["port"][f"mp2{suffix}"][0], runs["port"][f"mp1{suffix}"][0]
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    np.testing.assert_allclose(a["params"], b["params"], atol=1e-5)


def test_flash_dropout_hash_at_a_ranks_heads():
    from deepspeed_tpu_torch.ops import flash_attention as fa
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 128, 4, 16, generator=g) for _ in range(4))
    seed = torch.tensor(7, dtype=torch.int32)
    o, lse = fa.flash_fwd_plain(q, k, v, True, 0.25, 0.1, seed)
    grads = fa.flash_bwd_plain(q, k, v, do, lse, fa.flash_delta(do, o),
                               True, 0.25, 0.1, seed)
    h = slice(2, 4)
    part = [t[:, :, h] for t in (q, k, v, do)]
    op, lp = fa.flash_fwd_plain(*part[:3], True, 0.25, 0.1, seed,
                                heads=(2, 4))
    gp = fa.flash_bwd_plain(*part, lp, fa.flash_delta(part[3], op), True,
                            0.25, 0.1, seed, heads=(2, 4))
    assert torch.equal(op, o[:, :, h])
    for a, b in zip(gp, grads):
        assert torch.equal(a, b[:, :, h])
    # the kernels' cost declarations take the hash heads (they move no
    # bytes), positionally as the autograd function passes them
    from deepspeed_tpu_torch.ops import costs
    args = (*part[:3], True, 0.25, 0.1, seed, None)
    assert costs.flash_fwd_decl(*args, (2, 4)) == costs.flash_fwd_decl(*args)
    bargs = (*part, lp, lp, True, 0.25, 0.1, seed)
    for decl in (costs.flash_bwd_dq_decl, costs.flash_bwd_dkv_decl):
        assert decl(*bargs, None, (2, 4)) == decl(*bargs)
    assert costs.flash_bwd_fused_decl(*bargs, (2, 4)) == \
        costs.flash_bwd_fused_decl(*bargs)


def test_plain_loss_with_a_split_leaf_matches_jax(runs):
    losses, params = runs["jax"]["mpfile"]
    port = runs["port"]["mpfile"]
    for r in port:
        np.testing.assert_allclose(r["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["params"], params, rtol=1e-5)


def test_refusals_with_jax_messages():
    """OnebitAdam and serving's ``quantize`` under ``param_shardings``
    raise JAX's errors; a world that mp does not divide raises JAX's
    mesh error; heads that mp does not divide raise."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import InferenceEngine
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    from deepspeed_tpu_torch.parallel.tensor_parallel import ModelParallel
    cfg = dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"],
                              dtype=torch.float32)
    params = tgpt2.gpt2_init(cfg, torch.Generator().manual_seed(0), "cpu")
    sh = tgpt2.gpt2_param_shardings(cfg)
    ds = {"train_batch_size": 2, "steps_per_print": 10 ** 9,
          "optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3}}}
    with pytest.raises(NotImplementedError, match="OnebitAdam \\+ tensor"):
        deepspeed_tpu_torch.initialize(
            model=tgpt2.gpt2_loss_fn(cfg), model_params=params, config=ds,
            device="cpu", param_shardings=sh)
    with pytest.raises(NotImplementedError, match="quantize does not"):
        InferenceEngine(cfg, params, {"inference": {"quantize": "int8"}},
                        device="cpu", param_shardings=sh)
    with pytest.raises(ValueError, match="not divisible by mp"):
        deepspeed_tpu_torch.initialize(
            model=tgpt2.gpt2_loss_fn(cfg), model_params=params,
            config=dict(ds, optimizer={"type": "AdamW"},
                        mesh={"model_parallel_size": 2}), device="cpu")
    with pytest.raises(ValueError, match="num_heads"):
        ModelParallel(None, 3, 0).local(cfg.num_heads, "num_heads")
    from deepspeed_tpu_torch.parallel.topology import (
        PipeModelDataParallelTopology, PipelineParallelGrid)
    with pytest.raises(NotImplementedError, match="pp x mp"):
        PipelineParallelGrid(PipeModelDataParallelTopology(2, 2, 1))


def test_shard_params_refuses_a_placement_the_program_does_not_take():
    """The leaves a model declares: a vocabulary leaf split without its
    partner raises, as does a leaf on another dim than the model's
    program takes; both vocabulary leaves whole give ``vocab=False``
    and a QKV leaf is the rank's heads of each third."""
    from types import SimpleNamespace
    from deepspeed_tpu_torch.models import bert as tbert
    from deepspeed_tpu_torch.models.convert import qkv_to_mp_order
    from deepspeed_tpu_torch.parallel import tensor_parallel as tpm
    from deepspeed_tpu_torch.parallel.topology import P
    cfg = dataclasses.replace(tbert.BERT_CONFIGS["bert-tiny"],
                              dtype=torch.float32)
    params = tbert.bert_init(cfg, torch.Generator().manual_seed(0), "cpu")
    grid = SimpleNamespace(model_parallel_size=2, mp_group=None,
                           model_parallel_id=1)
    model = tbert.bert_mlm_loss_fn(cfg)
    own = model.param_shardings
    kw = dict(vocab_leaves=model.vocab_leaves, qkv_leaves=model.qkv_leaves,
              own=own)
    with pytest.raises(ValueError, match="vocabulary leaves"):
        tpm.shard_params(params, dict(own, decoder_bias=P(None)), grid, **kw)
    blocks = dict(own["blocks"], fc_kernel=P(None, "model", None))
    with pytest.raises(ValueError, match="'fc_kernel' on dim 1"):
        tpm.shard_params(params, dict(own, blocks=blocks), grid, **kw)
    local, tp, axes, qkv = tpm.shard_params(
        params, dict(own, wte=P(None, None), decoder_bias=P(None)), grid,
        **kw)
    assert not tp.vocab and tp.rank == 1 and sum(qkv) == 2
    assert local["wte"].shape == params["wte"].shape
    H = cfg.hidden_size
    want = qkv_to_mp_order(params["blocks"]["qkv_kernel"], 2)[..., 3 * H // 2:]
    assert torch.equal(local["blocks"]["qkv_kernel"], want)
