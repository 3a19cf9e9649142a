"""The port's module injection (``deepspeed_tpu_torch/module_inject``) and
``SparseAttentionUtils`` against the JAX package's, from HF PyTorch
models built from small configs with random weights (nothing
downloads).

- ``extract_*`` from a HF ``state_dict`` is BIT-EQUAL to the JAX
  ``extract_*`` on the same weights in HF Flax layout (built here with
  numpy: Linear weights transposed, GPT-2's Conv1D kept transposed the
  Flax way), for bert, roberta and gpt2; ``restore`` ∘ ``extract`` is
  the identity, and a changed stack restores to what JAX restores.
- The injected encoder (``apply_blocks`` on the stacked weights, fp32,
  the CPU's plain versions) matches HF ``BertModel``'s
  ``last_hidden_state`` (erf GELU, with and without a padding mask) and
  GPT-2's blocks + ln_f, and JAX ``apply_blocks``, at 2e-5 (JAX's own
  test's tolerance).
- The policy registry behaves as JAX's (builtins, detection, a custom
  policy, the duplicate-name error, ``replace_module``,
  ``replace_subtrees``).
- ``SparseAttentionUtils``: position-embedding extension (bert tiles,
  roberta keeps its 2 reserved rows) bit-equal to JAX's, pad and unpad
  equal, and the sparse encoder (Fixed layout, block 128: the LUT
  route, on the CPU its plain versions) within 2e-5 of JAX's sparse
  encoder (its Pallas kernels in interpret mode) and of the dense route
  with the layout as a mask.

``transformers`` is imported with ``USE_TF=0`` and ``USE_FLAX=0`` (it
would pull in TensorFlow otherwise)."""
import os

os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_FLAX", "0")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu.models import transformer as jtr  # noqa: E402
from deepspeed_tpu import module_inject as jmi  # noqa: E402
from deepspeed_tpu.module_inject import policy as jpolicy  # noqa: E402
from deepspeed_tpu.ops.sparse_attention import \
    SparseAttentionUtils as JSAU  # noqa: E402
from deepspeed_tpu.ops.sparse_attention import \
    FixedSparsityConfig as JFixed  # noqa: E402
from deepspeed_tpu_torch import module_inject as tmi  # noqa: E402
from deepspeed_tpu_torch.models import transformer as ttr  # noqa: E402
from deepspeed_tpu_torch.module_inject import policy as tpolicy  # noqa
from deepspeed_tpu_torch.ops.sparse_attention import (  # noqa: E402
    FixedSparsityConfig, SparseAttentionUtils)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import \
    sparse_attention_reference  # noqa: E402

TOL = 2e-5
SPARSE = dict(num_heads=4, block=128, num_local_blocks=2,
              num_global_blocks=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf():
    """Tiny HF BERT (erf GELU), RoBERTa and GPT-2 models, eval mode."""
    import transformers as tf
    torch.manual_seed(0)
    bert_cfg = tf.BertConfig(vocab_size=100, hidden_size=128,
                             num_hidden_layers=2, num_attention_heads=4,
                             intermediate_size=256,
                             max_position_embeddings=128,
                             hidden_act="gelu", hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    rob_cfg = tf.RobertaConfig(vocab_size=100, hidden_size=64,
                               num_hidden_layers=2, num_attention_heads=4,
                               intermediate_size=128,
                               max_position_embeddings=34,
                               hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    gpt_cfg = tf.GPT2Config(n_embd=64, n_layer=2, n_head=4, vocab_size=100,
                            n_positions=32, resid_pdrop=0.0, attn_pdrop=0.0,
                            embd_pdrop=0.0)
    models = {"bert": (tf.BertModel(bert_cfg, add_pooling_layer=False),
                       bert_cfg),
              "roberta": (tf.RobertaModel(rob_cfg), rob_cfg),
              "gpt2": (tf.GPT2Model(gpt_cfg), gpt_cfg)}
    out = {}
    for name, (model, cfg) in models.items():
        model.eval()
        with torch.no_grad():      # spread the LN params off 1 and 0
            for k, p in model.named_parameters():
                if "LayerNorm" in k or ".ln_" in k:
                    p.add_(torch.randn_like(p) * 0.1)
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        out[name] = (model, cfg, sd)
    return out


# --------------------------------------------------------------------- #
# HF Flax layout from a torch state_dict (numpy only)
# --------------------------------------------------------------------- #
def _np(t):
    return t.detach().cpu().numpy()


def bert_flax(sd):
    """A HF Flax BERT/RoBERTa param tree (``embeddings`` and
    ``encoder``) from a torch ``state_dict``."""
    def dense(p):
        return {"kernel": _np(sd[p + ".weight"]).T,
                "bias": _np(sd[p + ".bias"])}

    def ln(p):
        return {"scale": _np(sd[p + ".weight"]), "bias": _np(sd[p + ".bias"])}
    L = len({k.split(".")[2] for k in sd if k.startswith("encoder.layer.")})
    layers = {}
    for i in range(L):
        p = f"encoder.layer.{i}."
        layers[str(i)] = {
            "attention": {
                "self": {n: dense(p + f"attention.self.{n}")
                         for n in ("query", "key", "value")},
                "output": {"dense": dense(p + "attention.output.dense"),
                           "LayerNorm": ln(p + "attention.output.LayerNorm")}},
            "intermediate": {"dense": dense(p + "intermediate.dense")},
            "output": {"dense": dense(p + "output.dense"),
                       "LayerNorm": ln(p + "output.LayerNorm")}}
    emb = {"position_embeddings": {"embedding": _np(
        sd["embeddings.position_embeddings.weight"])}}
    return {"embeddings": emb, "encoder": {"layer": layers}}


def gpt2_flax(sd):
    """A HF Flax GPT-2 tree: its Conv1D kernels stored ``[out, in]``."""
    def conv(p):
        return {"kernel": _np(sd[p + ".weight"]).T,
                "bias": _np(sd[p + ".bias"])}

    def ln(p):
        return {"scale": _np(sd[p + ".weight"]), "bias": _np(sd[p + ".bias"])}
    L = len({k.split(".")[1] for k in sd if k.startswith("h.")})
    return {"h": {str(i): {
        "ln_1": ln(f"h.{i}.ln_1"), "ln_2": ln(f"h.{i}.ln_2"),
        "attn": {"c_attn": conv(f"h.{i}.attn.c_attn"),
                 "c_proj": conv(f"h.{i}.attn.c_proj")},
        "mlp": {"c_fc": conv(f"h.{i}.mlp.c_fc"),
                "c_proj": conv(f"h.{i}.mlp.c_proj")}} for i in range(L)}}


FLAX = {"bert": bert_flax, "roberta": bert_flax, "gpt2": gpt2_flax}
PORT_EXTRACT = {"bert": tmi.extract_bert_encoder,
                "roberta": tmi.extract_bert_encoder,
                "gpt2": tmi.extract_gpt2_blocks}
PORT_RESTORE = {"bert": tmi.restore_bert_encoder,
                "roberta": tmi.restore_bert_encoder,
                "gpt2": tmi.restore_gpt2_blocks}
JAX_EXTRACT = {"bert": jmi.extract_bert_encoder,
               "roberta": jmi.extract_bert_encoder,
               "gpt2": jmi.extract_gpt2_blocks}
JAX_RESTORE = {"bert": jmi.restore_bert_encoder,
               "roberta": jmi.restore_bert_encoder,
               "gpt2": jmi.restore_gpt2_blocks}
ARCHS = ("bert", "roberta", "gpt2")


@pytest.mark.parametrize("arch", ARCHS)
def test_extract_bit_equal_to_jax(hf, arch):
    _, _, sd = hf[arch]
    port = PORT_EXTRACT[arch](sd)
    ref = JAX_EXTRACT[arch](FLAX[arch](sd))
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(_np(port[k]), np.asarray(ref[k]),
                                      err_msg=k)
        assert port[k].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_restore_inverts_extract_and_matches_jax(hf, arch):
    _, _, sd = hf[arch]
    stacked = PORT_EXTRACT[arch](sd)
    back = PORT_RESTORE[arch](stacked, sd)
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # A changed stack flows back, as JAX restores it.
    moved = {k: v + 0.5 for k, v in stacked.items()}
    restored = PORT_RESTORE[arch](moved, sd)
    again = PORT_EXTRACT[arch](restored)
    for k in moved:
        assert torch.equal(again[k], moved[k]), k
    jflax = JAX_RESTORE[arch]({k: jnp.asarray(_np(v))
                               for k, v in moved.items()}, FLAX[arch](sd))
    want = FLAX[arch](restored)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jflax):
        got = want
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(np.asarray(leaf), got, str(path))


def test_config_from_hf_matches_jax(hf):
    for arch in ARCHS:
        _, cfg, _ = hf[arch]
        fn = "gpt2_config_from_hf" if arch == "gpt2" else \
            "bert_config_from_hf"
        t, j = getattr(tmi, fn)(cfg), getattr(jmi, fn)(cfg)
        for f in ("hidden_size", "num_heads", "num_layers", "ffn_size",
                  "max_seq_length", "vocab_size", "pre_layer_norm",
                  "hidden_dropout", "attn_dropout", "layer_norm_eps",
                  "causal", "gelu_exact"):
            assert getattr(t, f) == getattr(j, f), (arch, f)
    bert_cfg = hf["bert"][1]
    assert tmi.bert_config_from_hf(bert_cfg).gelu_exact is True
    for act, exact in (("gelu_new", False), ("gelu_pytorch_tanh", False)):
        bert_cfg.hidden_act = act
        assert tmi.bert_config_from_hf(bert_cfg).gelu_exact is exact
    bert_cfg.hidden_act = "relu"
    for mod in (tmi, jmi):
        with pytest.raises(ValueError, match="GELU activations only"):
            mod.bert_config_from_hf(bert_cfg)
    bert_cfg.hidden_act = "gelu"


def _jax_blocks(stacked, x, cfg, mask=None, attention_fn=None):
    return np.asarray(jtr.apply_blocks(
        {k: jnp.asarray(_np(v)) for k, v in stacked.items()},
        jnp.asarray(x), cfg, mask=mask, deterministic=True,
        attention_fn=attention_fn or jtr.dense_attention))


@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
def test_injected_bert_encoder_matches_hf_and_jax(hf, masked):
    model, hf_cfg, sd = hf["bert"]
    cfg, stacked, _ = tmi.replace_module(hf_cfg, sd)
    assert cfg.gelu_exact and not cfg.pre_layer_norm and not cfg.causal
    tokens = torch.from_numpy(np.arange(2 * 16).reshape(2, 16) % 100)
    m = torch.ones(2, 16, dtype=torch.long)
    if masked:
        m[1, 11:] = 0
    with torch.no_grad():
        out = model(input_ids=tokens, attention_mask=m,
                    output_hidden_states=True)
        emb = out.hidden_states[0]
        ours = ttr.apply_blocks(stacked, emb, cfg,
                                mask=ttr.additive_mask(m) if masked
                                else None)
    np.testing.assert_allclose(_np(ours), _np(out.last_hidden_state),
                               rtol=TOL, atol=TOL)
    jmask = None
    if masked:
        jmask = (1.0 - jnp.asarray(_np(m), jnp.float32))[:, None, None, :] \
            * -1e9
    ref = _jax_blocks(stacked, _np(emb), jmi.bert_config_from_hf(hf_cfg),
                      jmask)
    np.testing.assert_allclose(_np(ours), ref, rtol=TOL, atol=TOL)


def test_injected_gpt2_blocks_match_hf_and_jax(hf):
    model, hf_cfg, sd = hf["gpt2"]
    cfg, stacked, restore_fn = tmi.replace_module(hf_cfg, sd)
    tokens = torch.from_numpy((np.arange(2 * 16).reshape(2, 16) * 7) % 100)
    with torch.no_grad():
        out = model(input_ids=tokens, output_hidden_states=True)
        emb = out.hidden_states[0]
        ours = ttr.apply_blocks(stacked, emb, cfg)
        final = ttr.layer_norm(ours, sd["ln_f.weight"], sd["ln_f.bias"],
                               cfg.layer_norm_eps)
    np.testing.assert_allclose(_np(final), _np(out.last_hidden_state),
                               rtol=TOL, atol=TOL)
    ref = _jax_blocks(stacked, _np(emb), jmi.gpt2_config_from_hf(hf_cfg))
    np.testing.assert_allclose(_np(ours), ref, rtol=TOL, atol=TOL)
    back = restore_fn(stacked)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


class _Cfg:
    def __init__(self, model_type):
        self.model_type = model_type


def test_policy_registry_behaves_as_jax(hf):
    assert tpolicy.registered_policies() == jpolicy.registered_policies() \
        == ["bert", "roberta", "gpt2"]
    for arch in ARCHS:
        cfg = hf[arch][1]
        assert tpolicy.detect_policy(cfg).name == \
            jpolicy.detect_policy(cfg).name == arch
    for mod in (tpolicy, jpolicy):
        with pytest.raises(ValueError, match="no registered injection"):
            mod.detect_policy(_Cfg("t5"))
        with pytest.raises(KeyError, match="no injection policy"):
            mod.get_policy("t5")
        with pytest.raises(ValueError, match="already registered"):
            mod.register_policy(mod.get_policy("bert"))
    # A custom policy: registered last, detected, used by name, replaced
    # only with override=True.
    calls = []
    custom = tpolicy.InjectionPolicy(
        name="toy", detect=lambda c: getattr(c, "model_type", "") == "toy",
        config_from_hf=lambda c: "cfg",
        extract=lambda p: calls.append("extract") or {"w": p["w"] * 2},
        restore=lambda s, p: dict(p, w=s["w"] / 2))
    tpolicy.register_policy(custom)
    try:
        assert tpolicy.registered_policies()[-1] == "toy"
        cfg, stacked, restore_fn = tpolicy.replace_module(
            _Cfg("toy"), {"w": torch.ones(2)})
        assert cfg == "cfg" and torch.equal(stacked["w"], torch.full((2,),
                                                                     2.0))
        assert torch.equal(restore_fn(stacked)["w"], torch.ones(2))
        assert tpolicy.replace_module(None, {"w": torch.ones(1)},
                                      policy="toy")[0] == "cfg"
        with pytest.raises(ValueError, match="already registered"):
            tpolicy.register_policy(custom)
        tpolicy.register_policy(custom, override=True)
        assert calls == ["extract", "extract"]
    finally:
        del tpolicy._REGISTRY["toy"]
    assert tpolicy.registered_policies() == ["bert", "roberta", "gpt2"]
    # replace_subtrees: first match wins, no recursion into a result.
    tree = {"a": {"attn": {"w": 1}, "mlp": {"w": 2}}, "attn": {"w": 3}}
    policies = [(lambda path, n: path.endswith("attn"),
                 lambda n: {"swapped": n["w"]}),
                (lambda path, n: path == "a", lambda n: n)]
    assert tpolicy.replace_subtrees(tree, policies) == \
        jpolicy.replace_subtrees(tree, policies)
    assert tpolicy.replace_subtrees(tree, policies[:1]) == \
        jpolicy.replace_subtrees(tree, policies[:1]) == \
        {"a": {"attn": {"swapped": 1}, "mlp": {"w": 2}},
         "attn": {"swapped": 3}}


# --------------------------------------------------------------------- #
# SparseAttentionUtils
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,new", [("bert", 512), ("roberta", 128)])
def test_extend_position_embedding_matches_jax(hf, arch, new):
    _, _, sd = hf[arch]
    out = SparseAttentionUtils.extend_position_embedding(sd, new, arch)
    ref = JSAU.extend_position_embedding(bert_flax(sd), new, arch)
    table = out["embeddings.position_embeddings.weight"]
    np.testing.assert_array_equal(_np(table), np.asarray(
        ref["embeddings"]["position_embeddings"]["embedding"]))
    assert torch.equal(sd["embeddings.position_embeddings.weight"],
                       hf[arch][2]["embeddings.position_embeddings.weight"])
    assert table.shape[0] == (new if arch == "bert" else new // 32 * 32 + 2)
    for mod, params in ((SparseAttentionUtils, sd),
                        (JSAU, bert_flax(sd))):
        with pytest.raises(ValueError, match="must exceed"):
            mod.extend_position_embedding(params, 8, arch)
        with pytest.raises(ValueError, match="model type"):
            mod.extend_position_embedding(params, 4096, "t5")


def test_pad_and_unpad_match_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 100, (2, 200)).astype(np.int64)
    mask = np.ones((2, 200), np.int64)
    seg = rng.integers(0, 2, (2, 200)).astype(np.int64)
    emb = rng.standard_normal((2, 200, 8)).astype(np.float32)
    t = SparseAttentionUtils.pad_to_block_size(
        128, torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(seg), torch.from_numpy(ids),
        torch.from_numpy(emb), pad_token_id=1)
    j = JSAU.pad_to_block_size(128, jnp.asarray(ids), jnp.asarray(mask),
                               jnp.asarray(seg), jnp.asarray(ids),
                               jnp.asarray(emb), pad_token_id=1)
    assert t[0] == j[0] == 56
    for a, b in zip(t[1:], j[1:]):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    seq = torch.from_numpy(
        rng.standard_normal((2, 256, 8)).astype(np.float32))
    np.testing.assert_array_equal(
        _np(SparseAttentionUtils.unpad_sequence_output(56, seq)),
        np.asarray(JSAU.unpad_sequence_output(56, jnp.asarray(_np(seq)))))
    assert SparseAttentionUtils.pad_to_block_size(
        128, torch.from_numpy(ids[:, :128]))[0] == 0

    class Tok:
        model_max_length = 512
        init_kwargs = {}
    tok = SparseAttentionUtils.update_tokenizer_model_max_length(Tok(), 4096)
    assert tok.model_max_length == tok.init_kwargs["model_max_length"] == 4096


@pytest.fixture(scope="module")
def sparse_encoders(hf):
    _, hf_cfg, sd = hf["bert"]
    sd = SparseAttentionUtils.extend_position_embedding(sd, 512)
    fn, stacked, cfg = SparseAttentionUtils.\
        replace_model_self_attention_with_sparse_self_attention(
            hf_cfg, sd, FixedSparsityConfig(**SPARSE), max_position=512)
    jfn, jstacked, jcfg = JSAU.\
        replace_model_self_attention_with_sparse_self_attention(
            hf_cfg, bert_flax(sd), JFixed(**SPARSE), max_position=512)
    x = np.random.default_rng(1).standard_normal((1, 512, 128)).astype(
        np.float32)
    return fn, stacked, cfg, jfn, jstacked, x


def test_sparse_encoder_matches_jax(sparse_encoders):
    fn, stacked, cfg, jfn, jstacked, x = sparse_encoders
    assert cfg.max_seq_length == 512
    for k in jstacked:
        np.testing.assert_array_equal(_np(stacked[k]),
                                      np.asarray(jstacked[k]))
    layout = fn.sparse_self_attention.get_layout(512)
    assert 0 < layout.sum() < layout.size     # sparse, not dense
    with torch.no_grad():
        ours = fn(stacked, torch.from_numpy(x))
    ref = np.asarray(jfn(jstacked, jnp.asarray(x)))
    np.testing.assert_allclose(_np(ours), ref, rtol=TOL, atol=TOL)
    # The dense route with the layout as a mask computes the same.
    dense = ttr.apply_blocks(
        stacked, torch.from_numpy(x), cfg,
        attention_fn=lambda q, k, v, **kw: sparse_attention_reference(
            q, k, v, layout))
    np.testing.assert_allclose(_np(ours), _np(dense), rtol=TOL, atol=TOL)


def test_sparse_encoder_padding_mask_matches_jax(sparse_encoders):
    fn, stacked, _, jfn, jstacked, x = sparse_encoders
    keep = np.ones((1, 512), np.int64)
    keep[0, 400:] = 0
    with torch.no_grad():
        ours = fn(stacked, torch.from_numpy(x),
                  key_padding_mask=torch.from_numpy(keep))
    ref = np.asarray(jfn(jstacked, jnp.asarray(x),
                         key_padding_mask=jnp.asarray(keep)))
    np.testing.assert_allclose(_np(ours), ref, rtol=TOL, atol=TOL)
