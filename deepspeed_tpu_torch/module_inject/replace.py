"""HF PyTorch ``state_dict`` <-> stacked-block weight mapping (port of
``deepspeed_tpu/module_inject/replace.py``).

The mapping the reference's injector copies: the separate q/k/v
projection weights concatenate into one fused qkv tensor; the
attention-output, LayerNorm and FFN tensors map one to one. Both
directions are copies, so restore ∘ extract is the identity, bit for
bit.

Layout notes:
- HF BERT/RoBERTa ``nn.Linear`` weights are ``[out, in]``: each is
  transposed into the blocks' ``[in, out]``.
- HF GPT-2's ``Conv1D`` weights are already ``[in, out]`` (unlike HF
  Flax GPT-2, whose kernels the JAX package transposes); ``c_attn``
  holds q, k, v fused in the blocks' order.
- A model with a head keeps its base model under a prefix (``bert.``,
  ``roberta.``, ``transformer.``): the prefix is found from the keys.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import torch

from ..models.transformer import TransformerConfig

_BERT_ANCHOR = "encoder.layer.0.attention.self.query.weight"
_GPT2_ANCHOR = "h.0.attn.c_attn.weight"
# (stacked name, per-layer key under ``encoder.layer.{i}.``, transposed)
_BERT_MAP: Tuple[Tuple[str, str, bool], ...] = (
    ("ln1_scale", "attention.output.LayerNorm.weight", False),
    ("ln1_bias", "attention.output.LayerNorm.bias", False),
    ("proj_kernel", "attention.output.dense.weight", True),
    ("proj_bias", "attention.output.dense.bias", False),
    ("ln2_scale", "output.LayerNorm.weight", False),
    ("ln2_bias", "output.LayerNorm.bias", False),
    ("fc_kernel", "intermediate.dense.weight", True),
    ("fc_bias", "intermediate.dense.bias", False),
    ("fc_out_kernel", "output.dense.weight", True),
    ("fc_out_bias", "output.dense.bias", False),
)
_QKV = ("query", "key", "value")
# (stacked name, per-layer key under ``h.{i}.``); Conv1D: no transpose.
_GPT2_MAP: Tuple[Tuple[str, str], ...] = (
    ("ln1_scale", "ln_1.weight"), ("ln1_bias", "ln_1.bias"),
    ("qkv_kernel", "attn.c_attn.weight"), ("qkv_bias", "attn.c_attn.bias"),
    ("proj_kernel", "attn.c_proj.weight"), ("proj_bias", "attn.c_proj.bias"),
    ("ln2_scale", "ln_2.weight"), ("ln2_bias", "ln_2.bias"),
    ("fc_kernel", "mlp.c_fc.weight"), ("fc_bias", "mlp.c_fc.bias"),
    ("fc_out_kernel", "mlp.c_proj.weight"),
    ("fc_out_bias", "mlp.c_proj.bias"),
)


def find_prefix(state_dict: Dict[str, Any], anchor: str) -> str:
    """The key prefix under which ``anchor`` (a key of the base model)
    sits in ``state_dict`` (``""`` for a base model)."""
    for key in state_dict:
        if key.endswith(anchor) and (key == anchor or
                                     key[-len(anchor) - 1] == "."):
            return key[:-len(anchor)]
    raise ValueError(f"no '{anchor}' key in the state_dict: not a HF "
                     "PyTorch model of this architecture")


def _num_layers(state_dict: Dict[str, Any], pattern: str) -> int:
    found = {int(m.group(1)) for k in state_dict
             for m in [re.match(pattern, k)] if m}
    if found != set(range(len(found))) or not found:
        raise ValueError(f"layers {sorted(found)} are not 0..L-1")
    return len(found)


# --------------------------------------------------------------------- #
# BERT / RoBERTa (post-LN encoder)
# --------------------------------------------------------------------- #
def bert_config_from_hf(hf_config) -> TransformerConfig:
    """The blocks' config from a HF BERT/RoBERTa config (read by
    attribute): post-LN, bidirectional; ``hidden_act`` ``"gelu"`` is the
    erf form, ``"gelu_new"``/``"gelu_pytorch_tanh"`` the tanh form, any
    other activation raises."""
    act = getattr(hf_config, "hidden_act", "gelu")
    if act not in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(
            f"module injection supports GELU activations only, got "
            f"hidden_act='{act}' (the fused blocks compute GELU; injecting "
            "would silently change the model)")
    return TransformerConfig(
        hidden_size=hf_config.hidden_size,
        num_heads=hf_config.num_attention_heads,
        num_layers=hf_config.num_hidden_layers,
        intermediate_size=hf_config.intermediate_size,
        max_seq_length=hf_config.max_position_embeddings,
        vocab_size=hf_config.vocab_size,
        pre_layer_norm=False,              # original BERT is post-LN
        hidden_dropout=hf_config.hidden_dropout_prob,
        attn_dropout=hf_config.attention_probs_dropout_prob,
        layer_norm_eps=hf_config.layer_norm_eps,
        causal=False,
        gelu_exact=act == "gelu",          # HF "gelu" is the erf form
    )


def extract_bert_encoder(state_dict: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """A HF BERT/RoBERTa ``state_dict`` → stacked block params (q, k, v
    concatenated; Linear weights transposed to ``[in, out]``)."""
    pre = find_prefix(state_dict, _BERT_ANCHOR) + "encoder.layer."
    L = _num_layers(state_dict, re.escape(pre) + r"(\d+)\.")

    def layer(i, key):
        return state_dict[f"{pre}{i}.{key}"]

    out = {}
    for name, key, transpose in _BERT_MAP:
        out[name] = torch.stack([layer(i, key).T if transpose
                                 else layer(i, key) for i in range(L)])
    out["qkv_kernel"] = torch.stack([torch.cat(
        [layer(i, f"attention.self.{n}.weight").T for n in _QKV], dim=-1)
        for i in range(L)])
    out["qkv_bias"] = torch.stack([torch.cat(
        [layer(i, f"attention.self.{n}.bias") for n in _QKV], dim=-1)
        for i in range(L)])
    return {k: out[k] for k in sorted(out)}


def restore_bert_encoder(stacked: Dict[str, torch.Tensor],
                         state_dict: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Stacked block params → a NEW ``state_dict``: ``state_dict``'s
    entries with the encoder's replaced by copies of ``stacked``'s
    (the exact inverse of ``extract_bert_encoder``)."""
    pre = find_prefix(state_dict, _BERT_ANCHOR) + "encoder.layer."
    out = dict(state_dict)
    L, H = stacked["ln1_scale"].shape
    for i in range(L):
        for name, key, transpose in _BERT_MAP:
            t = stacked[name][i]
            out[f"{pre}{i}.{key}"] = (t.T if transpose else t).contiguous()
        for j, n in enumerate(_QKV):
            out[f"{pre}{i}.attention.self.{n}.weight"] = \
                stacked["qkv_kernel"][i][:, j * H:(j + 1) * H].T.contiguous()
            out[f"{pre}{i}.attention.self.{n}.bias"] = \
                stacked["qkv_bias"][i][j * H:(j + 1) * H].contiguous()
    return out


# --------------------------------------------------------------------- #
# GPT-2 (pre-LN decoder; Conv1D weights are [in, out], qkv fused)
# --------------------------------------------------------------------- #
def gpt2_config_from_hf(hf_config) -> TransformerConfig:
    return TransformerConfig(
        hidden_size=hf_config.n_embd,
        num_heads=hf_config.n_head,
        num_layers=hf_config.n_layer,
        intermediate_size=getattr(hf_config, "n_inner", None) or
        4 * hf_config.n_embd,
        max_seq_length=hf_config.n_positions,
        vocab_size=hf_config.vocab_size,
        pre_layer_norm=True,
        hidden_dropout=hf_config.resid_pdrop,
        attn_dropout=hf_config.attn_pdrop,
        layer_norm_eps=hf_config.layer_norm_epsilon,
        causal=True,
        gelu_exact=False,                  # GPT-2 uses gelu_new (tanh)
    )


def extract_gpt2_blocks(state_dict: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A HF GPT-2 ``state_dict`` → stacked block params."""
    pre = find_prefix(state_dict, _GPT2_ANCHOR) + "h."
    L = _num_layers(state_dict, re.escape(pre) + r"(\d+)\.")
    out = {name: torch.stack([state_dict[f"{pre}{i}.{key}"]
                              for i in range(L)])
           for name, key in _GPT2_MAP}
    return {k: out[k] for k in sorted(out)}


def restore_gpt2_blocks(stacked: Dict[str, torch.Tensor],
                        state_dict: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """The exact inverse of ``extract_gpt2_blocks`` into a NEW
    ``state_dict``."""
    pre = find_prefix(state_dict, _GPT2_ANCHOR) + "h."
    out = dict(state_dict)
    L = stacked["ln1_scale"].shape[0]
    for i in range(L):
        for name, key in _GPT2_MAP:
            out[f"{pre}{i}.{key}"] = stacked[name][i].contiguous()
    return out

