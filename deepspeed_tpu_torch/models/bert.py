"""BERT encoder family with its MLM head (port of
``deepspeed_tpu/models/bert.py``).

Both variants of the reference's BERT pretraining model, driven by
``pre_layer_norm``: token + position (+ segment) embeddings → embedding
LN → N bidirectional blocks (post-LN, the original BERT; pre-LN, the
``bert-large-preln`` variant) → MLM head (dense + GELU + LN) over the
tied embeddings plus a decoder bias. The blocks are ``models/
transformer.py``'s program, so on a CUDA device they run the flash
kernels with ``causal=False`` (an ``attention_mask`` routes dense, as
in JAX), the residual LayerNorm kernel and the bias+GELU kernels; the
embedding and MLM LayerNorms run the LayerNorm kernel's plain mode.

Tensor parallelism (``bert_param_shardings``, JAX's: ``wte`` and
``decoder_bias`` split by vocab range, the blocks' Megatron specs): the
blocks run the tensor-parallel block, the embedding sums the ranks'
vocab ranges and the MLM head's logits are gathered over them; a
vocabulary the model axis does not divide keeps ``wte`` and
``decoder_bias`` whole on every rank and the head computes the whole
vocabulary there (GSPMD's padded shard computes the same numbers). The
engine binds ``tp`` to ``bert_mlm_loss_fn``'s loss (``loss_fn.tp``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from ..parallel import comm
from ..parallel.topology import P
from ..utils.device import resolve_device
from .gpt2 import embed
from .transformer import (QKV_LEAVES, ElementwiseOps, TransformerConfig,
                          additive_mask, apply_blocks,
                          block_param_shardings, check_trainable,
                          elementwise_ops, init_block_params)

MOE_REFUSED = ("MoE blocks are wired for the GPT-2 training path only "
               "(models/gpt2.py threads the stats tuple); BERT keeps the "
               "dense FFN")


@dataclasses.dataclass(frozen=True)
class BertConfig(TransformerConfig):
    causal: bool = False
    pre_layer_norm: bool = False        # original BERT; preln variant = True
    max_seq_length: int = 512
    vocab_size: int = 30528             # bert-large vocab padded to 64
    type_vocab_size: int = 2

    @property
    def name(self) -> str:
        ln = "preln" if self.pre_layer_norm else "postln"
        return f"bert-h{self.hidden_size}-l{self.num_layers}-{ln}"


BERT_CONFIGS: Dict[str, BertConfig] = {
    "bert-base":  BertConfig(hidden_size=768, num_heads=12, num_layers=12),
    "bert-large": BertConfig(hidden_size=1024, num_heads=16, num_layers=24),
    "bert-large-preln": BertConfig(hidden_size=1024, num_heads=16,
                                   num_layers=24, pre_layer_norm=True),
    "bert-tiny":  BertConfig(hidden_size=128, num_heads=4, num_layers=2,
                             max_seq_length=128, vocab_size=512),
}


def bert_init(cfg: BertConfig, generator: Optional[torch.Generator] = None,
              device: Optional[Union[str, torch.device]] = None
              ) -> Dict[str, Any]:
    """Random fp32 params with the JAX ``bert_init`` tree. ``generator``
    must live on ``device`` (default: a fresh one seeded with 0)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    std = cfg.initializer_range
    H = cfg.hidden_size

    def norm(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * std

    def ones(n):
        return torch.ones(n, device=device, dtype=torch.float32)

    def zeros(n):
        return torch.zeros(n, device=device, dtype=torch.float32)

    params = {
        "wte": norm((cfg.vocab_size, H)),
        "wpe": norm((cfg.max_seq_length, H)),
        "emb_ln_scale": ones(H), "emb_ln_bias": zeros(H),
        "blocks": init_block_params(cfg, generator, device),
        # MLM head: dense + LN + tied-embedding decoder bias.
        "mlm_kernel": norm((H, H)),
        "mlm_bias": zeros(H),
        "mlm_ln_scale": ones(H), "mlm_ln_bias": zeros(H),
        "decoder_bias": zeros(cfg.vocab_size),
    }
    if cfg.type_vocab_size:
        params["wse"] = norm((cfg.type_vocab_size, H))
    return params


# The leaves split by vocabulary range under tensor parallelism: the
# tied embedding and the head's bias, split (or kept whole) together.
VOCAB_LEAVES = ("wte", "decoder_bias")


def bert_param_shardings(cfg: BertConfig, mp_axis: str = "model"
                         ) -> Dict[str, Any]:
    """The ``PartitionSpec`` tree of ``bert_init``'s (JAX
    ``bert_param_shardings``)."""
    sh = {
        "wte": P(mp_axis, None),
        "wpe": P(None, None),
        "emb_ln_scale": P(None), "emb_ln_bias": P(None),
        "blocks": block_param_shardings(mp_axis),
        "mlm_kernel": P(None, None), "mlm_bias": P(None),
        "mlm_ln_scale": P(None), "mlm_ln_bias": P(None),
        "decoder_bias": P(mp_axis),
    }
    if cfg.type_vocab_size:
        sh["wse"] = P(None, None)
    return sh


def bert_apply(params: Dict[str, Any], tokens: torch.Tensor, cfg: BertConfig,
               segment_ids: Optional[torch.Tensor] = None,
               attention_mask: Optional[torch.Tensor] = None,
               rng: Optional[torch.Generator] = None,
               deterministic: bool = True,
               attention_fn: Optional[Callable] = None,
               ops: Optional[ElementwiseOps] = None,
               tp: Any = None) -> torch.Tensor:
    """tokens [B, S] → final hidden states [B, S, H] (``tp``: this
    rank's parts of the tensor-parallel leaves).

    ``attention_mask`` [B, S] with 1 = attend becomes the additive [B, 1,
    1, S] form (``transformer.additive_mask``). ``attention_fn`` defaults
    to ``auto_attention``; ``ops`` to the ones ``cfg.fused_kernels``
    selects (``PLAIN_OPS`` with ``dense_attention`` is the plain
    reference)."""
    if cfg.moe is not None:
        raise NotImplementedError(MOE_REFUSED)
    ops = ops or elementwise_ops(cfg, tokens.device)
    S = tokens.shape[1]
    x = embed(params["wte"].to(cfg.dtype), tokens, tp) + \
        params["wpe"].to(cfg.dtype)[None, :S]
    if cfg.type_vocab_size and segment_ids is not None:
        x = x + params["wse"].to(cfg.dtype)[segment_ids]
    x = ops.ln(x, params["emb_ln_scale"], params["emb_ln_bias"],
               cfg.layer_norm_eps)
    return apply_blocks(params["blocks"], x, cfg, rng=rng,
                        deterministic=deterministic,
                        attention_fn=attention_fn, ops=ops,
                        mask=additive_mask(attention_mask), tp=tp)


def bert_mlm_logits(params: Dict[str, Any], hidden: torch.Tensor,
                    cfg: BertConfig,
                    ops: Optional[ElementwiseOps] = None,
                    tp: Any = None) -> torch.Tensor:
    """The MLM head: tanh GELU of the dense layer, LN, then the tied
    embeddings plus ``decoder_bias`` → logits [B, S, V] in the compute
    dtype (a vocab-split ``tp`` gathers the ranks' ranges)."""
    ops = ops or elementwise_ops(cfg, hidden.device)
    h = ops.gelu_up(hidden, params["mlm_kernel"], params["mlm_bias"], False)
    h = ops.ln(h, params["mlm_ln_scale"], params["mlm_ln_bias"],
               cfg.layer_norm_eps)
    if tp is not None and tp.vocab:
        h = tp.copy_in(h)
    logits = torch.matmul(h, params["wte"].to(h.dtype).T) + \
        params["decoder_bias"].to(h.dtype)
    if tp is not None and tp.vocab:
        logits = comm.gather_from_group(logits, -1, tp.group)
    return logits


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over ``labels >= 0`` of the fp32 log-softmax's negative
    log-likelihood (labels -100 at unmasked positions, the HF
    convention); 0 where no label is valid. No host read."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    denom = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / denom


def bert_mlm_loss_fn(cfg: BertConfig, attention_fn: Optional[Callable] = None,
                     ops: Optional[ElementwiseOps] = None) -> Callable:
    """Returns ``loss_fn(params, batch, rng=None)`` for the engine; batch
    = ``(tokens, labels[, attention_mask])`` with labels -100 at the
    unmasked positions. ``cfg.remat_policy`` recomputes the blocks in
    the backward pass, as for GPT-2. ``loss_fn.param_shardings``,
    ``vocab_leaves``, ``qkv_leaves`` and ``tp``: as ``gpt2_loss_fn``'s."""
    check_trainable(cfg)

    def loss_fn(params, batch, rng=None):
        tp = loss_fn.tp
        tokens, labels = batch[0], batch[1]
        attn_mask = batch[2] if len(batch) > 2 else None
        hidden = bert_apply(params, tokens, cfg, attention_mask=attn_mask,
                            rng=rng, deterministic=False,
                            attention_fn=attention_fn, ops=ops, tp=tp)
        return mlm_loss(bert_mlm_logits(params, hidden, cfg, ops, tp),
                        labels)
    loss_fn.cfg = cfg
    loss_fn.param_shardings = bert_param_shardings(cfg)
    loss_fn.vocab_leaves, loss_fn.qkv_leaves = VOCAB_LEAVES, QKV_LEAVES
    loss_fn.tp = None
    return loss_fn


def bert_num_params(cfg: BertConfig) -> int:
    """Every parameter of the tree ``bert_init`` builds."""
    H, L, F, V, S = (cfg.hidden_size, cfg.num_layers, cfg.ffn_size,
                     cfg.vocab_size, cfg.max_seq_length)
    per_block = 4 * H + 3 * H * H + 3 * H + H * H + H + 2 * H * F + F + H
    return (V * H + S * H + cfg.type_vocab_size * H + 2 * H + L * per_block
            + H * H + 3 * H + V)


__all__ = ["BertConfig", "BERT_CONFIGS", "VOCAB_LEAVES", "bert_init",
           "bert_param_shardings", "bert_apply",
           "bert_mlm_logits", "mlm_loss", "bert_mlm_loss_fn",
           "bert_num_params", "MOE_REFUSED"]
