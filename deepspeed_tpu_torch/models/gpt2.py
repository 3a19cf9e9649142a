"""GPT-2 causal language model family (port of
``deepspeed_tpu/models/gpt2.py``).

token+position embeddings → N pre-LN blocks → final LN → tied-embedding
logits → next-token cross-entropy. ``gpt2_loss_fn`` is the training
loss the engine differentiates (kernel-backed elementwise ops, chunked
cross-entropy head; with ``cfg.moe`` plus the weighted MoE aux and
z losses); ``gpt2_apply`` is the plain full-sequence forward
on the reference ops and ``dense_attention``: the CPU tests hold it
against the JAX ``gpt2_apply``, and ``chip_smoke.py`` holds the serving
engine's logits against it on the card.

Tensor parallelism (``tp``, a ``parallel/tensor_parallel.ModelParallel``;
``gpt2_param_shardings`` gives the placement): the blocks run the
Megatron block of ``models/transformer.block_program``; ``wte`` is split
by vocab range (where mp divides the vocabulary: ``tp.vocab``), the
embedding looks up the rows it holds and sums the ranges
(``comm.vocab_parallel_embedding``), and the head is the vocab-parallel
chunked cross-entropy; the tied ``wte``'s grad is the sum of the two
uses on each rank. The engine binds ``tp`` to ``gpt2_loss_fn``'s loss
(``loss_fn.tp``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from ..ops.cross_entropy import chunked_softmax_xent
from ..parallel import comm
from ..parallel.topology import P
from ..utils.device import resolve_device
from .transformer import (PLAIN_OPS, QKV_LEAVES, ElementwiseOps,
                          TransformerConfig, apply_blocks,
                          block_param_shardings, check_trainable,
                          dense_attention, elementwise_ops,
                          init_block_params)


@dataclasses.dataclass(frozen=True)
class GPT2Config(TransformerConfig):
    causal: bool = True
    pre_layer_norm: bool = True
    max_seq_length: int = 1024
    vocab_size: int = 50304            # padded to a multiple of 128

    @property
    def name(self) -> str:
        return f"gpt2-h{self.hidden_size}-l{self.num_layers}"


GPT2_CONFIGS: Dict[str, GPT2Config] = {
    "gpt2-small":  GPT2Config(hidden_size=768,  num_heads=12, num_layers=12),
    "gpt2-medium": GPT2Config(hidden_size=1024, num_heads=16, num_layers=24),
    "gpt2-large":  GPT2Config(hidden_size=1280, num_heads=20, num_layers=36),
    "gpt2-xl":     GPT2Config(hidden_size=1600, num_heads=25, num_layers=48),
    "gpt2-tiny":   GPT2Config(hidden_size=128,  num_heads=4,  num_layers=2,
                              max_seq_length=128, vocab_size=512),  # tests
}


def gpt2_init(cfg: GPT2Config, generator: Optional[torch.Generator] = None,
              device: Optional[Union[str, torch.device]] = None
              ) -> Dict[str, Any]:
    """Random fp32 params with the JAX ``gpt2_init`` tree. ``generator``
    must live on ``device`` (default: a fresh one seeded with 0)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    std = cfg.initializer_range
    H = cfg.hidden_size

    def norm(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * std

    return {
        "wte": norm((cfg.vocab_size, H)),
        "wpe": norm((cfg.max_seq_length, H)),
        "blocks": init_block_params(cfg, generator, device),
        "ln_f_scale": torch.ones(H, device=device),
        "ln_f_bias": torch.zeros(H, device=device),
    }


# The leaves split by vocabulary range under tensor parallelism (the
# tied embedding and head); the blocks' fused QKV leaves are the
# transformer's QKV_LEAVES.
VOCAB_LEAVES = ("wte",)


def gpt2_param_shardings(cfg: GPT2Config, mp_axis: str = "model"
                         ) -> Dict[str, Any]:
    """The ``PartitionSpec`` tree of ``gpt2_init``'s (JAX
    ``gpt2_param_shardings``): ``wte`` split by vocab, the blocks'
    Megatron specs, the rest replicated."""
    return {
        "wte": P(mp_axis, None),
        "wpe": P(None, None),
        "blocks": block_param_shardings(mp_axis),
        "ln_f_scale": P(None),
        "ln_f_bias": P(None),
    }


def embed(wte: torch.Tensor, tokens: torch.Tensor, tp: Any = None
          ) -> torch.Tensor:
    """Rows ``tokens`` of the (compute-dtype) embedding; under a
    vocab-split ``tp`` the rank's range, summed over the group."""
    if tp is not None and tp.vocab:
        return comm.vocab_parallel_embedding(wte, tokens,
                                             tp.rank * wte.shape[0],
                                             tp.group)
    return wte[tokens]


def unembed(x: torch.Tensor, wte: torch.Tensor, tp: Any = None
            ) -> torch.Tensor:
    """The tied head's logits ``x @ wte.T`` over the whole vocab (a
    vocab-split ``tp`` gathers the ranges)."""
    if tp is not None and tp.vocab:
        return comm.gather_from_group(torch.matmul(tp.copy_in(x), wte.T),
                                      -1, tp.group)
    return torch.matmul(x, wte.T)


def gpt2_hidden(params: Dict[str, Any], tokens: torch.Tensor,
                cfg: GPT2Config, rng: Optional[torch.Generator] = None,
                deterministic: bool = True,
                attention_fn: Optional[Callable] = None,
                ops: Optional[ElementwiseOps] = None,
                with_moe_stats: bool = False,
                pld_theta: Optional[float] = None, zero3: Any = None,
                tp: Any = None):
    """tokens [B, S] → final hidden states [B, S, H] (post ln_f).
    ``attention_fn`` defaults to ``auto_attention`` (the flash kernels on
    a CUDA device, dense attention on the CPU); ``ops`` defaults to the
    ones ``cfg.fused_kernels`` selects. ``with_moe_stats=True`` returns
    ``(hidden, moe_stats_or_None)``. ``pld_theta``: progressive layer
    drop's keep probability (``apply_blocks``). ``zero3``: a
    ``Zero3Scan``; bound, the stacked block params arrive as this rank's
    parts and the layers run as the ZeRO-3 scan (``apply_blocks``).
    ``tp``: this rank's parts of the tensor-parallel leaves (module
    docstring)."""
    ops = ops or elementwise_ops(cfg, tokens.device)
    S = tokens.shape[1]
    x = embed(params["wte"].to(cfg.dtype), tokens, tp) + \
        params["wpe"].to(cfg.dtype)[None, :S]
    out = apply_blocks(params["blocks"], x, cfg, rng=rng,
                       deterministic=deterministic,
                       attention_fn=attention_fn, ops=ops,
                       pld_theta=pld_theta, zero3=zero3, tp=tp)
    x, moe_stats = out if cfg.moe is not None else (out, None)
    h = ops.ln(x, params["ln_f_scale"], params["ln_f_bias"],
               cfg.layer_norm_eps)
    return (h, moe_stats) if with_moe_stats else h


def gpt2_apply(params: Dict[str, Any], tokens: torch.Tensor,
               cfg: GPT2Config, tp: Any = None) -> torch.Tensor:
    """tokens [B, S] int → logits [B, S, V] in the compute dtype, on the
    plain reference ops and dense attention, deterministic (``tp``: this
    rank's parts; the logits come back whole)."""
    x = gpt2_hidden(params, tokens, cfg, attention_fn=dense_attention,
                    ops=PLAIN_OPS, tp=tp)
    return unembed(x, params["wte"].to(cfg.dtype), tp)


def gpt2_loss_fn(cfg: GPT2Config, attention_fn: Optional[Callable] = None,
                 ops: Optional[ElementwiseOps] = None,
                 zero3: Any = None) -> Callable:
    """Returns ``loss_fn(params, batch, rng=None, pld_theta=None)`` for
    the engine.

    batch: tokens [B, S+1] (inputs ``[:, :-1]``, targets ``[:, 1:]``) or
    a ``(tokens, targets)`` pair; rng: a ``torch.Generator`` on the
    batch's device for dropout, or None. The head is the chunked
    cross-entropy (``ops/cross_entropy.py``), so the [tokens, vocab]
    logits never exist at once. ``attention_fn`` defaults to
    ``auto_attention`` (the flash kernels on a CUDA device, dense
    attention on the CPU); ``ops`` defaults to the kernels. ``PLAIN_OPS``
    with ``flash_attention_plain`` gives the plain-autograd reference of
    the same step. ``cfg.remat_policy`` recomputes activations in the
    backward pass; ``pld_theta`` (the engine passes it under a
    ``progressive_layer_drop`` block) drops layers (``apply_blocks``).

    With ``cfg.moe`` the loss gains ``aux_loss_weight * aux_loss +
    z_loss_weight * z_loss`` (averaged over the MoE layers) and the fn
    returns ``(loss, {"moe": stats})``; the engine turns the stats into
    its ``moe_*`` metrics.

    ``zero3``: pass the SAME ``runtime/zero/stage3.Zero3Scan`` here and
    to ``deepspeed_tpu_torch.initialize(..., zero3_scan=...)``; a
    stage-3 engine at dp > 1 binds it, and the layers then run as the
    ZeRO-3 prefetched scan. Unbound it changes nothing.

    ``loss_fn.param_shardings`` is the placement its tensor-parallel
    program takes (``gpt2_param_shardings``), ``loss_fn.vocab_leaves``
    and ``loss_fn.qkv_leaves`` the leaves it splits by vocabulary range
    and by heads of each of q, k and v; an engine at mp > 1 sets
    ``loss_fn.tp`` to its ``ModelParallel`` and hands it the rank's
    parts."""
    check_trainable(cfg)

    def loss_fn(params, batch, rng=None, pld_theta=None):
        tp = loss_fn.tp
        if isinstance(batch, (tuple, list)):
            tokens, targets = batch[0], batch[1]
        else:
            tokens, targets = batch[:, :-1], batch[:, 1:]
        x, moe_stats = gpt2_hidden(params, tokens, cfg, rng=rng,
                                   deterministic=False,
                                   attention_fn=attention_fn, ops=ops,
                                   with_moe_stats=True, pld_theta=pld_theta,
                                   zero3=zero3, tp=tp)
        B, S = tokens.shape
        x = x.reshape(B * S, -1)
        vocab_tp = tp if tp is not None and tp.vocab else None
        loss = chunked_softmax_xent(
            x if vocab_tp is None else tp.copy_in(x),
            params["wte"].to(cfg.dtype), targets.reshape(-1), tp=vocab_tp)
        if moe_stats is None:
            return loss
        moe = cfg.moe
        loss = loss + moe.aux_loss_weight * moe_stats["aux_loss"] \
            + moe.z_loss_weight * moe_stats["z_loss"]
        return loss, {"moe": moe_stats}
    loss_fn.cfg = cfg
    loss_fn.zero3 = zero3
    loss_fn.param_shardings = gpt2_param_shardings(cfg)
    loss_fn.vocab_leaves, loss_fn.qkv_leaves = VOCAB_LEAVES, QKV_LEAVES
    loss_fn.tp = None
    return loss_fn


def gpt2_num_params(cfg: GPT2Config) -> int:
    """The dense model's parameters (one FFN a block, as in the JAX
    package: the expert FFNs of a MoE model are not counted)."""
    H, L, F, V, S = (cfg.hidden_size, cfg.num_layers, cfg.ffn_size,
                     cfg.vocab_size, cfg.max_seq_length)
    per_block = 4 * H + 3 * H * H + 3 * H + H * H + H + 2 * H * F + F + H
    return V * H + S * H + L * per_block + 2 * H


def gpt2_flops_per_token(cfg: GPT2Config,
                         seq_len: Optional[int] = None) -> float:
    """Training FLOPs/token = 6·N_matmul + the attention term (PaLM
    appendix B counting); N_matmul includes the tied unembedding."""
    S = seq_len or cfg.max_seq_length
    H, L = cfg.hidden_size, cfg.num_layers
    n = gpt2_num_params(cfg) - cfg.vocab_size * H - cfg.max_seq_length * H
    n += cfg.vocab_size * H    # tied unembedding matmul
    return 6.0 * n + 12.0 * L * H * S


__all__ = ["GPT2Config", "GPT2_CONFIGS", "VOCAB_LEAVES", "gpt2_init",
           "gpt2_param_shardings",
           "embed", "unembed", "gpt2_hidden",
           "gpt2_apply", "gpt2_loss_fn", "gpt2_num_params",
           "gpt2_flops_per_token"]
