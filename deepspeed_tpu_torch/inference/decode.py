"""Incremental GPT-2 forward paths against the paged block pool: decode,
the speculative verify step, chunked prefill and whole-prompt prefill
(port of the paged half of ``deepspeed_tpu/inference/decode.py``; the
slot-major cache runs these same paths through a fixed identity table,
``inference/kv_cache.KVCacheSpec``).

The incremental paths keep the JAX order in every layer: write the new
tokens' K/V rows through the block table, then attend inclusively — each
query row sees its own position — with the paged-attention kernel.
Whole-prompt prefill instead runs the padded prompt through causal
``auto_attention`` (the flash forward kernel on a CUDA device) and
writes each layer's K/V through the slot's table. LayerNorm and the
FFN's bias+GELU are the fused kernels; the QKV, projection, FFN and
tied-unembedding matmuls stay with ``torch.matmul``.

Tensor parallelism (``tp``, a ``parallel/tensor_parallel.
ModelParallel``): each rank holds its heads' K/V pools and its parts of
the weights (``gpt2_param_shardings``); the paged-attention kernel runs
on the rank's heads with the same block tables (no communication, as in
JAX's per-shard kernel), the row-parallel products are summed over the
model group, the embedding sums the vocab ranges and the logits are
gathered over them.

PyTorch idiom: the K/V pools ``kc``/``vc`` ([L, G, B, nH, bs, D]) are
updated IN PLACE and the functions return only the logits. Token ids,
lengths, block tables and prefill offsets are host-side state; the
functions take them as tensors on any device (host tensors avoid a
device sync), derive the write plan on the host, and move what the
device needs once per call.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .kv_cache import (DEAD_BLOCK, WritePlan, positions_to_blocks,
                       write_plan, write_rows_planned)
from ..models.gpt2 import GPT2Config, embed, unembed
from ..models.transformer import (dense, gelu_dense_fn, layer_norm_fn,
                                  layer_slice)
from ..ops.flash_attention import auto_attention
from ..ops.paged_attention import paged_attention


def _check_cfg(cfg: GPT2Config) -> None:
    if not cfg.pre_layer_norm or not cfg.causal:
        raise NotImplementedError(
            "the incremental decode path implements the GPT-2 block "
            "(pre-LN, causal)")
    if cfg.moe is not None:
        raise NotImplementedError(
            "the decode path has no MoE blocks (nor does the JAX "
            "package's inference engine)")


def _host(t) -> torch.Tensor:
    return torch.as_tensor(t).to("cpu").long()


def _embed(params: Dict[str, Any], tokens: torch.Tensor, pos: torch.Tensor,
           cfg: GPT2Config, tp: Any = None) -> torch.Tensor:
    """Token + position embeddings. Positions past the table clamp to its
    last row, as the JAX gather does (draft or padding rows beyond
    max_seq_len compute garbage that nothing reads)."""
    wpe = params["wpe"]
    pos = pos.clamp(0, wpe.shape[0] - 1)
    return embed(params["wte"].to(cfg.dtype), tokens, tp) + \
        wpe.to(cfg.dtype)[pos]


def _heads(cfg: GPT2Config, tp: Any) -> int:
    """The heads this rank holds."""
    return cfg.num_heads if tp is None else \
        tp.local(cfg.num_heads, "num_heads")


def _row(tp: Any) -> Callable:
    """The row-parallel product under ``tp`` (``ModelParallel.row_dense``),
    the plain ``dense`` without."""
    return dense if tp is None else tp.row_dense


def _ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: GPT2Config,
         tp: Any = None) -> torch.Tensor:
    h = layer_norm_fn(cfg)(x, p["ln2_scale"], p["ln2_bias"])
    h = gelu_dense_fn(cfg)(h, p["fc_kernel"], p["fc_bias"])
    return x + _row(tp)(h, p["fc_out_kernel"], p["fc_out_bias"])


def _qkv(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: GPT2Config,
         tp: Any = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ln1 + QKV projection; x [..., H] → q, k, v [..., nH, D] (the
    rank's heads under ``tp``)."""
    h = layer_norm_fn(cfg)(x, p["ln1_scale"], p["ln1_bias"])
    qkv = dense(h, p["qkv_kernel"], p["qkv_bias"])
    nH = _heads(cfg, tp)
    split = x.shape[:-1] + (nH, cfg.head_dim)
    q, k, v = qkv.split(nH * cfg.head_dim, dim=-1)
    return q.reshape(split), k.reshape(split), v.reshape(split)


def _paged_attn_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
                      kc: torch.Tensor, vc: torch.Tensor,
                      bt_g: torch.Tensor, pos_g: torch.Tensor,
                      plan: WritePlan, cfg: GPT2Config,
                      tp: Any = None) -> torch.Tensor:
    """One layer of the paged paths. x: [S, K, H] — K tokens for each of
    S = G * Sg query streams; kc/vc: this layer's [G, B, nH, bs, D] pool
    (written in place); bt_g [G, Sg, J] and pos_g [G, Sg, K] int32 on the
    device; ``plan`` places the S*K new K/V rows."""
    S, K, _ = x.shape
    G, Sg = bt_g.shape[:2]
    nH, D = _heads(cfg, tp), cfg.head_dim
    q, k, v = _qkv(p, x, cfg, tp)                      # [S, K, nH, D]
    write_rows_planned(kc, k.reshape(G, Sg * K, nH, D), plan)
    write_rows_planned(vc, v.reshape(G, Sg * K, nH, D), plan)
    attn = paged_attention(q.reshape(G, Sg, K, nH, D).contiguous(), kc, vc,
                           bt_g, pos_g, scale=1.0 / math.sqrt(D))
    attn = attn.reshape(S, K, nH * D).to(x.dtype)
    x = x + _row(tp)(attn, p["proj_kernel"], p["proj_bias"])
    return _ffn(p, x, cfg, tp)


def _layers(params: Dict[str, Any], x: torch.Tensor, kc: torch.Tensor,
            vc: torch.Tensor, bt_g: torch.Tensor, pos_g: torch.Tensor,
            cfg: GPT2Config, tp: Any = None) -> torch.Tensor:
    """Every layer over x [S, K, H], on host bt_g [G, Sg, J] / pos_g
    [G, Sg, K]. Returns the pre-ln_f hidden states."""
    G, Sg, K = pos_g.shape
    J = bt_g.shape[-1]
    dev = x.device
    blk, off = positions_to_blocks(
        bt_g[:, :, None, :].expand(G, Sg, K, J).reshape(G, Sg * K, J),
        pos_g.reshape(G, Sg * K), kc.shape[4])
    plan = write_plan(blk, off, kc.shape[2]).to(dev)
    bt_d = bt_g.to(dev, torch.int32)
    pos_d = pos_g.to(dev, torch.int32)
    blocks = params["blocks"]
    for i in range(kc.shape[0]):
        x = _paged_attn_block(layer_slice(blocks, i), x, kc[i], vc[i],
                              bt_d, pos_d, plan, cfg, tp)
    return x


def gpt2_verify_paged(params: Dict[str, Any], kc: torch.Tensor,
                      vc: torch.Tensor, tokens, lengths, block_tables,
                      cfg: GPT2Config, num_groups: int = 1,
                      tp: Any = None) -> torch.Tensor:
    """The speculative verify step — and, at K = 1, plain paged decode.

    tokens: [S, K] — column 0 is each slot's pending last token, columns
    1.. the drafted continuation; token i sits at position lengths[s] + i.
    Writes all K tokens' K/V through the block tables [S, J] (into the
    pools, in place), attends each under its own causal row, and returns
    fp32 logits [S, K, V]."""
    _check_cfg(cfg)
    tokens, lengths, bt = _host(tokens), _host(lengths), _host(block_tables)
    S, K = tokens.shape
    G = num_groups
    pos = lengths[:, None] + torch.arange(K)                     # [S, K]
    dev = params["wte"].device
    x = _embed(params, tokens.to(dev), pos.to(dev), cfg, tp)
    x = _layers(params, x, kc, vc, bt.reshape(G, S // G, -1),
                pos.reshape(G, S // G, K), cfg, tp)
    x = layer_norm_fn(cfg)(x, params["ln_f_scale"], params["ln_f_bias"])
    return unembed(x, params["wte"].to(cfg.dtype), tp).float()


def gpt2_decode_paged(params: Dict[str, Any], kc: torch.Tensor,
                      vc: torch.Tensor, tokens, lengths, block_tables,
                      cfg: GPT2Config, num_groups: int = 1,
                      tp: Any = None) -> torch.Tensor:
    """One paged decode step for every slot (the K = 1 verify):
    tokens/lengths [S] → fp32 logits [S, V]."""
    return gpt2_verify_paged(params, kc, vc, _host(tokens)[:, None],
                             lengths, block_tables, cfg, num_groups,
                             tp)[:, 0]


def gpt2_prefill_chunk_paged(params: Dict[str, Any], kc: torch.Tensor,
                             vc: torch.Tensor, tokens, bt_rows, start,
                             last_idx, active, cfg: GPT2Config,
                             tp: Any = None) -> torch.Tensor:
    """Group-batched chunked prefill: one prompt chunk for ONE slot per
    group.

    tokens: [G, C]; bt_rows: [G, J] — each group's target slot's table
    row; start/last_idx/active: [G]. Writes each chunk's K/V through its
    group's table and attends against the slot's whole cached row under
    the global-position causal mask. Inactive groups write nowhere.
    Returns fp32 logits [G, V] at chunk row ``last_idx``."""
    _check_cfg(cfg)
    tokens, bt_rows, start = _host(tokens), _host(bt_rows), _host(start)
    last_idx, active = _host(last_idx), _host(active)
    G, C = tokens.shape
    pos = start[:, None] + torch.arange(C)                       # [G, C]
    bt_g = torch.where(active[:, None] > 0, bt_rows,
                       DEAD_BLOCK)[:, None, :]                   # [G, 1, J]
    dev = params["wte"].device
    x = _embed(params, tokens.to(dev), pos.to(dev), cfg, tp)     # [G, C, H]
    x = _layers(params, x, kc, vc, bt_g, pos[:, None, :], cfg, tp)
    h_last = x[torch.arange(G, device=dev), last_idx.to(dev)]   # [G, H]
    h_last = layer_norm_fn(cfg)(h_last, params["ln_f_scale"],
                                params["ln_f_bias"])
    return unembed(h_last, params["wte"].to(cfg.dtype), tp).float()


def gpt2_prefill_full_paged(params: Dict[str, Any], kc: torch.Tensor,
                            vc: torch.Tensor, tokens, bt_rows, last_idx: int,
                            cfg: GPT2Config,
                            attention_fn: Optional[Callable] = None,
                            tp: Any = None) -> torch.Tensor:
    """Whole-prompt single-shot prefill (``prefill_chunk: 0``) into the
    block pool.

    tokens: [T], the prompt padded to the slot's capacity; bt_rows:
    [G, J] — the slot's table row in its own group, DEAD_BLOCK rows
    elsewhere. The whole sequence goes through ``attention_fn`` (default
    ``auto_attention``) causally, so the padding never reaches a real
    position; each layer's K/V rows are written through the table in
    place (positions past the slot's blocks land nowhere). Returns the
    fp32 logits [V] at position ``last_idx``. Under sequence parallelism
    ``attention_fn`` is the ring (``ops/ring_attention.ring_attention_fn``),
    as JAX's whole-prompt prefill runs it."""
    _check_cfg(cfg)
    attention_fn = attention_fn or auto_attention
    tokens, bt = _host(tokens), _host(bt_rows)
    T = tokens.shape[0]
    G, J = bt.shape
    nH, D = _heads(cfg, tp), cfg.head_dim
    dev = params["wte"].device
    blk, off = positions_to_blocks(bt[:, None, :].expand(G, T, J),
                                   torch.arange(T).expand(G, T), kc.shape[4])
    plan = write_plan(blk, off, kc.shape[2]).to(dev)
    x = (embed(params["wte"].to(cfg.dtype), tokens.to(dev), tp) +
         params["wpe"].to(cfg.dtype)[:T])[None]              # [1, T, H]
    blocks = params["blocks"]
    for i in range(kc.shape[0]):
        p = layer_slice(blocks, i)
        q, k, v = _qkv(p, x, cfg, tp)                         # [1, T, nH, D]
        write_rows_planned(kc[i], k.expand(G, T, nH, D), plan)
        write_rows_planned(vc[i], v.expand(G, T, nH, D), plan)
        attn = attention_fn(q, k, v, mask=None, causal=True,
                            deterministic=True)
        attn = attn.reshape(1, T, nH * D).to(x.dtype)
        x = _ffn(p, x + _row(tp)(attn, p["proj_kernel"], p["proj_bias"]),
                 cfg, tp)
    h_last = layer_norm_fn(cfg)(x[0, int(last_idx)][None],
                                params["ln_f_scale"], params["ln_f_bias"])
    return unembed(h_last, params["wte"].to(cfg.dtype), tp).float()[0]


def spec_accept(logits: torch.Tensor, tokens: torch.Tensor,
                generator: torch.Generator, temperature: float
                ) -> torch.Tensor:
    """Draft acceptance, the longest agreeing prefix rule.

    logits: [S, K, V] from the verify step over [last, d_1..d_{K-1}];
    tokens: the [S, K] verify input (same device). Draft d_i is accepted
    iff every d_{i' <= i} matched the target token at its position; the
    emitted stream is the targets g[s, :m+1]. Returns [S, K+1] int32:
    column 0 is n_new, columns 1..K the emitted tokens — one tensor, ONE
    host fetch per iteration."""
    S, K = tokens.shape
    g = sample_tokens(logits, generator, temperature)            # [S, K]
    if K > 1:
        match = (tokens[:, 1:] == g[:, :-1]).int()
        acc = torch.cumprod(match, dim=-1).sum(-1)
    else:
        acc = torch.zeros(S, dtype=torch.int64, device=logits.device)
    n_new = (acc + 1).to(torch.int32)
    return torch.cat([n_new[:, None], g], dim=-1)


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temperature: float) -> torch.Tensor:
    """Greedy (temperature == 0: argmax, first maximum on ties) or
    temperature sampling with ``torch.multinomial`` on the engine's
    generator; logits [..., V] fp32 → int32 [...]."""
    if temperature > 0:
        probs = torch.softmax(logits / max(float(temperature), 1e-6), -1)
        flat = probs.reshape(-1, probs.shape[-1])
        out = torch.multinomial(flat, 1, generator=generator)
        return out.reshape(logits.shape[:-1]).to(torch.int32)
    return logits.argmax(-1).to(torch.int32)


__all__ = ["gpt2_decode_paged", "gpt2_verify_paged",
           "gpt2_prefill_chunk_paged", "gpt2_prefill_full_paged",
           "spec_accept", "sample_tokens"]
