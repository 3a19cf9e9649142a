"""Chunked softmax cross-entropy over a tied unembedding (port of
``deepspeed_tpu/ops/cross_entropy.py``).

The loss head as a ``torch.autograd.Function`` that never holds the
[tokens, vocab] logits: the forward computes the loss chunk by chunk
over tokens and saves only each token's logsumexp (4 bytes a token);
the backward recomputes each chunk's logits once and contracts them at
once into ``dx`` and ``dwte``. The cost is one extra logits product.

Precision. The JAX head asks for fp32 logits from compute-dtype
operands (``preferred_element_type=float32``): a vocab-50304 logsumexp
over logits rounded to bf16 would move the loss. A bf16 ``torch.matmul``
rounds its output to bf16, so on the card the products here go through
``torch.mm(..., out_dtype=torch.float32)`` (bf16/fp16 operands, fp32
accumulate and output, at the tensor cores' bf16 rate); the price is
the fp32 write and re-read of each [chunk, vocab] block, twice the
bytes of a bf16 one. On the CPU (the tests) the operands are widened to
fp32, which computes the same products exactly. The products are plain
matrix products outside any kernel of the JAX package, so they stay
with the library, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import logging
import os

import torch

# Target fp32-logits bytes per chunk (the JAX module's default, with the
# same environment override).
_CHUNK_BYTES = int(os.environ.get("DS_CE_CHUNK_BYTES", 512 * 1024 * 1024))
_MAX_CHUNKS = 64


def pick_chunks(n_tokens: int, vocab: int) -> int:
    """Smallest divisor of n_tokens >= the memory-target chunk count,
    bounded at _MAX_CHUNKS; else the largest divisor under the bound."""
    total = n_tokens * vocab * 4
    target = max(1, -(-total // _CHUNK_BYTES))
    best = 1
    for c in range(1, min(_MAX_CHUNKS, n_tokens) + 1):
        if n_tokens % c == 0:
            best = c
            if c >= target:
                return c
    if target > 1:
        logging.getLogger(__name__).warning(
            "chunked cross-entropy: n_tokens=%d has no divisor >= %d under "
            "%d chunks; falling back to %d chunk(s)", n_tokens, target,
            _MAX_CHUNKS, best)
    return best


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with fp32 accumulation and an fp32 result."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _resolve(n_chunks: int, N: int, V: int) -> int:
    return n_chunks if n_chunks > 0 else pick_chunks(N, V)


class _ChunkedSoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wte, targets, n_chunks):
        N = x.shape[0]
        C = _resolve(n_chunks, N, wte.shape[0])
        xs = x.reshape(C, N // C, -1)
        ts = targets.reshape(C, N // C).long()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = []
        for i in range(C):
            logits = mm_f32(xs[i], wte.t())                 # [c, V] fp32
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(1, ts[i][:, None])[:, 0]
            total = total + torch.sum(lse - tgt)
            lses.append(lse)
        ctx.save_for_backward(x, wte, targets, torch.stack(lses))
        ctx.n_chunks = n_chunks
        return total / N

    @staticmethod
    def backward(ctx, g):
        x, wte, targets, lses = ctx.saved_tensors
        N = x.shape[0]
        C = _resolve(ctx.n_chunks, N, wte.shape[0])
        xs = x.reshape(C, N // C, -1)
        ts = targets.reshape(C, N // C).long()
        gn = (g / N).float()
        dwte = torch.zeros(wte.shape, dtype=torch.float32, device=x.device)
        dxs = []
        for i in range(C):
            logits = mm_f32(xs[i], wte.t())
            dl = torch.exp(logits - lses[i][:, None])       # softmax [c, V]
            dl.scatter_add_(1, ts[i][:, None], torch.full_like(
                dl[:, :1], -1.0))
            dlc = (dl * gn).to(x.dtype)
            dxs.append(mm_f32(dlc, wte).to(x.dtype))
            dwte = dwte + mm_f32(dlc.t(), xs[i])
        return (torch.stack(dxs).reshape(x.shape), dwte.to(wte.dtype), None,
                None)


def chunked_softmax_xent(x: torch.Tensor, wte: torch.Tensor,
                         targets: torch.Tensor,
                         n_chunks: int = 0) -> torch.Tensor:
    """Mean next-token CE of ``x @ wte.T`` against ``targets``.

    x: [N, H] activations (compute dtype); wte: [V, H] tied embedding
    (compute dtype); targets: [N] int. Returns the fp32 mean NLL."""
    return _ChunkedSoftmaxXent.apply(x, wte, targets, n_chunks)


__all__ = ["chunked_softmax_xent", "pick_chunks", "mm_f32"]
