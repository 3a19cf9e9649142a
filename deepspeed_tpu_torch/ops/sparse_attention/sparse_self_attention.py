"""SparseSelfAttention: attention over a SparsityConfig layout (port of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

``sparse_attention`` hands the layout to ``flash_attention(layout=...)``,
which routes it: the LUT kernels for a host layout (the normal case),
the layout-gated kernels for one held on the card or with an empty row
or column, dense attention with the layout as a mask where a mask, an
``rpe`` bias or a block that is not a multiple of 128 is in play.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..flash_attention import _layout_to_mask, flash_attention
from .sparsity_config import FixedSparsityConfig, SparsityConfig


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     layout, causal: bool = False,
                     mask: Optional[torch.Tensor] = None,
                     rpe: Optional[torch.Tensor] = None,
                     attn_dropout: float = 0.0,
                     rng: Optional[torch.Generator] = None,
                     deterministic: bool = True) -> torch.Tensor:
    """q, k, v: ``[B, S, nH, dH]``; layout ``[nH, S//block, S//block]``.
    Every query row should keep at least one block (the five shipped
    configs do). ``rpe``: additive relative-position bias ``[nH, S, S]``
    or ``[S, S]``, added to the scores as a constant (no gradient)."""
    if rpe is not None:
        if rpe.dim() == 2:
            rpe = rpe[None]
        bias = rpe.detach()[None]                   # [1, nH, S, S]
        mask = bias if mask is None else mask + bias
    return flash_attention(q, k, v, mask=mask, causal=causal,
                           attn_dropout=attn_dropout, rng=rng,
                           deterministic=deterministic, layout=layout)


def sparse_attention_reference(q, k, v, layout, causal: bool = False):
    """Dense attention with the layout as an additive mask (for tests)."""
    from ...models.transformer import dense_attention
    return dense_attention(q, k, v, mask=_layout_to_mask(
        layout, q.shape[1], None, q.device), causal=causal)


class SparseSelfAttention:
    """Module-style wrapper owning a SparsityConfig and a layout cache."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul",
                 max_seq_length: int = 2048):
        self.sparsity_config = sparsity_config or \
            FixedSparsityConfig(num_heads=4)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self._layout_cache: Dict[int, np.ndarray] = {}

    @classmethod
    def from_config(cls, sparse_attention_section: Dict, num_heads: int,
                    **kwargs) -> "SparseSelfAttention":
        """Build from a ds_config ``sparse_attention`` section (the dict
        ``DeepSpeedConfig.sparse_attention`` stores)."""
        from .config_factory import sparsity_config_from_dict
        return cls(sparsity_config_from_dict(sparse_attention_section,
                                             num_heads), **kwargs)

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layout_cache:
            self._layout_cache[seq_len] = \
                self.sparsity_config.make_layout(seq_len)
        return self._layout_cache[seq_len]

    def __call__(self, query: torch.Tensor, key: torch.Tensor,
                 value: torch.Tensor, rpe: Optional[torch.Tensor] = None,
                 key_padding_mask: Optional[torch.Tensor] = None,
                 attn_mask: Optional[torch.Tensor] = None,
                 rng: Optional[torch.Generator] = None,
                 deterministic: bool = True) -> torch.Tensor:
        """query/key/value ``[B, S, nH, dH]``. key_padding_mask ``[B, S]``,
        1 = keep; attn_mask additive broadcastable to ``[B, 1, S, S]``
        ("add" mode) or multiplicative 0/1 ("mul" mode)."""
        S = query.shape[1]
        layout = self.get_layout(S)
        mask = None
        if key_padding_mask is not None:
            pad = 1.0 - key_padding_mask.to(torch.float32)
            mask = pad[:, None, None, :] * -1e30
            if self.key_padding_mask_mode != "add":
                raise NotImplementedError("mul key_padding_mask_mode")
        if attn_mask is not None:
            if self.attn_mask_mode == "mul":
                attn_mask = torch.where(attn_mask != 0, 0.0, -1e30)
            mask = attn_mask if mask is None else mask + attn_mask
        return sparse_attention(query, key, value, layout, causal=False,
                                mask=mask, rpe=rpe, rng=rng,
                                deterministic=deterministic)


__all__ = ["sparse_attention", "sparse_attention_reference",
           "SparseSelfAttention"]
