"""Adapting pretrained transformers to sparse self-attention (port of
``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``).

The reference's ``SparseAttentionUtils``: position-embedding extension,
the tokenizer's max-length update, the self-attention swap for HF
BERT/RoBERTa, and pad/unpad to the sparsity block. As in the JAX
package the swap is functional: the HF encoder weights are re-stacked
through ``module_inject`` (from the model's PyTorch ``state_dict``) and
run by ``models/transformer.apply_blocks`` with a block-sparse
``attention_fn`` — on a CUDA device the LUT kernels of
``ops/sparse_flash.py`` (K7, K8). Position-embedding extension and
padding are tensor ops on the ``state_dict`` and the inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .sparse_self_attention import SparseSelfAttention, sparse_attention
from .sparsity_config import FixedSparsityConfig, SparsityConfig

_POSITION_KEY = "embeddings.position_embeddings.weight"
_POSITION_IDS = "embeddings.position_ids"


def _position_key(state_dict: Dict[str, Any]) -> str:
    """The position table's key in a HF BERT/RoBERTa ``state_dict``."""
    for key in state_dict:
        if key == _POSITION_KEY or key.endswith("." + _POSITION_KEY):
            return key
    raise ValueError(
        'Please extend "extend_position_embedding" to support your model '
        'type. It currently only supports HF PyTorch "bert" & "roberta" '
        f'state_dicts (a "{_POSITION_KEY}" entry).')


class SparseAttentionUtils:
    """The reference's utility surface."""

    @staticmethod
    def extend_position_embedding(params: Dict[str, torch.Tensor],
                                  max_position: int,
                                  model_type: str = "bert"
                                  ) -> Dict[str, torch.Tensor]:
        """Tile a pretrained checkpoint's position-embedding table up to
        ``max_position`` rows. RoBERTa reserves positions 0 and 1, so its
        table is ``max_position + 2`` rows and the tiling starts at row
        2. ``params`` is the model's ``state_dict``; returns a NEW one (a
        ``position_ids`` buffer, where present, is extended to match)."""
        key = _position_key(params)
        table = params[key]
        if model_type == "bert":
            orig = table.shape[0]
            if max_position <= orig:
                raise ValueError(f"new max position {max_position} must "
                                 f"exceed the original {orig}")
            reps = max(1, max_position // orig)
            new_table = table.repeat(reps, 1)
        elif model_type == "roberta":
            orig = table.shape[0] - 2
            if max_position <= orig:
                raise ValueError(f"new max position {max_position} must "
                                 f"exceed the original {orig}")
            reps = max(1, max_position // orig)
            new_table = torch.cat([table[:2], table[2:].repeat(reps, 1)])
        else:
            raise ValueError(
                'Please extend "extend_position_embedding" to support '
                f'model type "{model_type}" (bert / roberta supported)')
        out = dict(params)
        out[key] = new_table
        ids_key = key[:-len(_POSITION_KEY)] + _POSITION_IDS
        if ids_key in params:
            ids = params[ids_key]
            out[ids_key] = torch.arange(new_table.shape[0], dtype=ids.dtype,
                                        device=ids.device)[None]
        return out

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position: int):
        """Set a tokenizer's model max length (any object with
        ``model_max_length`` and ``init_kwargs``)."""
        tokenizer.model_max_length = max_position
        tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def replace_model_self_attention_with_sparse_self_attention(
            hf_config, hf_params: Dict[str, torch.Tensor],
            sparsity_config: Optional[SparsityConfig] = None,
            max_position: Optional[int] = None):
        """The functional form of the reference's module swap.

        Returns ``(encoder_fn, stacked_params, cfg)``:
        ``encoder_fn(stacked_params, hidden_states, key_padding_mask=None,
        rng=None, deterministic=True, ops=None)`` runs the HF encoder
        weights (``hf_params``, the model's ``state_dict``) through the
        port's blocks with block-sparse attention. ``hidden_states``'
        sequence length must be a multiple of the sparsity block size —
        use ``pad_to_block_size``. A ``key_padding_mask`` ([B, S], 1 =
        keep) adds ``-1e30`` at the padded keys, which routes the
        attention dense with the layout as a mask (as in JAX)."""
        from ...models.transformer import apply_blocks
        from ...module_inject.policy import detect_policy
        # Architecture dispatch through the injection-policy registry:
        # bert, roberta, or a user-registered encoder policy.
        pol = detect_policy(hf_config)
        cfg = pol.config_from_hf(hf_config)
        if sparsity_config is None:
            sparsity_config = FixedSparsityConfig(num_heads=cfg.num_heads)
        if sparsity_config.num_heads != cfg.num_heads:
            raise ValueError(
                f"sparsity_config.num_heads={sparsity_config.num_heads} "
                f"does not match the model's {cfg.num_heads}")
        if max_position is not None:
            cfg = dataclasses.replace(cfg, max_seq_length=max_position)
        stacked = pol.extract(hf_params)
        ssa = SparseSelfAttention(sparsity_config)

        def attention_fn(q, k, v, mask=None, causal=False, attn_dropout=0.0,
                         rng=None, deterministic=True):
            layout = ssa.get_layout(q.shape[1])
            return sparse_attention(q, k, v, layout, causal=causal,
                                    mask=mask, attn_dropout=attn_dropout,
                                    rng=rng, deterministic=deterministic)

        def encoder_fn(params, hidden_states, key_padding_mask=None,
                       rng=None, deterministic=True, ops=None):
            if cfg.moe is not None:
                raise NotImplementedError(
                    "MoE blocks are not supported on the sparse-"
                    "attention encoder path (dense FFN only)")
            mask = None
            if key_padding_mask is not None:
                pad = 1.0 - key_padding_mask.to(torch.float32)
                mask = pad[:, None, None, :] * -1e30
            return apply_blocks(params, hidden_states, cfg, rng=rng,
                                deterministic=deterministic,
                                attention_fn=attention_fn, ops=ops,
                                mask=mask)

        # (its layout cache: the layout a sequence length runs, for callers
        # that check the route against the dense one)
        encoder_fn.sparse_self_attention = ssa
        return encoder_fn, stacked, cfg

    @staticmethod
    def pad_to_block_size(block_size: int,
                          input_ids: Optional[torch.Tensor] = None,
                          attention_mask: Optional[torch.Tensor] = None,
                          token_type_ids: Optional[torch.Tensor] = None,
                          position_ids: Optional[torch.Tensor] = None,
                          inputs_embeds: Optional[torch.Tensor] = None,
                          pad_token_id: int = 0,
                          model_embeddings=None) -> Tuple[Any, ...]:
        """Pad the sequence dim to a multiple of the sparsity block size.
        Returns ``(pad_len, input_ids, attention_mask, token_type_ids,
        position_ids, inputs_embeds)``: the tensors given come back
        padded, the others None. ``model_embeddings`` maps padded token
        ids to embeddings to fill ``inputs_embeds``' pad (zeros
        without it)."""
        if input_ids is not None:
            seq_len = input_ids.shape[1]
        elif inputs_embeds is not None:
            seq_len = inputs_embeds.shape[1]
        else:
            raise ValueError("need input_ids or inputs_embeds")
        pad_len = (block_size - seq_len % block_size) % block_size
        if pad_len > 0:
            def pad_tokens(x, value):
                return F.pad(x, (0, pad_len), value=value)
            if inputs_embeds is not None:
                bsz = inputs_embeds.shape[0]
                pad_ids = torch.full((bsz, pad_len), pad_token_id,
                                     dtype=torch.int64,
                                     device=inputs_embeds.device)
                if model_embeddings is None:
                    pad_emb = torch.zeros(
                        (bsz, pad_len, inputs_embeds.shape[-1]),
                        dtype=inputs_embeds.dtype,
                        device=inputs_embeds.device)
                else:
                    pad_emb = model_embeddings(pad_ids)
                inputs_embeds = torch.cat([inputs_embeds, pad_emb], dim=1)
            if input_ids is not None:
                input_ids = pad_tokens(input_ids, pad_token_id)
            if position_ids is not None:
                position_ids = pad_tokens(position_ids, pad_token_id)
            if attention_mask is not None:
                attention_mask = pad_tokens(attention_mask, 0)
            if token_type_ids is not None:
                token_type_ids = pad_tokens(token_type_ids, 0)
        return (pad_len, input_ids, attention_mask, token_type_ids,
                position_ids, inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len: int,
                              sequence_output: torch.Tensor) -> torch.Tensor:
        """Drop the pad region ``pad_to_block_size`` added."""
        if pad_len > 0:
            sequence_output = sequence_output[:, :-pad_len]
        return sequence_output


__all__ = ["SparseAttentionUtils"]
