"""Block-sparse attention (port of ``deepspeed_tpu/ops/sparse_attention``).

The layout generators are plain numpy; the attention runs the LUT
kernels of ``ops/sparse_flash.py`` or the layout-gated flash kernels
(``ops/flash_attention.py``). ``SparseAttentionUtils`` is the HF
encoder swap, position-embedding extension and block padding.
"""
from .sparsity_config import (SparsityConfig, DenseSparsityConfig,
                              FixedSparsityConfig, VariableSparsityConfig,
                              BigBirdSparsityConfig, BSLongformerSparsityConfig)
from .sparse_self_attention import SparseSelfAttention, sparse_attention
from .config_factory import (normalize_sparse_attention,
                             sparsity_config_from_dict)
from .sparse_attention_utils import SparseAttentionUtils

__all__ = [
    "SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
    "VariableSparsityConfig", "BigBirdSparsityConfig",
    "BSLongformerSparsityConfig", "SparseSelfAttention", "sparse_attention",
    "normalize_sparse_attention", "sparsity_config_from_dict",
    "SparseAttentionUtils",
]
