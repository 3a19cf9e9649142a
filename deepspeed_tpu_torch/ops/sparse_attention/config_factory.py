"""ds_config ``sparse_attention`` section → SparsityConfig objects (port
of ``deepspeed_tpu/ops/sparse_attention/config_factory.py``).

The mode string selects the config class and the section's keys become
its constructor arguments, with the reference's defaults filled in;
unknown modes raise ``NotImplementedError`` and unknown keys
``ValueError``, as in the JAX package. The normalized dict is what
``DeepSpeedConfig.sparse_attention`` stores; ``sparsity_config_from_dict``
turns it into the layout-generating object.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ... import constants as C
from .sparsity_config import (BigBirdSparsityConfig, BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              SparsityConfig, VariableSparsityConfig)

# mode → (config class, [(json key, default)] beyond block/layout-per-head)
_MODE_KEYS = {
    C.SPARSE_DENSE_MODE: (DenseSparsityConfig, []),
    C.SPARSE_FIXED_MODE: (FixedSparsityConfig, [
        (C.SPARSE_NUM_LOCAL_BLOCKS, C.SPARSE_NUM_LOCAL_BLOCKS_DEFAULT),
        (C.SPARSE_NUM_GLOBAL_BLOCKS, C.SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT),
        (C.SPARSE_ATTENTION_TYPE, C.SPARSE_ATTENTION_TYPE_DEFAULT),
        (C.SPARSE_HORIZONTAL_GLOBAL_ATTENTION,
         C.SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT),
        (C.SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS,
         C.SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT),
    ]),
    C.SPARSE_VARIABLE_MODE: (VariableSparsityConfig, [
        (C.SPARSE_NUM_RANDOM_BLOCKS, C.SPARSE_NUM_RANDOM_BLOCKS_DEFAULT),
        (C.SPARSE_LOCAL_WINDOW_BLOCKS, C.SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT),
        (C.SPARSE_GLOBAL_BLOCK_INDICES, C.SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT),
        (C.SPARSE_GLOBAL_BLOCK_END_INDICES,
         C.SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT),
        (C.SPARSE_ATTENTION_TYPE, C.SPARSE_ATTENTION_TYPE_DEFAULT),
        (C.SPARSE_HORIZONTAL_GLOBAL_ATTENTION,
         C.SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT),
    ]),
    C.SPARSE_BIGBIRD_MODE: (BigBirdSparsityConfig, [
        (C.SPARSE_NUM_RANDOM_BLOCKS, C.SPARSE_NUM_RANDOM_BLOCKS_DEFAULT),
        (C.SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
         C.SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT),
        (C.SPARSE_NUM_GLOBAL_BLOCKS, C.SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT),
    ]),
    C.SPARSE_BSLONGFORMER_MODE: (BSLongformerSparsityConfig, [
        (C.SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
         C.SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT),
        (C.SPARSE_GLOBAL_BLOCK_INDICES, C.SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT),
        (C.SPARSE_GLOBAL_BLOCK_END_INDICES,
         C.SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT),
    ]),
}


def normalize_sparse_attention(section: Optional[Dict[str, Any]]
                               ) -> Optional[Dict[str, Any]]:
    """Fill mode-specific defaults, reject unknown modes — the dict shape
    ``get_sparse_attention`` (reference config.py:192-212) returns."""
    if section is None:
        return None
    mode = section.get(C.SPARSE_MODE, C.SPARSE_MODE_DEFAULT)
    if mode not in _MODE_KEYS:
        raise NotImplementedError(
            f"Given sparsity mode, {mode}, has not been implemented yet!")
    _, keys = _MODE_KEYS[mode]
    out = {C.SPARSE_MODE: mode,
           C.SPARSE_BLOCK: section.get(C.SPARSE_BLOCK, C.SPARSE_BLOCK_DEFAULT)}
    if mode != C.SPARSE_DENSE_MODE:
        out[C.SPARSE_DIFFERENT_LAYOUT_PER_HEAD] = section.get(
            C.SPARSE_DIFFERENT_LAYOUT_PER_HEAD,
            C.SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT)
    for key, default in keys:
        out[key] = section.get(key, default)
    unknown = set(section) - set(out) - {C.SPARSE_MODE}
    if unknown:
        raise ValueError(f"sparse_attention mode '{mode}' does not accept "
                         f"key(s) {sorted(unknown)}")
    return out


def sparsity_config_from_dict(section: Dict[str, Any],
                              num_heads: int) -> SparsityConfig:
    """Normalized section dict → layout-generating SparsityConfig."""
    section = normalize_sparse_attention(section)
    mode = section[C.SPARSE_MODE]
    cls, keys = _MODE_KEYS[mode]
    kwargs = {k: section[k] for k, _ in keys}
    if mode != C.SPARSE_DENSE_MODE:
        kwargs[C.SPARSE_DIFFERENT_LAYOUT_PER_HEAD] = \
            section[C.SPARSE_DIFFERENT_LAYOUT_PER_HEAD]
    return cls(num_heads=num_heads, block=section[C.SPARSE_BLOCK], **kwargs)
