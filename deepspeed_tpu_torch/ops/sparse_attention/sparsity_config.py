"""Sparsity layout generators (port of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``, kept as a copy
so that the port imports nothing of the JAX package).

Each config emits a per-head block-level layout
``[num_heads, num_blocks, num_blocks]`` where ``layout[h, i, j] == 1``
means query block i attends to key block j for head h: Dense, Fixed
(Sparse Transformer), Variable, BigBird and BSLongformer. Layouts are
plain numpy; the random blocks come from Python's ``random`` module in
the same calls and order as the JAX package's, so ``random.seed(s)``
gives both packages the same layout. The block-sparse kernels need a
block that is a multiple of 128 (``ops/flash_attention.py`` routes other
blocks to dense attention with the layout as a mask).
"""
from __future__ import annotations

import random
from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base: layout allocation + helpers (reference sparsity_config.py:9)."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"sequence length {seq_len} must be divisible by block "
                f"{self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), np.int64)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All-ones layout; lets dense run through the sparse path
    (reference sparsity_config.py:57)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformer-style fixed pattern (reference
    sparsity_config.py:163): local windows of ``num_local_blocks`` blocks +
    global attention to the last ``num_global_blocks`` block(s) of each
    window. ``num_different_global_patterns`` rotates which sub-block of the
    window is global across head groups (requires different_layout_per_head).
    """

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError("num_local_blocks must be divisible by "
                             "num_global_blocks")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"attention mode {attention}")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("num_different_global_patterns > 1 needs "
                             "different_layout_per_head=True")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError("too many global patterns for the window size")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def _set_local(self, layout: np.ndarray, h: int) -> None:
        nB = layout.shape[1]
        for start in range(0, nB, self.num_local_blocks):
            end = min(start + self.num_local_blocks, nB)
            for i in range(start, end):
                hi = (i + 1) if self.attention == "unidirectional" else end
                layout[h, i, start:hi] = 1

    def _global_cols(self, h: int, nB: int) -> List[int]:
        # Head group selects which stripe of each window is global.
        pattern = (h // max(1, self.num_heads //
                            self.num_different_global_patterns)) \
            % self.num_different_global_patterns
        first = self.num_local_blocks - (1 + pattern) * self.num_global_blocks
        cols = []
        for w in range(first, nB, self.num_local_blocks):
            cols.extend(range(w, min(w + self.num_global_blocks, nB)))
        return cols

    def _set_global(self, layout: np.ndarray, h: int) -> None:
        nB = layout.shape[1]
        for c in self._global_cols(h, nB):
            if self.attention == "unidirectional":
                layout[h, c:, c] = 1          # later queries see the global col
            else:
                layout[h, :, c] = 1
            if self.horizontal_global_attention:
                layout[h, c, :] = 1
        return None

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        heads = range(self.num_heads) if self.different_layout_per_head else [0]
        for h in heads:
            self._set_local(layout, h)
            self._set_global(layout, h)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable local windows + explicit global block indices + random
    blocks (reference sparsity_config.py:333). ``local_window_blocks`` lists
    consecutive window sizes; the last size repeats to cover the sequence.
    ``global_block_indices``/``global_block_end_indices`` give single blocks
    or [start, end) ranges of global columns.
    """

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"attention mode {attention}")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")
        # Random blocks without different_layout_per_head are valid: the
        # layout is sampled once for head 0 and propagated to all heads
        # (reference sparsity_config.py num_layout_heads=1 behavior).
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None:
            if len(global_block_end_indices) != len(self.global_block_indices):
                raise ValueError("global start/end index lists must align")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def _set_local(self, layout: np.ndarray, h: int) -> None:
        nB = layout.shape[1]
        start = 0
        sizes = list(self.local_window_blocks)
        while start < nB:
            size = sizes.pop(0) if sizes else self.local_window_blocks[-1]
            end = min(start + size, nB)
            for i in range(start, end):
                hi = (i + 1) if self.attention == "unidirectional" else end
                layout[h, i, start:hi] = 1
            start = end

    def _set_global(self, layout: np.ndarray, h: int) -> None:
        nB = layout.shape[1]
        if self.global_block_end_indices is None:
            ranges = [(i, i + 1) for i in self.global_block_indices]
        else:
            ranges = list(zip(self.global_block_indices,
                              self.global_block_end_indices))
        for lo, hi in ranges:
            for c in range(lo, min(hi, nB)):
                if self.attention == "unidirectional":
                    layout[h, c:, c] = 1
                else:
                    layout[h, :, c] = 1
                if self.horizontal_global_attention:
                    layout[h, c, :] = 1

    def _set_random(self, layout: np.ndarray, h: int) -> None:
        nB = layout.shape[1]
        for i in range(nB):
            for c in random.sample(range(nB), min(self.num_random_blocks, nB)):
                if self.attention == "unidirectional" and c > i:
                    c = i - (c - i) if i - (c - i) >= 0 else i
                layout[h, i, c] = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        heads = range(self.num_heads) if self.different_layout_per_head else [0]
        for h in heads:
            self._set_local(layout, h)
            self._set_global(layout, h)
            if self.num_random_blocks:
                self._set_random(layout, h)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: random + sliding window + global-first blocks
    (reference sparsity_config.py:467)."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"attention mode {attention}")
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nB = layout.shape[1]
        if nB < max(self.num_sliding_window_blocks, self.num_global_blocks,
                    self.num_random_blocks):
            raise ValueError(f"sequence of {nB} blocks too short for the "
                             "BigBird pattern")
        heads = range(self.num_heads) if self.different_layout_per_head else [0]
        w = self.num_sliding_window_blocks // 2
        uni = self.attention == "unidirectional"
        for h in heads:
            # sliding window
            for i in range(nB):
                lo, hi = max(0, i - w), (i + 1 if uni else min(nB, i + w + 1))
                layout[h, i, lo:hi] = 1
            # global: first blocks as rows+cols (col only below diag if uni)
            g = self.num_global_blocks
            layout[h, :, :g] = 1
            if not uni:
                layout[h, :g, :] = 1
            # random
            for i in range(nB):
                pool = range(0, i + 1) if uni else range(nB)
                for c in random.sample(list(pool),
                                       min(self.num_random_blocks, len(list(pool)))):
                    layout[h, i, c] = 1
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + global indices as rows+cols
    (reference sparsity_config.py:583)."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None and \
                len(global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global start/end index lists must align")
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nB = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        uni = self.attention == "unidirectional"
        heads = range(self.num_heads) if self.different_layout_per_head else [0]
        if self.global_block_end_indices is None:
            ranges = [(i, i + 1) for i in self.global_block_indices]
        else:
            ranges = list(zip(self.global_block_indices,
                              self.global_block_end_indices))
        for h in heads:
            for i in range(nB):
                lo, hi = max(0, i - w), (i + 1 if uni else min(nB, i + w + 1))
                layout[h, i, lo:hi] = 1
            for lo, hi in ranges:
                for c in range(lo, min(hi, nB)):
                    if uni:
                        layout[h, c:, c] = 1
                    else:
                        layout[h, :, c] = 1
                        layout[h, c, :] = 1
        return self.check_and_propagate_first_head_layout(layout)
