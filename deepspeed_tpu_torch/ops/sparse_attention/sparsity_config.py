"""Block-sparsity configurations.

A copy of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py`` (pure
Python and numpy): each config builds a per-head block-level layout
``[num_heads, num_blocks, num_blocks]`` (1 = attend) that the block-sparse
attention consumes. The port keeps its own copy so it never imports the JAX
package; the classes, defaults, errors and the ``random.Random(0)`` draws of
``Variable`` and ``BigBird`` are the same, so one config gives the same
layout element for element in both packages. The variants
(Dense/Fixed/BigBird/BSLongformer/Variable/Local) follow the published
patterns (Sparse Transformers, BigBird, Longformer).
"""

from __future__ import annotations

import random
from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base: block size + head layout sharing (reference SparsityConfig)."""

    def __init__(self, num_heads: int, block: int = 16, different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence length {seq_len} must be divisible by block size {self.block}"
            )
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks attend (a correctness baseline, reference Dense)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformers 'fixed' pattern: local blocks + strided global
    summary blocks (reference FixedSparsityConfig)."""

    def __init__(
        self,
        num_heads: int,
        block: int = 16,
        different_layout_per_head: bool = False,
        num_local_blocks: int = 4,
        num_global_blocks: int = 1,
        attention: str = "bidirectional",
        horizontal_global_attention: bool = False,
        num_different_global_patterns: int = 1,
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError("num_local_blocks must be a multiple of num_global_blocks")
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError("attention must be uni- or bidirectional")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires bidirectional")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = (
            num_different_global_patterns if different_layout_per_head else 1
        )

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        for h in range(self.num_layout_heads):
            # local windows
            for start in range(0, num_blocks, self.num_local_blocks):
                end = min(start + self.num_local_blocks, num_blocks)
                for r in range(start, end):
                    hi = (r + 1) if self.attention == "unidirectional" else end
                    layout[h, r, start:hi] = 1
            # global summary columns: last num_global_blocks of each window
            pattern = h % self.num_different_global_patterns
            first_g = self.num_local_blocks - (1 + pattern) * self.num_global_blocks
            for start in range(0, num_blocks, self.num_local_blocks):
                g0 = start + first_g
                g1 = g0 + self.num_global_blocks
                if g0 < 0:
                    continue
                if self.attention == "unidirectional":
                    # rows BELOW the window attend back to its summary blocks
                    layout[h, start + self.num_local_blocks :, g0:g1] = 1
                else:
                    layout[h, :, g0:g1] = 1
                    if self.horizontal_global_attention:
                        layout[h, g0:g1, :] = 1
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Custom local windows + explicit global rows/cols
    (reference VariableSparsityConfig)."""

    def __init__(
        self,
        num_heads: int,
        block: int = 16,
        different_layout_per_head: bool = False,
        num_random_blocks: int = 0,
        local_window_blocks: Optional[List[int]] = None,
        global_block_indices: Optional[List[int]] = None,
        global_block_end_indices: Optional[List[int]] = None,
        attention: str = "bidirectional",
        horizontal_global_attention: bool = False,
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        if global_block_end_indices is not None:
            if len(global_block_end_indices) != len(self.global_block_indices):
                raise ValueError("global block start/end lists must align")
        self.global_block_end_indices = global_block_end_indices

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        rng = random.Random(0)
        for h in range(self.num_layout_heads):
            # variable-width local windows, cycling the width list
            start = 0
            wi = 0
            while start < num_blocks:
                width = self.local_window_blocks[min(wi, len(self.local_window_blocks) - 1)]
                end = min(start + width, num_blocks)
                for r in range(start, end):
                    hi = (r + 1) if self.attention == "unidirectional" else end
                    layout[h, r, start:hi] = 1
                start = end
                wi += 1
            # globals
            for gi, g0 in enumerate(self.global_block_indices):
                if g0 >= num_blocks:
                    continue
                g1 = (
                    self.global_block_end_indices[gi]
                    if self.global_block_end_indices is not None
                    else g0 + 1
                )
                g1 = min(g1, num_blocks)
                if self.attention == "unidirectional":
                    layout[h, g0:, g0:g1] = 1
                else:
                    layout[h, :, g0:g1] = 1
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = 1
            # random blocks
            for r in range(num_blocks):
                for _ in range(self.num_random_blocks):
                    c = rng.randrange(num_blocks)
                    if self.attention == "unidirectional" and c > r:
                        c = r
                    layout[h, r, c] = 1
        if self.attention == "unidirectional":
            causal = np.tril(np.ones((num_blocks, num_blocks), dtype=np.int64))
            layout = layout * causal[None]
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: random + sliding window + global (reference BigBird...)."""

    def __init__(
        self,
        num_heads: int,
        block: int = 16,
        different_layout_per_head: bool = False,
        num_random_blocks: int = 1,
        num_sliding_window_blocks: int = 3,
        num_global_blocks: int = 1,
        attention: str = "bidirectional",
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        rng = random.Random(0)
        for h in range(self.num_layout_heads):
            for r in range(num_blocks):
                lo, hi = max(0, r - w), min(num_blocks, r + w + 1)
                layout[h, r, lo:hi] = 1
                for _ in range(self.num_random_blocks):
                    layout[h, r, rng.randrange(num_blocks)] = 1
            g = self.num_global_blocks
            layout[h, :g, :] = 1
            layout[h, :, :g] = 1
        if self.attention == "unidirectional":
            causal = np.tril(np.ones((num_blocks, num_blocks), dtype=np.int64))
            layout = layout * causal[None]
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + selected global indices
    (reference BSLongformerSparsityConfig)."""

    def __init__(
        self,
        num_heads: int,
        block: int = 16,
        different_layout_per_head: bool = False,
        num_sliding_window_blocks: int = 3,
        global_block_indices: Optional[List[int]] = None,
        global_block_end_indices: Optional[List[int]] = None,
        attention: str = "bidirectional",
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for r in range(num_blocks):
                layout[h, r, max(0, r - w) : min(num_blocks, r + w + 1)] = 1
            for gi, g0 in enumerate(self.global_block_indices):
                if g0 >= num_blocks:
                    continue
                g1 = (
                    self.global_block_end_indices[gi]
                    if self.global_block_end_indices is not None
                    else g0 + 1
                )
                g1 = min(g1, num_blocks)
                layout[h, :, g0:g1] = 1
                layout[h, g0:g1, :] = 1
        if self.attention == "unidirectional":
            causal = np.tril(np.ones((num_blocks, num_blocks), dtype=np.int64))
            layout = layout * causal[None]
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding window (reference LocalSlidingWindowSparsityConfig)."""

    def __init__(
        self,
        num_heads: int,
        block: int = 16,
        num_sliding_window_blocks: int = 3,
        attention: str = "unidirectional",
    ):
        super().__init__(num_heads, block, different_layout_per_head=False)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for r in range(num_blocks):
            lo = max(0, r - w)
            hi = (r + 1) if self.attention == "unidirectional" else min(num_blocks, r + w + 1)
            layout[0, r, lo:hi] = 1
        return self.check_and_propagate_first_head_layout(layout)
