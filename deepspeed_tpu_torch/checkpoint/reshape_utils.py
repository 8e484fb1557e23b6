"""Checkpoint reshaping utilities.

Counterpart of the reference's ``deepspeed/checkpoint/reshape_meg_2d.py`` /
``reshape_3d_utils.py``; the port's copy of
``deepspeed_tpu/checkpoint/reshape_utils.py``): re-slice tensor-parallel
checkpoint shards to a new TP degree and re-group (tp, pp, dp) file
layouts, for checkpoints that arrive as per-rank shard files
(Megatron-style). Plain numpy."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def merge_tp_slices(slices: Sequence[np.ndarray], axis: int) -> np.ndarray:
    """Concatenate one param's TP shards back to the full tensor."""
    return np.concatenate([np.asarray(s) for s in slices], axis=axis)


def split_tp_slices(full: np.ndarray, degree: int, axis: int) -> List[np.ndarray]:
    """Slice a full tensor into ``degree`` TP shards along ``axis``."""
    if full.shape[axis] % degree != 0:
        raise ValueError(
            f"dim {full.shape[axis]} not divisible by target tp degree {degree}"
        )
    return [np.ascontiguousarray(s) for s in np.split(full, degree, axis=axis)]


def reshape_tp_degree(
    shards: Sequence[np.ndarray], old_degree: int, new_degree: int, axis: int
) -> List[np.ndarray]:
    """old-degree shards → new-degree shards (reference reshape_meg_2d)."""
    assert len(shards) == old_degree
    return split_tp_slices(merge_tp_slices(shards, axis), new_degree, axis)


class ReshapeMeg2D:
    """Grid bookkeeping for (tp, pp) rank files (reference
    ``meg_2d_parallel_map``)."""

    def __init__(self, old_tp: int, old_pp: int, new_tp: int, new_pp: int):
        self.old_tp, self.old_pp = old_tp, old_pp
        self.new_tp, self.new_pp = new_tp, new_pp
        if old_pp != new_pp:
            raise NotImplementedError(
                "pp-degree reshaping requires layer re-partitioning; reshape tp first"
            )

    def old_rank(self, tp: int, pp: int) -> int:
        return pp * self.old_tp + tp

    def new_rank(self, tp: int, pp: int) -> int:
        return pp * self.new_tp + tp

    def source_ranks_for(self, new_tp_rank: int, pp: int) -> List[int]:
        """Which old tp ranks contribute to one new tp rank."""
        if self.new_tp <= self.old_tp:
            ratio = self.old_tp // self.new_tp
            return [self.old_rank(new_tp_rank * ratio + i, pp) for i in range(ratio)]
        ratio = self.new_tp // self.old_tp
        return [self.old_rank(new_tp_rank // ratio, pp)]


def partition_data(world: int, num_items: int) -> List[List[int]]:
    """Contiguous dp partition of item indices (reference reshape_3d dp_map)."""
    per = (num_items + world - 1) // world
    return [list(range(r * per, min(num_items, (r + 1) * per))) for r in range(world)]
