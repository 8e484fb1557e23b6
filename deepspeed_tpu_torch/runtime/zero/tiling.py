"""Tiled linear (JAX ``deepspeed_tpu/runtime/zero/tiling.py``, reference
``deepspeed/runtime/zero/tiling.py``).

An (in_splits × out_splits) tile grid of one ``[in, out]`` weight: each
out-tile sums its in-tiles' partial products in fp32, the outputs are
concatenated unless ``combine_out_splits=False``. The tiles are the tree's
leaves, so ZeRO-3 shards and gathers them tile by tile.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def split_tensor_along_last_dim(tensor: torch.Tensor, partitions: int, contiguous_split_chunks: bool = False):
    """The last dim split into ``partitions`` equal chunks."""
    chunks = torch.chunk(tensor, partitions, dim=-1)
    return tuple(c.contiguous() for c in chunks) if contiguous_split_chunks else chunks


def partition_uniform(num_items: int, num_parts: int) -> List[int]:
    """Boundaries of a near-uniform split: the first ``num_items %
    num_parts`` parts take one item more."""
    base, extra = divmod(num_items, num_parts)
    bounds = [0]
    for p in range(num_parts):
        bounds.append(bounds[-1] + base + (1 if p < extra else 0))
    return bounds


class TiledLinear:
    """``y = x @ W + b`` computed as an (out_splits × in_splits) tile grid
    (``W`` is ``[in, out]``, as the JAX tree holds weights)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, in_splits: int = 1,
                 out_splits: int = 1, input_is_already_split: bool = False, combine_out_splits: bool = True):
        if in_splits < 1 or out_splits < 1:
            raise ValueError("in_splits and out_splits must be >= 1")
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = bias
        self.in_splits = in_splits
        self.out_splits = out_splits
        self.input_is_already_split = input_is_already_split
        self.combine_out_splits = combine_out_splits
        self.in_bounds = partition_uniform(in_features, in_splits)
        self.out_bounds = partition_uniform(out_features, out_splits)

    def init(self, seed: int = 0, std: float = 0.02) -> Dict[str, Any]:
        """Tiles drawn from ``numpy.random.default_rng(seed)``, normal with
        ``std``; a zero bias."""
        rng = np.random.default_rng(seed)
        return self.from_full((rng.standard_normal((self.in_features, self.out_features)) * std).astype(np.float32))

    def from_full(self, weight, bias=None) -> Dict[str, Any]:
        """Tile a full ``[in, out]`` weight."""
        weight = torch.as_tensor(np.asarray(weight))
        if tuple(weight.shape) != (self.in_features, self.out_features):
            raise ValueError(f"expected [in, out] = {(self.in_features, self.out_features)}, got "
                             f"{tuple(weight.shape)}")
        tiles = {}
        for o in range(self.out_splits):
            for i in range(self.in_splits):
                o0, o1 = self.out_bounds[o], self.out_bounds[o + 1]
                i0, i1 = self.in_bounds[i], self.in_bounds[i + 1]
                tiles[f"tile_{o}_{i}"] = weight[i0:i1, o0:o1].contiguous()
        params: Dict[str, Any] = {"tiles": tiles}
        if self.use_bias:
            params["bias"] = (torch.as_tensor(np.asarray(bias)) if bias is not None
                              else torch.zeros(self.out_features, dtype=torch.float32))
        return params

    def apply(self, params: Dict[str, Any], x):
        if self.input_is_already_split:
            chunks = list(x)
        elif self.in_splits > 1:
            chunks = [x[..., self.in_bounds[i]:self.in_bounds[i + 1]] for i in range(self.in_splits)]
        else:
            chunks = [x]
        out_dtype = chunks[0].dtype
        outs = []
        for o in range(self.out_splits):
            acc = None
            for i in range(self.in_splits):
                # products of the inputs' dtype accumulated in fp32 (JAX's preferred_element_type)
                part = chunks[i].float() @ params["tiles"][f"tile_{o}_{i}"].to(chunks[i].dtype).float()
                acc = part if acc is None else acc + part
            if self.use_bias:
                acc = acc + params["bias"][self.out_bounds[o]:self.out_bounds[o + 1]].float()
            outs.append(acc.to(out_dtype))
        if self.combine_out_splits:
            return torch.cat(outs, dim=-1)
        return outs


class TiledLinearReturnBias(TiledLinear):
    """Megatron-style variant: returns ``(output, bias)`` without adding it."""

    def apply(self, params, x):
        use_bias, self.use_bias = self.use_bias, False
        try:
            out = super().apply(params, x)
        finally:
            self.use_bias = use_bias
        return out, params.get("bias")
