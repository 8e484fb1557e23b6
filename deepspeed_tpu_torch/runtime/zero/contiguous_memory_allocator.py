"""Contiguous memory allocator (reference:
``deepspeed/runtime/zero/contiguous_memory_allocator.py``).

Counterpart of ``deepspeed_tpu/runtime/zero/contiguous_memory_allocator.py``:
one flat torch tensor (on the CPU unless ``device`` names another) with
best-fit allocate, release and defragment. Tensors are views of the flat
buffer, moved (with their registered ids) by defragmentation. Nothing in the
engines calls it; it is the reference's surface, offsets for offsets JAX's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class ContiguousMemoryAllocator:
    def __init__(self, size: int, dtype=np.float32, device: str = "cpu"):
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype
        self.buffer = torch.zeros(size, dtype=dtype, device=device)
        self.total_size = size
        # contiguous free regions: start -> size
        self.contiguous_sizes: Dict[int, int] = {0: size}
        # allocated regions: start -> size
        self.tensor_sizes: Dict[int, int] = {}
        self.tensor_addresses: Dict[int, int] = {}  # id -> start
        self.tensor_map: Dict[int, torch.Tensor] = {}  # id -> view
        self.count = 0
        self.available_memory = size

    # --- allocation ------------------------------------------------------
    def allocate_tensor(self, size: int) -> torch.Tensor:
        """A flat view of ``size`` elements; defragments when no contiguous
        region fits but total free memory does (reference :51)."""
        if size > self.available_memory:
            raise RuntimeError(
                f"out of memory: need {size}, available {self.available_memory}"
            )
        start = self._best_fit(size)
        if start is None:
            self.defragment()
            start = self._best_fit(size)
            assert start is not None, "defragmentation failed to produce a fit"
        self._carve(start, size)
        self.count += 1
        tid = self.count
        view = self.buffer[start : start + size]
        self.tensor_addresses[tid] = start
        self.tensor_sizes[start] = size
        self.tensor_map[tid] = view
        self.available_memory -= size
        return view

    def tensor_id(self, view: torch.Tensor) -> int:
        for tid, v in self.tensor_map.items():
            if v is view or (v.shape == view.shape and v.data_ptr() == view.data_ptr()):
                return tid
        raise KeyError("tensor not from this allocator")

    def release_tensor(self, view: torch.Tensor) -> None:
        tid = self.tensor_id(view)
        self.release_tensor_with_id(tid)

    def release_tensor_with_id(self, tid: int) -> None:
        start = self.tensor_addresses.pop(tid)
        size = self.tensor_sizes.pop(start)
        self.tensor_map.pop(tid)
        self.available_memory += size
        self._free(start, size)

    # --- defragmentation -------------------------------------------------
    def defragment(self) -> None:
        """Compact all live tensors to the front (reference defragmentation);
        registered views are re-pointed at their new locations."""
        live = sorted(
            ((start, tid) for tid, start in self.tensor_addresses.items())
        )
        cursor = 0
        new_addresses: Dict[int, int] = {}
        new_sizes: Dict[int, int] = {}
        for start, tid in live:
            size = self.tensor_sizes[start]
            if start != cursor:  # the regions may overlap: copy through a clone
                self.buffer[cursor : cursor + size].copy_(self.buffer[start : start + size].clone())
            new_addresses[tid] = cursor
            new_sizes[cursor] = size
            self.tensor_map[tid] = self.buffer[cursor : cursor + size]
            cursor += size
        self.tensor_addresses = new_addresses
        self.tensor_sizes = new_sizes
        self.contiguous_sizes = (
            {cursor: self.total_size - cursor} if cursor < self.total_size else {}
        )

    def get_tensor(self, tid: int) -> torch.Tensor:
        """Current view for an id (views move on defragment)."""
        return self.tensor_map[tid]

    # --- internals -------------------------------------------------------
    def _best_fit(self, size: int):
        best = None
        for start, free in self.contiguous_sizes.items():
            if free >= size and (best is None or free < self.contiguous_sizes[best]):
                best = start
        return best

    def _carve(self, start: int, size: int) -> None:
        free = self.contiguous_sizes.pop(start)
        if free > size:
            self.contiguous_sizes[start + size] = free - size

    def _free(self, start: int, size: int) -> None:
        self.contiguous_sizes[start] = size
        # merge adjacent free regions
        merged = True
        while merged:
            merged = False
            for s in sorted(self.contiguous_sizes):
                end = s + self.contiguous_sizes[s]
                if end in self.contiguous_sizes:
                    self.contiguous_sizes[s] += self.contiguous_sizes.pop(end)
                    merged = True
                    break
