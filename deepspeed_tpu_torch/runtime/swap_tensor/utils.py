"""Swap buffer management.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/utils.py`` (the
reference's ``swap_tensor/utils.py``: SwapBuffer :37, SwapBufferPool :96,
SwapBufferManager :120): host staging buffers that tensors are packed into
before disk writes and unpacked from after reads. ``SwapBufferManager``
allocates each buffer once as a torch CPU tensor, pinned where a card is
present and ``pin_memory`` asks for it (the reference's pinned host
tensors), and hands out numpy views of it (the aio library's operands).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger

MIN_AIO_BYTES = 1024**2
AIO_ALIGNED_BYTES = 1024


def swap_in_tensors(swap_handle, buffers: List[np.ndarray], swap_paths: List[str]) -> None:
    """Submit async reads of each path into each buffer (reference utils.py:18)."""
    for buffer, path in zip(buffers, swap_paths):
        swap_handle.async_pread(buffer, path)


def swap_out_tensors(swap_handle, buffers: List[np.ndarray], swap_paths: List[str]) -> None:
    for buffer, path in zip(buffers, swap_paths):
        swap_handle.async_pwrite(buffer, path)


class SwapBuffer:
    """One staging buffer holding multiple packed tensors (reference :37)."""

    def __init__(self, buffer: np.ndarray):
        self.buffer = buffer
        self.reset()

    def reset(self) -> None:
        self.offset = 0
        self.swap_tensors: Dict[int, np.ndarray] = {}
        self.compute_tensors: Dict[int, np.ndarray] = {}
        self.swap_paths: Dict[int, str] = {}
        self.num_elem = 0

    def insert_tensor(self, tensor: np.ndarray, swap_path: str, aligned_numel: int):
        swap_tensor, compute_tensor = self.allocate_tensor(swap_path, tensor.size, aligned_numel)
        compute_tensor[:] = tensor.ravel()
        return swap_tensor, compute_tensor

    def allocate_tensor(self, swap_path: str, numel: int, aligned_numel: int):
        assert self.has_space(aligned_numel)
        assert aligned_numel >= numel
        allocate_offset = self.offset
        swap_tensor = self.buffer[allocate_offset : allocate_offset + aligned_numel]
        compute_tensor = swap_tensor[:numel]
        self.swap_tensors[allocate_offset] = swap_tensor
        self.compute_tensors[allocate_offset] = compute_tensor
        self.swap_paths[allocate_offset] = swap_path
        self.offset += aligned_numel
        self.num_elem += numel
        return swap_tensor, compute_tensor

    def has_space(self, numel: int) -> bool:
        return self.offset + numel <= self.buffer.size

    def get_swap_tensors(self) -> List[np.ndarray]:
        return list(self.swap_tensors.values())

    def get_swap_paths(self) -> List[str]:
        return list(self.swap_paths.values())

    def get_compute_tensors(self) -> List[np.ndarray]:
        return list(self.compute_tensors.values())

    def get_num_elem(self) -> int:
        return self.num_elem


class SwapBufferPool:
    """A group of SwapBuffers written/read as one unit (reference :96)."""

    def __init__(self, buffers: List[np.ndarray]):
        self.buffers = [SwapBuffer(b) for b in buffers]
        self.current_index = 0

    def reset(self) -> None:
        self.current_index = 0
        for buffer in self.buffers:
            buffer.reset()

    def allocate_tensor(self, numel: int, swap_path: str, aligned_numel: int):
        if self.has_space(aligned_numel):
            return self._get_current_buffer().allocate_tensor(swap_path, numel, aligned_numel)
        return None, None

    def insert_tensor(self, tensor: np.ndarray, swap_path: str, aligned_numel: int):
        if self.has_space(aligned_numel):
            return self._get_current_buffer().insert_tensor(tensor, swap_path, aligned_numel)
        return None, None

    def get_swap_tensors(self) -> List[np.ndarray]:
        return [t for b in self._get_used_buffers() for t in b.get_swap_tensors()]

    def get_swap_paths(self) -> List[str]:
        return [p for b in self._get_used_buffers() for p in b.get_swap_paths()]

    def get_compute_tensors(self) -> List[np.ndarray]:
        return [t for b in self._get_used_buffers() for t in b.get_compute_tensors()]

    def has_space(self, numel: int) -> bool:
        if self._get_current_buffer().has_space(numel):
            return True
        if self.current_index == len(self.buffers) - 1:
            return False
        self.current_index += 1
        return self._get_current_buffer().has_space(numel)

    def swap_out(self, aio_handle) -> None:
        swap_out_tensors(aio_handle, self.get_swap_tensors(), self.get_swap_paths())
        assert aio_handle.wait() >= 0

    def swap_in(self, aio_handle) -> None:
        swap_in_tensors(aio_handle, self.get_swap_tensors(), self.get_swap_paths())
        assert aio_handle.wait() >= 0

    def _get_current_buffer(self) -> SwapBuffer:
        return self.buffers[self.current_index]

    def _get_used_buffers(self) -> List[SwapBuffer]:
        return self.buffers[: self.current_index + 1]


class SwapBufferManager:
    """Fixed pool of equal-size buffers with alloc/free (reference :120)."""

    def __init__(self, num_elems: int, count: int, dtype=np.float32, pin_memory: bool = False):
        self.num_elems = num_elems
        self.count = count
        self.dtype = np.dtype(dtype)
        self.all_buffers = [host_buffer(num_elems, self.dtype, pin_memory) for _ in range(count)]
        self.free_buffer_index = list(range(count))
        self.used_buffer_index: Dict[int, int] = {}
        self.gigabytes = (count * num_elems * self.dtype.itemsize) / 1024**3

    def allocate(self, num_elems: int, count: int, dtype=np.float32) -> Optional[List[np.ndarray]]:
        assert np.dtype(dtype) == self.dtype
        assert num_elems <= self.num_elems
        if count > len(self.free_buffer_index):
            return None
        buffers = []
        for _ in range(count):
            i = self.free_buffer_index.pop()
            buf = self.all_buffers[i][:num_elems]
            self.used_buffer_index[id(buf)] = i
            buffers.append(buf)
        return buffers

    def allocate_all(self, num_elems: int, dtype=np.float32) -> Optional[List[np.ndarray]]:
        return self.allocate(num_elems, len(self.free_buffer_index), dtype)

    def free(self, buffers: List[np.ndarray]) -> None:
        for buf in buffers:
            i = self.used_buffer_index.pop(id(buf), None)
            if i is None:
                logger.warning("SwapBufferManager.free: unknown buffer")
                continue
            self.free_buffer_index.append(i)


def host_buffer(num_elems: int, dtype, pin_memory: bool = False) -> np.ndarray:
    """A zeroed host buffer as the numpy view of a torch CPU tensor, pinned
    when ``pin_memory`` asks and a card is present (pinning needs one)."""
    t = torch.from_numpy(np.zeros(0, np.dtype(dtype)))
    pin = bool(pin_memory) and torch.cuda.is_available()
    return torch.zeros(num_elems, dtype=t.dtype, pin_memory=pin).numpy()


def get_sized_buffer(buffer: np.ndarray, num_elems: int) -> np.ndarray:
    assert num_elems <= buffer.size
    return buffer[:num_elems]


def get_sized_buffers(buffers: List[np.ndarray], num_elems_list: List[int]) -> List[np.ndarray]:
    return [get_sized_buffer(b, n) for b, n in zip(buffers, num_elems_list)]
