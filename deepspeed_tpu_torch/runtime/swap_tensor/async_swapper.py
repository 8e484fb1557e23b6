"""Async tensor swap-out pipeline.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/async_swapper.py``
(the reference's ``AsyncTensorSwapper``
``swap_tensor/async_swapper.py:18``): tensors are packed into a staging
buffer; when it fills, the buffer is flushed to disk asynchronously while a
fresh buffer keeps accepting tensors — overlapping disk writes with the
caller's compute.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deepspeed_tpu_torch.runtime.swap_tensor.utils import SwapBuffer, swap_out_tensors
from deepspeed_tpu_torch.utils.logging import logger

INVALID_BUFFER_INDEX = -1
ASYNC_SWAPPER_WAIT_TIMER = "async_swap_gradient_wait"


class AsyncTensorSwapper:
    def __init__(self, aio_handle, numel_alignment: int, timers=None):
        self.free_buffer_index: List[int] = []
        self.swapping_buffer_index = INVALID_BUFFER_INDEX
        self.ready_buffer_index = INVALID_BUFFER_INDEX
        self.current_buffer_index = INVALID_BUFFER_INDEX
        self.all_buffers: List[SwapBuffer] = []
        self.aio_handle = aio_handle
        self.numel_alignment = numel_alignment
        self.max_numel = 0
        self.num_pending_swaps = 0
        self.timers = timers
        self.swapped_tensors = 0
        self.swapped_bytes = 0

    def has_buffers(self) -> bool:
        return len(self.all_buffers) > 0

    def add_buffers(self, buffer_list: List[np.ndarray]) -> None:
        assert not self.all_buffers
        assert all(b.dtype == buffer_list[0].dtype for b in buffer_list)
        self.all_buffers = [SwapBuffer(b) for b in buffer_list]
        self.free_buffer_index = list(range(len(self.all_buffers)))
        self.max_numel = max(b.size for b in buffer_list)

    def get_timer_names(self) -> List[str]:
        return [ASYNC_SWAPPER_WAIT_TIMER]

    def release_buffers(self) -> List[np.ndarray]:
        self._report_statistics("Swapped out[Before flush]")
        self._flush_buffers_until_complete()
        self._report_statistics("Swapped out[After flush]")
        buffers = [b.buffer for b in self.all_buffers]
        self.all_buffers = []
        self.free_buffer_index = []
        self.swapped_tensors = 0
        self.swapped_bytes = 0
        return buffers

    def swap_out_tensors(self, tensor_list: List[np.ndarray], path_list: List[str]) -> None:
        for tensor, path in zip(tensor_list, path_list):
            self._swap_out_tensor(tensor, path)

    def _report_statistics(self, message: str) -> None:
        logger.debug(
            f"{message}: {self.swapped_tensors} tensors, "
            f"{self.swapped_bytes / 1024**3:.2f} GB"
        )

    def _swap_out_tensor(self, tensor: np.ndarray, swap_path: str) -> None:
        assert self.all_buffers, "add_buffers must be called first"
        aligned_numel = self._io_aligned_numel(tensor.size)
        assert aligned_numel <= self.max_numel, (
            f"tensor of {aligned_numel} elements exceeds buffer size {self.max_numel}"
        )
        self._make_swap_space(aligned_numel)
        swap_buffer = self.all_buffers[self.current_buffer_index]
        swap_buffer.insert_tensor(tensor.ravel(), swap_path, aligned_numel)
        self.swapped_tensors += 1
        self.swapped_bytes += tensor.nbytes

    def _make_swap_space(self, numel: int) -> None:
        if self.current_buffer_index == INVALID_BUFFER_INDEX:
            self._allocate_buffer()
            return
        if not self.all_buffers[self.current_buffer_index].has_space(numel):
            if self.free_buffer_index:
                self._flush_ready_buffers()
            else:
                self._flush_buffers_until_complete()
            self._allocate_buffer()

    def _io_aligned_numel(self, numel: int) -> int:
        remainder = numel % self.numel_alignment
        return numel if remainder == 0 else numel + self.numel_alignment - remainder

    def _allocate_buffer(self) -> None:
        assert self.free_buffer_index
        if self.current_buffer_index != INVALID_BUFFER_INDEX:
            # previous buffer becomes ready-to-flush
            self.ready_buffer_index = self.current_buffer_index
        self.current_buffer_index = self.free_buffer_index.pop()

    def _flush_ready_buffers(self) -> None:
        if self.current_buffer_index != INVALID_BUFFER_INDEX:
            self.ready_buffer_index = self.current_buffer_index
            self.current_buffer_index = INVALID_BUFFER_INDEX
        self._swap_out_ready_buffers()

    def _flush_buffers_until_complete(self) -> None:
        self._flush_ready_buffers()
        self._wait_for_swap_complete()

    def _swap_out_ready_buffers(self) -> None:
        if self.ready_buffer_index == INVALID_BUFFER_INDEX:
            return
        buffer = self.all_buffers[self.ready_buffer_index]
        swap_out_tensors(self.aio_handle, buffer.get_swap_tensors(), buffer.get_swap_paths())
        self.num_pending_swaps += len(buffer.get_swap_tensors())
        self.swapping_buffer_index = self.ready_buffer_index
        self.ready_buffer_index = INVALID_BUFFER_INDEX

    def _wait_for_swap_complete(self) -> None:
        if self.swapping_buffer_index == INVALID_BUFFER_INDEX:
            return
        if self.timers is not None:
            self.timers(ASYNC_SWAPPER_WAIT_TIMER).start()
        self.aio_handle.wait()
        if self.timers is not None:
            self.timers(ASYNC_SWAPPER_WAIT_TIMER).stop()
        self.num_pending_swaps = 0
        buffer = self.all_buffers[self.swapping_buffer_index]
        buffer.reset()
        self.free_buffer_index.append(self.swapping_buffer_index)
        self.swapping_buffer_index = INVALID_BUFFER_INDEX
