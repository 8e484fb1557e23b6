"""Partitioned optimizer swapper with prefetch pipelining.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/partitioned_optimizer_swapper.py``:
the reference's ``PartitionedOptimizerSwapper``
(``swap_tensor/partitioned_optimizer_swapper.py:28``) and the
double-buffered ``PipelinedOptimizerSwapper``
(``pipelined_optimizer_swapper.py:51``) collapsed into one class: while the
host optimizer updates parameter group *i*, group *i+1*'s state reads are
already in flight on a second aio handle, and group *i-1*'s writes drain on
a third — the swap latency hides behind the AVX Adam update.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_utils import OptimizerSwapper
from deepspeed_tpu_torch.utils.logging import logger


class PartitionedOptimizerSwapper(OptimizerSwapper):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        aio = self.aio_config
        # dedicated handles so reads/writes/prefetch overlap independently
        self._read_handle = AsyncIOHandle(
            block_size=aio.block_size,
            queue_depth=aio.queue_depth,
            single_submit=aio.single_submit,
            overlap_events=aio.overlap_events,
            thread_count=aio.thread_count,
        )
        self._write_handle = AsyncIOHandle(
            block_size=aio.block_size,
            queue_depth=aio.queue_depth,
            single_submit=aio.single_submit,
            overlap_events=aio.overlap_events,
            thread_count=aio.thread_count,
        )
        self._prefetch_buffers: Optional[List[np.ndarray]] = None
        self._prefetch_param: Optional[str] = None
        self._pending_write_buffers: Optional[List[np.ndarray]] = None

    # --- pipelined API ----------------------------------------------------
    def prefetch_param(self, param_id: str) -> None:
        """Begin async swap-in of the NEXT param's state (double buffer)."""
        if self._prefetch_param is not None:
            return
        info = self.swap_params_info.get(param_id)
        if info is None or not info.swapped_out:
            return
        aligned = self._io_aligned_numel(info.numel)
        buffers = self.buffers.allocate(aligned, count=len(info.state_names), dtype=self.dtype)
        if buffers is None:
            return  # pool exhausted; fall back to sync path on fetch
        for buf, name in zip(buffers, info.state_names):
            self._read_handle.async_pread(buf[:aligned], info.swap_paths[name])
        self._prefetch_buffers = buffers
        self._prefetch_param = param_id

    def fetch_param(self, param_id: str, out: Dict[str, np.ndarray]) -> None:
        """Complete a prefetch (or do a sync swap-in) into ``out``."""
        info = self.swap_params_info[param_id]
        if self._prefetch_param == param_id:
            self._read_handle.wait()
            buffers = self._prefetch_buffers
            for buf, name in zip(buffers, info.state_names):
                out[name][:] = buf[: info.numel].reshape(out[name].shape)
            self.buffers.free(buffers)
            self._prefetch_param = None
            self._prefetch_buffers = None
            return
        if self._prefetch_param is not None:
            # mispredicted prefetch: drain and drop it
            logger.debug(
                f"swap prefetch of {self._prefetch_param} unused; fetching {param_id}"
            )
            self._read_handle.wait()
            self.buffers.free(self._prefetch_buffers)
            self._prefetch_param = None
            self._prefetch_buffers = None
        self.swap_in_param(param_id, out)

    def writeback_param(self, param_id: str, state_tensors: Dict[str, np.ndarray]) -> None:
        """Async swap-out of updated state; previous writeback is drained
        first (one write generation in flight)."""
        self.drain_writes()
        info = self.swap_params_info[param_id]
        aligned = self._io_aligned_numel(info.numel)
        buffers = self.buffers.allocate(aligned, count=len(info.state_names), dtype=self.dtype)
        if buffers is None:
            self.swap_out_param(param_id, state_tensors)
            return
        for buf, name in zip(buffers, info.state_names):
            src = state_tensors[name].ravel()
            buf[: src.size] = src
            self._write_handle.async_pwrite(buf[:aligned], info.swap_paths[name])
        info.swapped_out = True
        self._pending_write_buffers = buffers

    def drain_writes(self) -> None:
        if self._pending_write_buffers is not None:
            self._write_handle.wait()
            self.buffers.free(self._pending_write_buffers)
            self._pending_write_buffers = None
