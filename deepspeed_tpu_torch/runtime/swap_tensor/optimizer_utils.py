"""Optimizer-state swapper base.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/optimizer_utils.py``
(the reference's ``OptimizerSwapper``, ``swap_tensor/optimizer_utils.py:112``): owns the file layout for each
parameter's optimizer-state tensors (master fp32 + moments) on the swap
device, the staging-buffer pool, and the swap-in/out of whole parameter
groups. Subclasses choose the overlap strategy.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
from deepspeed_tpu_torch.runtime.swap_tensor.aio_config import AioConfig
from deepspeed_tpu_torch.runtime.swap_tensor.utils import (
    MIN_AIO_BYTES,
    AIO_ALIGNED_BYTES,
    SwapBufferManager,
)
from deepspeed_tpu_torch.utils.logging import logger


class SwapTensorInfo:
    """File-backed state tensors for one parameter (reference
    ``OptimizerStateSwapInfo`` optimizer_utils.py:37)."""

    def __init__(self, param_id: str, numel: int, swap_folder: str, state_names: List[str]):
        self.param_id = param_id
        self.numel = numel
        self.state_names = list(state_names)
        self.swap_paths = {
            name: os.path.join(swap_folder, f"{param_id}_{name}.tensor.swp")
            for name in state_names
        }
        self.swapped_out = False


class OptimizerSwapper:
    def __init__(
        self,
        swap_config,
        aio_config: AioConfig,
        base_folder: str,
        largest_numel: int,
        device_id: int = 0,
        dtype=np.float32,
    ):
        self.swap_config = swap_config
        self.aio_config = aio_config
        self.dtype = np.dtype(dtype)

        self.swap_folder = os.path.join(base_folder, "zero_stage_3", "optimizer", f"rank{device_id}")
        os.makedirs(self.swap_folder, exist_ok=True)

        self.min_aio_bytes = max(MIN_AIO_BYTES, aio_config.block_size)
        self.aligned_bytes = AIO_ALIGNED_BYTES * aio_config.thread_count
        self.numel_alignment = self.aligned_bytes // self.dtype.itemsize
        self.largest_numel = self._io_aligned_numel(largest_numel)

        buffer_count = getattr(swap_config, "buffer_count", 4)
        self.buffers = SwapBufferManager(
            num_elems=self.largest_numel, count=buffer_count, dtype=self.dtype,
            pin_memory=bool(getattr(swap_config, "pin_memory", False)),
        )
        self.aio_handle = AsyncIOHandle(
            block_size=aio_config.block_size,
            queue_depth=aio_config.queue_depth,
            single_submit=aio_config.single_submit,
            overlap_events=aio_config.overlap_events,
            thread_count=aio_config.thread_count,
        )
        self.swap_params_info: Dict[str, SwapTensorInfo] = {}

    def purge_state(self) -> None:
        """Drop all swap files (fresh-start after checkpoint load)."""
        shutil.rmtree(self.swap_folder, ignore_errors=True)
        os.makedirs(self.swap_folder, exist_ok=True)
        self.swap_params_info.clear()

    def register_param(self, param_id: str, numel: int, state_names: List[str]) -> SwapTensorInfo:
        if param_id not in self.swap_params_info:
            self.swap_params_info[param_id] = SwapTensorInfo(
                param_id, numel, self.swap_folder, state_names
            )
        return self.swap_params_info[param_id]

    def swappable_tensor(self, numel: int) -> bool:
        return numel * self.dtype.itemsize >= self.min_aio_bytes

    def _io_aligned_numel(self, numel: int) -> int:
        remainder = numel % self.numel_alignment
        return numel if remainder == 0 else numel + self.numel_alignment - remainder

    # --- synchronous single-param swap primitives ------------------------
    def swap_out_param(self, param_id: str, state_tensors: Dict[str, np.ndarray]) -> None:
        info = self.swap_params_info[param_id]
        aligned = self._io_aligned_numel(info.numel)
        buffers = self.buffers.allocate(aligned, count=len(info.state_names), dtype=self.dtype)
        assert buffers is not None, "no free swap buffers"
        try:
            for buf, name in zip(buffers, info.state_names):
                src = state_tensors[name].ravel()
                buf[: src.size] = src
                self.aio_handle.async_pwrite(buf[:aligned], info.swap_paths[name])
            self.aio_handle.wait()
            info.swapped_out = True
        finally:
            self.buffers.free(buffers)

    def swap_in_param(self, param_id: str, out: Dict[str, np.ndarray]) -> None:
        info = self.swap_params_info[param_id]
        assert info.swapped_out, f"param {param_id} has no swapped state"
        aligned = self._io_aligned_numel(info.numel)
        buffers = self.buffers.allocate(aligned, count=len(info.state_names), dtype=self.dtype)
        assert buffers is not None, "no free swap buffers"
        try:
            for buf, name in zip(buffers, info.state_names):
                self.aio_handle.async_pread(buf[:aligned], info.swap_paths[name])
            self.aio_handle.wait()
            for buf, name in zip(buffers, info.state_names):
                out[name][:] = buf[: info.numel].reshape(out[name].shape)
        finally:
            self.buffers.free(buffers)

    def log_statistics(self) -> None:
        n = len(self.swap_params_info)
        total = sum(i.numel * len(i.state_names) for i in self.swap_params_info.values())
        logger.info(
            f"OptimizerSwapper: {n} params, "
            f"{total * self.dtype.itemsize / 1024**3:.2f} GB on {self.swap_folder}"
        )
