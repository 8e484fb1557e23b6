"""Tensor swapping to disk (ZeRO-Infinity).

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/`` (the reference's
``deepspeed/runtime/swap_tensor/``), built on the host aio library
(``csrc/host/deepspeed_aio.cpp``).
"""

from deepspeed_tpu_torch.runtime.swap_tensor.aio_config import AioConfig, get_aio_config
from deepspeed_tpu_torch.runtime.swap_tensor.utils import SwapBuffer, SwapBufferManager, SwapBufferPool
from deepspeed_tpu_torch.runtime.swap_tensor.async_swapper import AsyncTensorSwapper
from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_utils import OptimizerSwapper
from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_optimizer_swapper import (
    PartitionedOptimizerSwapper,
)
