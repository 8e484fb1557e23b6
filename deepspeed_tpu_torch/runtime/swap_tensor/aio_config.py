"""AIO config block: a copy of ``deepspeed_tpu/runtime/swap_tensor/aio_config.py``
(reference ``deepspeed/runtime/swap_tensor/aio_config.py``).

Defaults match the reference (block_size 1MB, queue_depth 8, thread_count 1,
single_submit False, overlap_events True) — validated against its NVMe sweep
harness (csrc/aio/py_test/aio_bench_perf_sweep.py).
"""

from __future__ import annotations

from pydantic import Field

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

AIO_DEFAULT_DICT = {
    "block_size": 1048576,
    "queue_depth": 8,
    "thread_count": 1,
    "single_submit": False,
    "overlap_events": True,
}


class AioConfig(DeepSpeedConfigModel):
    block_size: int = Field(AIO_DEFAULT_DICT["block_size"], ge=4096)
    queue_depth: int = Field(AIO_DEFAULT_DICT["queue_depth"], ge=1)
    thread_count: int = Field(AIO_DEFAULT_DICT["thread_count"], ge=1)
    single_submit: bool = AIO_DEFAULT_DICT["single_submit"]
    overlap_events: bool = AIO_DEFAULT_DICT["overlap_events"]


def get_aio_config(param_dict: dict) -> AioConfig:
    aio_dict = param_dict.get("aio", {}) if isinstance(param_dict, dict) else {}
    return AioConfig(**aio_dict)
