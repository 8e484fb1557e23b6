"""Offload configs: a copy of ``deepspeed_tpu/runtime/zero/offload_config.py``
(the JSON schema). Offload sections parse; the port's training engine then
refuses a device other than ``none`` (ROADMAP T2).
"""

from enum import Enum
from pathlib import Path
from typing import Optional

from pydantic import Field

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel, pp_int


class OffloadDeviceEnum(str, Enum):
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[Path] = None
    buffer_count: int = Field(5, ge=0)
    buffer_size: int = Field(pp_int(int(1e8)), ge=0)
    max_in_cpu: int = Field(pp_int(int(1e9)), ge=0)
    pin_memory: bool = False


class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[Path] = None
    buffer_count: int = Field(4, ge=0)
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = Field(1.0, ge=0.0, le=1.0)
    # streamed (ZeRO-Infinity) path: elements per H2D/D2H bucket — the unit
    # the fp32 master + moments stream through the depth-2 pipeline in
    # (runtime/zero/host_offload.py). Same units as reduce_bucket_size.
    bucket_size: int = Field(pp_int(int(5e7)), ge=1)

    @property
    def pipeline(self) -> bool:
        """True selects the STREAMED offload engine (host buffers + donated
        per-bucket device update) over the legacy host-Adam path."""
        return self.pipeline_read or self.pipeline_write
