"""ZeRO config: a copy of ``deepspeed_tpu/runtime/zero/config.py`` (the
JSON schema), so the same ``zero_optimization`` section parses to the same
values. The port's training engine runs stages 0-3 at any number of ranks,
with optimizer offload (stage >= 1) and parameter offload (stage 3).
"""

from enum import Enum
from typing import Optional

from pydantic import Field, model_validator

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel, pp_int
from deepspeed_tpu_torch.runtime.zero.offload_config import (
    DeepSpeedZeroOffloadOptimizerConfig,
    DeepSpeedZeroOffloadParamConfig,
    OffloadDeviceEnum,
)


class ZeroStageEnum(int, Enum):
    disabled = 0
    optimizer_states = 1
    gradients = 2
    weights = 3
    max_stage = 3


class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    stage: ZeroStageEnum = ZeroStageEnum.disabled
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = Field(pp_int(int(5e8)), ge=0)
    allgather_partitions: bool = True
    allgather_bucket_size: int = Field(pp_int(int(5e8)), ge=0)
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False

    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = None
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = None

    sub_group_size: int = Field(pp_int(int(1e9)), ge=0)
    cpu_offload_param: Optional[bool] = Field(
        None, json_schema_extra={"deprecated": True, "new_param": "offload_param"}
    )
    cpu_offload_use_pin_memory: Optional[bool] = None
    cpu_offload: Optional[bool] = Field(
        None, json_schema_extra={"deprecated": True, "new_param": "offload_optimizer"}
    )

    # comm/compute overlap (runtime/zero/overlap.py): how many layers of the
    # scanned stack the pipelined stage-3 gather runs AHEAD of use (the
    # reference's prefetch coordinator depth). None → 1 when stage 3 and
    # overlap_comm (the default there), off elsewhere; 0 = the explicit
    # use-point gather (same gather structure, zero lookahead — the
    # bit-identical "unpipelined" baseline of the parity suite). In-flight
    # prefetched elements are additionally capped by
    # stage3_prefetch_bucket_size.
    prefetch_layers: Optional[int] = Field(None, ge=0)
    prefetch_bucket_size: int = Field(pp_int(int(5e7)), ge=0, alias="stage3_prefetch_bucket_size")
    param_persistence_threshold: int = Field(pp_int(int(1e5)), ge=0, alias="stage3_param_persistence_threshold")
    model_persistence_threshold: int = Field(pp_int(int(1e13)), ge=0, alias="stage3_model_persistence_threshold")
    max_live_parameters: int = Field(pp_int(int(1e9)), ge=0, alias="stage3_max_live_parameters")
    max_reuse_distance: int = Field(pp_int(int(1e9)), ge=0, alias="stage3_max_reuse_distance")
    gather_16bit_weights_on_model_save: bool = Field(False, alias="stage3_gather_16bit_weights_on_model_save")

    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False

    # ZeRO++ knobs
    zero_hpz_partition_size: int = Field(1, ge=0)
    zero_quantized_weights: bool = False
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False

    mics_shard_size: int = Field(-1, alias="mics_shard_size")
    mics_hierarchical_params_gather: bool = False

    memory_efficient_linear: bool = True
    pipeline_loading_checkpoint: bool = False
    override_module_apply: bool = True

    @model_validator(mode="after")
    def _overlap_comm_default(self):
        if self.overlap_comm is None:
            object.__setattr__(self, "overlap_comm", self.stage == ZeroStageEnum.weights)
        return self

    @model_validator(mode="before")
    @classmethod
    def _legacy_cpu_offload(cls, values):
        """Deprecated ``cpu_offload*`` keys route to the real offload path —
        never parse-then-silently-no-op."""
        if isinstance(values, dict):
            pin = values.pop("cpu_offload_use_pin_memory", None)
            if values.pop("cpu_offload", None):
                values.setdefault("offload_optimizer", {"device": OffloadDeviceEnum.cpu})
            if values.pop("cpu_offload_param", None):
                values.setdefault("offload_param", {"device": OffloadDeviceEnum.cpu})
            if pin is not None:
                off = values.get("offload_optimizer")
                if isinstance(off, dict):
                    off.setdefault("pin_memory", bool(pin))
                elif off is None:
                    raise ValueError(
                        "cpu_offload_use_pin_memory is set but no offloaded "
                        "optimizer is configured (cpu_offload or "
                        "offload_optimizer.device); the knob would be silently "
                        "ignored — remove it or configure offload_optimizer"
                    )
        return values
