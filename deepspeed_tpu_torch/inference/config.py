"""Inference config: the JSON schema of ``deepspeed_tpu/inference/config.py``.

The same JSON parses here. Switches whose code paths this package does not
have yet parse too, and ``unported_switches`` names them so the engine can
refuse them with ``NotImplementedError`` (each message names the ROADMAP
item that will port it). ``analysis`` and ``tracing`` are accepted as
plain dicts; their defaults do nothing, and the values JAX acts on
(``analysis.verify`` other than ``"off"``, a truthy
``tracing.flight_recorder``) are refused, as is a set
``save_mp_checkpoint_path``.

``paged_kv.attn_impl`` takes ``auto | kernel | plain``: ``auto`` and
``kernel`` launch the CUDA ragged paged-attention kernel on a CUDA tensor
(``plain`` runs the PyTorch reference there, and only when asked for by
name); on a CPU tensor every name takes the plain version. The JAX names
``pallas`` and ``xla`` are accepted as ``kernel`` and ``plain``.
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Dict, List, Optional

from pydantic import Field, field_validator, model_validator

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

ATTN_IMPLS = ("auto", "kernel", "plain")
_JAX_ATTN_NAMES = {"pallas": "kernel", "xla": "plain"}


def canonical_attn_impl(name: str) -> str:
    """Map an ``attn_impl`` name (port or JAX spelling) to auto|kernel|plain."""
    name = _JAX_ATTN_NAMES.get(name, name)
    if name not in ATTN_IMPLS:
        raise ValueError(
            f"unknown attn_impl {name!r}; expected auto|kernel|plain (or the JAX names pallas|xla)"
        )
    return name


class DtypeEnum(str, Enum):
    fp32 = "fp32"
    fp16 = "fp16"
    bf16 = "bf16"
    int8 = "int8"


class DeepSpeedTPConfig(DeepSpeedConfigModel):
    enabled: bool = True
    tp_size: int = 1
    mpu: Optional[Any] = None
    tp_group: Optional[Any] = None


class DeepSpeedMoEConfig(DeepSpeedConfigModel):
    enabled: bool = True
    ep_size: int = 1
    moe_experts: list = Field(default_factory=lambda: [1])
    type: str = "standard"


class QuantizationConfig(DeepSpeedConfigModel):
    enabled: bool = False
    num_bits: int = 8
    group_size: int = 64


class CheckpointConfig(DeepSpeedConfigModel):
    checkpoint_dir: Optional[str] = None
    save_mp_checkpoint_path: Optional[str] = None
    base_dir: Optional[str] = None


class MultiStepConfig(DeepSpeedConfigModel):
    """Multi-step serving windows (``decode.py:build_ragged_multistep``,
    ``scheduler.py:PagedServer._ragged_window``). With ``enable``, a
    ragged scheduler step whose running set is stable (nothing queued,
    nothing prefilling, the whole window's pages reservable without
    preemption) runs ``horizon`` plain-decode rounds as one window: one
    CUDA graph replay on a card, with one host fetch. Any scheduling event
    falls back to the single-step ragged path, and greedy streams stay
    byte-identical to it."""

    enable: bool = False
    horizon: int = 8  # decode rounds a window runs (>= 2)

    @model_validator(mode="after")
    def _check_horizon(self):
        if self.enable and self.horizon < 2:
            raise ValueError(
                f"paged_kv.multi_step.horizon must be >= 2 (1 is the single-step path), "
                f"got {self.horizon}"
            )
        return self


class ShardedServingConfig(DeepSpeedConfigModel):
    """Tensor-parallel serving knobs (not ported yet: ROADMAP S9, int8
    weights S8)."""

    tp_degree: int = 0
    quantized_allreduce: bool = False
    comm_chunks: int = 2
    weight_quant_bits: int = 0

    @model_validator(mode="after")
    def _check(self):
        if self.tp_degree < 0:
            raise ValueError(f"sharded.tp_degree must be >= 0, got {self.tp_degree}")
        if self.comm_chunks < 1:
            raise ValueError(f"sharded.comm_chunks must be >= 1, got {self.comm_chunks}")
        if self.weight_quant_bits not in (0, 8):
            raise ValueError(
                f"sharded.weight_quant_bits supports 0 (off) or 8 (int8), "
                f"got {self.weight_quant_bits}"
            )
        return self


class PagedKVConfig(DeepSpeedConfigModel):
    """Paged-KV serving knobs (``engine.serve()``: page pool + continuous
    batching, ``inference/kv_pool.py`` / ``inference/scheduler.py``).

    Cache memory is ``num_pages × page_size × 2·L·NKV·D·dtype_bytes``. With
    ``num_pages = 0`` the pool is sized worst-case
    (``max_slots × ceil(max_seq_len / page_size) + 1``, preemption-free).
    With ``ragged`` (the default) every scheduler step is one call of the
    ragged step (``decode.py:build_ragged_step``): prefill chunks and decode
    rows ride together, driven by per-row ``(kv_len, q_len)`` arrays. With
    ``ragged=False`` (the bucketed oracle) each prompt chunk is its own
    call and each decode round one call padded to a ``slot_buckets``
    size."""

    enabled: bool = True
    page_size: int = 16
    num_pages: int = 0  # 0 = worst-case auto-size (no preemption possible)
    max_slots: int = 8  # concurrent sequences (rows of the step)
    slot_buckets: list = Field(default_factory=list)  # bucketed oracle only
    max_seq_len: int = 0  # 0 = the model config's max_seq_len
    prefill_chunk: int = 32  # prompt tokens per row per step
    attn_impl: str = "auto"  # auto | kernel | plain (JAX names pallas | xla accepted)
    prefix_cache: bool = True  # page-level prefix sharing (hash-of-block + CoW)
    ragged: bool = True  # False = the bucketed oracle (prefill chunks + slot-bucket decode rounds)
    multi_step: MultiStepConfig = Field(default_factory=MultiStepConfig)
    sharded: ShardedServingConfig = Field(default_factory=ShardedServingConfig)

    @field_validator("attn_impl")
    @classmethod
    def _check_attn_impl(cls, v):
        return canonical_attn_impl(v)

    @model_validator(mode="after")
    def _check_multi_step(self):
        if self.multi_step.enable and not self.ragged:
            raise ValueError("paged_kv.multi_step runs over the ragged serving path")
        if self.sharded.tp_degree > 1 and not self.ragged:
            raise ValueError("paged_kv.sharded tensor-parallel serving runs over the ragged path")
        return self


class TenantConfig(DeepSpeedConfigModel):
    name: str
    weight: float = 1.0
    priority: int = 0
    ttft_target_ms: Optional[float] = None
    tpot_target_ms: Optional[float] = None
    max_queued: Optional[int] = None
    max_live_slots: Optional[int] = None


class TrafficConfig(DeepSpeedConfigModel):
    """Multi-tenant SLA serving (not ported yet: ROADMAP S7)."""

    enabled: bool = False
    tenants: List[TenantConfig] = Field(default_factory=list)


class JournalConfig(DeepSpeedConfigModel):
    """Serving crash-recovery journal (not ported yet: ROADMAP S6)."""

    enabled: bool = False
    dir: Optional[str] = None
    segment_bytes: int = 1 << 20
    fsync: bool = True


class SpecDecodeConfig(DeepSpeedConfigModel):
    """Speculative decoding (not ported yet: ROADMAP S4)."""

    enable: bool = False
    max_draft: int = 4
    ngram_order: int = 3
    spec_lens: list = Field(default_factory=list)


class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    replace_with_kernel_inject: bool = Field(False, alias="kernel_inject")
    dtype: DtypeEnum = DtypeEnum.bf16
    tensor_parallel: DeepSpeedTPConfig = Field(default_factory=DeepSpeedTPConfig, alias="tp")
    enable_cuda_graph: bool = False
    use_triton: bool = False
    triton_autotune: bool = False
    zero: Dict[str, Any] = Field(default_factory=dict)
    triangular_masking: bool = Field(True, alias="tm")
    moe: DeepSpeedMoEConfig = Field(default_factory=DeepSpeedMoEConfig)
    quant: QuantizationConfig = Field(default_factory=QuantizationConfig)
    paged_kv: PagedKVConfig = Field(default_factory=PagedKVConfig)
    spec_decode: SpecDecodeConfig = Field(default_factory=SpecDecodeConfig)
    traffic: TrafficConfig = Field(default_factory=TrafficConfig)
    journal: JournalConfig = Field(default_factory=JournalConfig)
    analysis: Dict[str, Any] = Field(default_factory=dict)
    tracing: Dict[str, Any] = Field(default_factory=dict)
    checkpoint: Optional[Any] = None
    base_dir: str = ""
    set_empty_params: bool = False
    save_mp_checkpoint_path: Optional[str] = None
    checkpoint_config: CheckpointConfig = Field(default_factory=CheckpointConfig, alias="ckpt_config")
    return_tuple: bool = True
    training_mp_size: int = 1
    replace_method: str = "auto"
    injection_policy: Optional[Dict] = Field(None, alias="injection_dict")
    injection_policy_tuple: Optional[tuple] = None
    config: Optional[Dict] = None
    max_out_tokens: int = Field(1024, alias="max_tokens")
    min_out_tokens: int = Field(1, alias="min_tokens")
    transposed_mode: bool = False
    ep_size: int = 1
    ep_group: Optional[Any] = Field(None, alias="expert_group")
    ep_mp_group: Optional[Any] = Field(None, alias="expert_mp_group")
    moe_experts: list = Field(default_factory=lambda: [1])
    moe_type: str = "standard"

    @model_validator(mode="before")
    @classmethod
    def _legacy_mp_size(cls, values):
        """The reference's deprecated ``mp_size`` maps onto tensor_parallel.tp_size."""
        if isinstance(values, dict) and "mp_size" in values:
            mp = values.pop("mp_size")
            values.setdefault("tensor_parallel", {"tp_size": mp})
        return values


def unported_switches(cfg: DeepSpeedInferenceConfig) -> List[str]:
    """Messages for every switch set in ``cfg`` whose path this package
    does not have yet, each naming its ROADMAP item."""
    p = cfg.paged_kv
    found = []
    if cfg.spec_decode.enable:
        found.append("spec_decode.enable: ROADMAP S4")
    if cfg.journal.enabled:
        found.append("journal.enabled: ROADMAP S6")
    if cfg.traffic.enabled:
        found.append("traffic.enabled: ROADMAP S7")
    if p.sharded.weight_quant_bits == 8:
        found.append("paged_kv.sharded.weight_quant_bits=8: ROADMAP S8")
    if max(p.sharded.tp_degree, cfg.tensor_parallel.tp_size) > 1:
        found.append("tensor-parallel serving (sharded.tp_degree / tp_size > 1): ROADMAP S9")
    if cfg.quant.enabled:
        found.append("quant.enabled (weight quantization): ROADMAP S8")
    if cfg.zero:
        found.append("zero (ZeRO-Inference offload): ROADMAP T2")
    if cfg.checkpoint is not None:
        found.append("checkpoint= loading (use engine.load_jax_params): ROADMAP T3")
    if cfg.save_mp_checkpoint_path:
        found.append("save_mp_checkpoint_path (MP checkpoint at set_params): ROADMAP T3")
    if str(cfg.analysis.get("verify", "off")) != "off":
        found.append("analysis.verify (static passes on each program): ROADMAP X1")
    if cfg.tracing.get("flight_recorder"):
        found.append("tracing.flight_recorder: ROADMAP X1")
    return found
