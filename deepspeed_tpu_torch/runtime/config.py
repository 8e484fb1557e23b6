"""Main config: JSON/dict → ``DeepSpeedConfig``.

A copy of ``deepspeed_tpu/runtime/config.py`` (pure Python: the batch-triad
resolution, the per-feature sections and their pydantic models), so one
JSON config parses to the same values in both packages. Every section
parses; ``unported_switches`` names each switch that turns on a path the
port does not have yet, with its ROADMAP item, and the training engine
refuses those with ``NotImplementedError``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Union

from pydantic import Field, field_validator, model_validator

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import (
    DeepSpeedConfigModel,
    ScientificNotationEncoder,
    dict_raise_error_on_duplicate_keys,
)
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig, ZeroStageEnum
from deepspeed_tpu_torch.utils.logging import logger


class DeepSpeedConfigError(Exception):
    pass


class FP16Config(DeepSpeedConfigModel):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False


class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False
    # fp32 grad accumulation across micro-batches (reference bf16_optimizer)
    immediate_grad_update: bool = False


class OptimizerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = Field(default_factory=dict)
    legacy_fusion: bool = False


class SchedulerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = Field(default_factory=dict)


class MeshConfig(DeepSpeedConfigModel):
    """Logical device mesh axis sizes. 0/None = derive.

    Axis names follow the scaling-book convention: data (DP/ZeRO), model (TP),
    sequence (Ulysses SP), expert (MoE EP), pipe (PP).
    """

    data: int = 0
    # MiCS replication axis: ZeRO shards over `data` only and replicates
    # across `data_outer` groups (reference deepspeed/runtime/zero/mics.py —
    # shard groups smaller than world). Total DP = data_outer × data.
    data_outer: int = 1
    model: int = 1
    sequence: int = 1
    expert: int = 1
    pipe: int = 1


class MultiStepTrainConfig(DeepSpeedConfigModel):
    """N-step training windows (``compile.multi_step``).

    With ``enable``, a ``train_batch(data_iter=...)`` call at an optimizer
    step boundary with ``horizon`` steps of data at hand and no checkpoint
    interval boundary inside the window runs ``horizon`` whole steps as one
    step program (on the card one replay of a captured CUDA graph): the
    microbatches stacked ``[N, gas, ...]``, the lr values of the window
    evaluated ahead on the host and read in the program at a cursor that
    skips overflowed steps, the loss-scale state carried through it. The
    next ``horizon - 1`` calls commit the steps already computed. Windows
    equal N sequential ``train_batch`` calls bit for bit; a step a window
    cannot cover runs on its own and
    ``engine.window_stats()['window_break_reasons']`` says why. With
    ``gradient_accumulation_steps > 1`` the window runs the fused
    grad-accum body, so ``compile.fuse_grad_accum`` must be on.
    ``prefetch`` is parsed as JAX's; the port's look-ahead holds host
    batches only."""

    enable: bool = False
    horizon: int = 8
    prefetch: bool = True

    @model_validator(mode="after")
    def _check(self):
        if self.enable and self.horizon < 2:
            raise ValueError(
                "compile.multi_step.horizon must be >= 2 when enabled "
                "(1 is the single-step fused path)"
            )
        return self


class CompileConfig(DeepSpeedConfigModel):
    """Step-program controls.

    ``fuse_grad_accum`` runs a gas > 1 optimizer step as one step program
    (forward, backward and accumulation per stacked microbatch, then the
    update; on the card one CUDA-graph replay), engaged through
    ``train_batch``; the per-microbatch forward/backward/step protocol
    keeps the eager path. ``multi_step`` fuses N whole steps (see
    :class:`MultiStepTrainConfig`). ``cache_dir`` and
    ``cache_min_compile_secs`` are JAX's compilation-cache knobs, parsed
    for config parity; the port has no compilation cache."""

    fuse_grad_accum: bool = False
    multi_step: MultiStepTrainConfig = Field(default_factory=MultiStepTrainConfig)
    cache_dir: Optional[str] = None
    cache_min_compile_secs: float = 0.0


class AnalysisConfig(DeepSpeedConfigModel):
    """Static program-analysis controls (``deepspeed_tpu/analysis``).

    ``verify`` runs the program passes (donation-aliasing, dtype-promotion,
    host-transfer, collective budget) against each engine program right
    after its first compile: ``"warn"`` logs findings, ``"raise"`` fails
    fast on error-severity violations, ``"off"`` (default) leaves analysis
    on-demand via ``engine.analysis_report()``. ``passes`` narrows the pass
    list (empty = all). ``min_donation_bytes`` demotes unhonored donations
    smaller than the threshold to warnings (XLA legitimately skips aliasing
    tiny buffers on some backends). ``collective_budget_bytes`` turns the
    collective extractor into a gate: any single program whose static
    per-device collective payload exceeds the budget is a violation.
    Verification re-traces and re-compiles each program once — pair it with
    ``compile.cache_dir`` to make the second compile a cache hit.
    """

    verify: str = "off"  # off | warn | raise
    passes: List[str] = Field(default_factory=list)
    min_donation_bytes: int = 0
    collective_budget_bytes: Optional[int] = None
    # ZeRO-Infinity stream gate: budget for the DECLARED per-step offload
    # H2D+D2H stream bytes (overlap pass stream-accounting mode). None = no
    # budget; any declared traffic above it is an error-severity violation.
    stream_budget_bytes: Optional[int] = None
    # Static HBM gate: per-chip byte budget for the residency ledger
    # (``engine.memory_report()``) AND the memory pass's per-program peak
    # estimate. None = report-only. ``hbm_budget`` picks the reaction like
    # ``verify``: "raise" (default) fails with per-buffer attribution,
    # "warn" logs it, "off" disables the gate but keeps the ledger.
    hbm_budget_bytes: Optional[int] = None
    hbm_budget: str = "raise"  # off | warn | raise

    @field_validator("verify")
    @classmethod
    def _check_verify(cls, v):
        if v not in ("off", "warn", "raise"):
            raise ValueError(f"analysis.verify must be off|warn|raise, got {v!r}")
        return v

    @field_validator("hbm_budget")
    @classmethod
    def _check_hbm_budget(cls, v):
        if v not in ("off", "warn", "raise"):
            raise ValueError(
                f"analysis.hbm_budget must be off|warn|raise, got {v!r}"
            )
        return v


class TracingConfig(DeepSpeedConfigModel):
    """Unified tracing/metrics plane (``profiling/tracer.py``).

    ``enabled`` (default ON — the tracer is host-side only, adds zero
    device transfers and zero compiled programs, and measures under 2%
    of a bench step) records step-phase spans and engine metrics into a
    ``max_spans``-deep ring buffer, readable via ``engine.observability()``
    and exportable as a Perfetto/Chrome trace. ``flight_recorder`` arms the
    crash postmortem: on interpreter exit and on every ``utils/chaos.py``
    fault injection the last ``flight_recorder_spans`` spans + a metrics
    snapshot are dumped to ``flight_recorder_dir`` (required when armed)."""

    enabled: bool = True
    max_spans: int = 4096
    flight_recorder: bool = False
    flight_recorder_dir: Optional[str] = None
    flight_recorder_spans: int = 256

    @model_validator(mode="after")
    def _check_recorder(self):
        if self.flight_recorder and not self.flight_recorder_dir:
            raise ValueError(
                "tracing.flight_recorder requires tracing.flight_recorder_dir "
                "(the postmortem dump target)"
            )
        return self


class CommsLoggerConfig(DeepSpeedConfigModel):
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = Field(default_factory=list)


class CommsConfig(DeepSpeedConfigModel):
    comms_logger: CommsLoggerConfig = Field(default_factory=CommsLoggerConfig)

    @property
    def comms_logger_enabled(self) -> bool:
        return self.comms_logger.enabled


class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    # TPU-native: the jax.checkpoint policy name to apply to each block
    policy: str = "nothing_saveable"


class FlopsProfilerConfig(DeepSpeedConfigModel):
    enabled: bool = False
    recompute_fwd_factor: float = 0.0
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


class TensorBoardConfig(DeepSpeedConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


class WandbConfig(DeepSpeedConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed"


class CSVConfig(DeepSpeedConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


class JSONLConfig(DeepSpeedConfigModel):
    """The torch-free always-available monitor backend: one JSON line per
    event under ``output_path/job_name/events.jsonl`` (append-only — torn
    tails are tolerated by line-wise readers). Default-ON whenever the
    ``monitor`` block is enabled; rank-0 gated like every backend."""

    enabled: bool = True
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


class MonitorConfig(DeepSpeedConfigModel):
    """The ``monitor`` config block (reference ``deepspeed/monitor/config.py``
    + ``monitor.py:29`` MonitorMaster fanout).

    ``enabled`` is the master switch: it turns on the torch-free JSONL
    backend (rank 0) by default and lets the engine feed periodic metric
    events from the observability hub every ``interval_steps`` optimizer
    steps (0 = the ``steps_per_print`` cadence). TensorBoard / W&B / CSV
    remain individually opt-in (optional imports, degrade to disabled) and
    keep working from their legacy top-level config keys."""

    enabled: bool = False
    interval_steps: int = 0
    jsonl: JSONLConfig = Field(default_factory=JSONLConfig)
    tensorboard: TensorBoardConfig = Field(default_factory=TensorBoardConfig)
    wandb: WandbConfig = Field(default_factory=WandbConfig)
    csv_monitor: CSVConfig = Field(default_factory=CSVConfig)

    @property
    def active(self) -> bool:
        """Any path that produces events: the master switch (JSONL default)
        or a legacy individually-enabled backend."""
        return (
            self.enabled
            or self.tensorboard.enabled
            or self.wandb.enabled
            or self.csv_monitor.enabled
        )


class CheckpointConfig(DeepSpeedConfigModel):
    """Checkpoint controls. The fault-tolerance knobs:

    ``async_snapshot`` hides checkpoint persistence behind training compute
    — ``save_checkpoint`` snapshots the donated state tuple device→host
    (the only on-step cost, recorded as ``ckpt_stall_ms``) and a background
    writer runs the staged atomic save + commit + ``latest`` update
    (``checkpoint_engine/async_snapshot.py``). ``interval_steps`` > 0 with
    ``save_dir`` set auto-saves every N optimizer steps from inside the
    step bookkeeping, so a preempted run resumes via
    ``load_checkpoint(save_dir, auto_resume=True)`` losing at most N-1
    steps — and, because the payload carries the full replay state (RNG
    key, data cursor, loss scale, counters, LR schedule), losing ZERO
    information: the resumed losses are bit-identical to an uninterrupted
    run. ``max_inflight_snapshots`` bounds host RAM at that many state
    copies (double-buffered by default)."""

    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = Field(default_factory=dict)
    # fault tolerance -----------------------------------------------------
    async_snapshot: bool = False
    interval_steps: int = 0  # 0 = no auto-save
    save_dir: Optional[str] = None  # auto-save target (required for interval)
    max_inflight_snapshots: int = 2


class DataTypesConfig(DeepSpeedConfigModel):
    grad_accum_dtype: Optional[str] = None


class AMPConfig(DeepSpeedConfigModel):
    enabled: bool = False
    opt_level: str = "O1"


class GradientCompressionConfig(DeepSpeedConfigModel):
    enabled: bool = False


class HybridEngineConfig(DeepSpeedConfigModel):
    enabled: bool = False
    max_out_tokens: int = 512
    inference_tp_size: int = 1
    release_inference_cache: bool = False
    pin_parameters: bool = True
    tp_gather_partition_size: int = 8


class EigenvalueConfig(DeepSpeedConfigModel):
    enabled: bool = False
    verbose: bool = False
    max_iter: int = 100
    tol: float = 1e-2
    stability: float = 1e-6
    gas_boundary_resolution: int = 1
    layer_name: str = "bert.encoder.layer"
    layer_num: int = 0


class PLDConfig(DeepSpeedConfigModel):
    """Progressive layer drop (reference constants.py PROGRESSIVE_LAYER_DROP;
    runtime/progressive_layer_drop.py:40)."""

    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001


class ElasticityConfig(DeepSpeedConfigModel):
    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: List[int] = Field(default_factory=lambda: [2, 4, 6])
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    version: float = 0.1
    ignore_non_elastic_batch_info: bool = False
    prefer_larger_batch: bool = True


class AutotuningConfig(DeepSpeedConfigModel):
    enabled: bool = False
    start_step: Optional[int] = None
    end_step: Optional[int] = None
    metric: str = "throughput"
    metric_path: Optional[str] = None
    arg_mappings: Optional[Dict[str, str]] = None
    fast: bool = True
    results_dir: str = "autotuning_results"
    exps_dir: str = "autotuning_exps"
    overwrite: bool = True
    model_info: Optional[Dict[str, Any]] = None
    model_info_path: Optional[str] = None
    mp_size: int = 1
    max_train_batch_size: Optional[int] = None
    min_train_batch_size: int = 1
    max_train_micro_batch_size_per_gpu: int = 1024
    min_train_micro_batch_size_per_gpu: int = 1
    num_tuning_micro_batch_sizes: int = 3
    tuner_type: str = "gridsearch"
    tuner_early_stopping: int = 5
    tuner_num_trials: int = 50


class DeepSpeedConfig:
    """Parsed + validated config with reference-style attribute surface."""

    def __init__(self, config: Union[str, Dict], mpu=None, mesh_device=None):
        if isinstance(config, str):
            with open(config) as f:
                self._param_dict = json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        elif isinstance(config, dict):
            self._param_dict = dict(config)
        else:
            raise DeepSpeedConfigError(
                f"Expected a string path or dict for the DeepSpeed config, got {type(config)}"
            )
        self.mpu = mpu
        self.mesh_device = mesh_device
        self._initialize_params(self._param_dict)
        self._do_sanity_check()

    def _initialize_params(self, pd: Dict) -> None:
        get = pd.get
        self.train_batch_size = _noauto(get(C.TRAIN_BATCH_SIZE))
        self.train_micro_batch_size_per_gpu = _noauto(get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU))
        self.gradient_accumulation_steps = _noauto(get(C.GRADIENT_ACCUMULATION_STEPS))
        self.steps_per_print = get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)
        self.dump_state = get(C.DUMP_STATE, C.DUMP_STATE_DEFAULT)
        self.wall_clock_breakdown = get(C.WALL_CLOCK_BREAKDOWN, C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.memory_breakdown = get(C.MEMORY_BREAKDOWN, C.MEMORY_BREAKDOWN_DEFAULT)
        self.gradient_clipping = get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT)
        self.prescale_gradients = get(C.PRESCALE_GRADIENTS, C.PRESCALE_GRADIENTS_DEFAULT)
        self.gradient_predivide_factor = get(
            C.GRADIENT_PREDIVIDE_FACTOR, C.GRADIENT_PREDIVIDE_FACTOR_DEFAULT
        )
        self.sparse_gradients_enabled = get(C.SPARSE_GRADIENTS, C.SPARSE_GRADIENTS_DEFAULT)
        self.disable_allgather = get(C.DISABLE_ALLGATHER, C.DISABLE_ALLGATHER_DEFAULT)
        self.seed = get(C.SEED, None)

        self.fp16_config = FP16Config(**get(C.FP16, {}))
        bf16_dict = get(C.BFLOAT16, get(C.BFLOAT16_OLD, {}))
        self.bf16_config = BF16Config(**bf16_dict)
        self.amp_config = AMPConfig(**get(C.AMP, {}))
        self.zero_config = DeepSpeedZeroConfig(**get("zero_optimization", {}))
        self.optimizer_config = OptimizerConfig(**get(C.OPTIMIZER, {})) if get(C.OPTIMIZER) else None
        self.scheduler_config = SchedulerConfig(**get(C.SCHEDULER, {})) if get(C.SCHEDULER) else None
        self.mesh_config = MeshConfig(**get(C.MESH, {}))
        self.compile_config = CompileConfig(**get(C.COMPILE, {}))
        self.analysis_config = AnalysisConfig(**get("analysis", {}))
        self.comms_config = CommsConfig(**{"comms_logger": get(C.COMMS_LOGGER, {})})
        self.activation_checkpointing_config = ActivationCheckpointingConfig(
            **get("activation_checkpointing", {})
        )
        self.flops_profiler_config = FlopsProfilerConfig(**get("flops_profiler", {}))
        self.tracing_config = TracingConfig(**get("tracing", {}))
        # the `monitor` block is canonical (validated whole by pydantic, so
        # a typo'd key fails loudly like every other block); the legacy
        # top-level tensorboard/wandb/csv_monitor keys keep working
        # underneath it, and `csv` aliases `csv_monitor` inside the block
        mon = dict(get("monitor", {}) or {})
        if "csv" in mon:
            mon["csv_monitor"] = mon.pop("csv")
        mon.setdefault("tensorboard", get("tensorboard", {}))
        mon.setdefault("wandb", get("wandb", {}))
        mon.setdefault("csv_monitor", get("csv_monitor", {}))
        self.monitor_config = MonitorConfig(**mon)
        self.checkpoint_config = CheckpointConfig(**get(C.CHECKPOINT, {}))
        self.data_types_config = DataTypesConfig(**get(C.DATA_TYPES, {}))
        self.hybrid_engine = HybridEngineConfig(**get("hybrid_engine", {}))
        self.eigenvalue_config = EigenvalueConfig(**get(C.EIGENVALUE, {}))
        self.pld_config = PLDConfig(**get("progressive_layer_drop", {}))
        self.elasticity_config = ElasticityConfig(**get("elasticity", {}))
        self.autotuning_config = AutotuningConfig(**get("autotuning", {}))
        self.compression_config = pd.get("compression_training", {})
        self.data_efficiency_config = pd.get("data_efficiency", {})
        self.curriculum_learning_config = pd.get("curriculum_learning", {})
        self.nebula_config = pd.get("nebula", {})
        self.aio_config = pd.get("aio", {})

        self.zero_enabled = self.zero_config.stage > ZeroStageEnum.disabled
        self.zero_optimization_stage = int(self.zero_config.stage)
        self.fp16_enabled = self.fp16_config.enabled
        self.bfloat16_enabled = self.bf16_config.enabled
        self.amp_enabled = self.amp_config.enabled
        self.loss_scale = self.fp16_config.loss_scale
        self.initial_dynamic_scale = 2**self.fp16_config.initial_scale_power
        self.dynamic_loss_scale_args = {
            "init_scale": 2**self.fp16_config.initial_scale_power,
            "scale_window": self.fp16_config.loss_scale_window,
            "min_scale": self.fp16_config.min_loss_scale,
            "delayed_shift": self.fp16_config.hysteresis,
            "consecutive_hysteresis": self.fp16_config.consecutive_hysteresis,
        }
        self.checkpoint_tag_validation_enabled = (
            self.checkpoint_config.tag_validation.lower() != "ignore"
        )
        self.checkpoint_tag_validation_fail = self.checkpoint_config.tag_validation.lower() == "fail"
        self.load_universal_checkpoint = self.checkpoint_config.load_universal
        self.elasticity_enabled = self.elasticity_config.enabled

    def resolve_batch_triad(self, dp_world_size: int) -> None:
        """Resolve train_batch = micro_batch × gas × dp (reference config.py).

        Any one or two of the triad may be given; the rest are derived. All
        three given → must multiply out exactly.
        """
        tb, mb, gas = (
            self.train_batch_size,
            self.train_micro_batch_size_per_gpu,
            self.gradient_accumulation_steps,
        )
        if tb and mb and gas:
            if tb != mb * gas * dp_world_size:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} != micro_batch {mb} × gas {gas} × dp {dp_world_size}"
                )
        elif tb and mb:
            gas, rem = divmod(tb, mb * dp_world_size)
            if rem:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} not divisible by micro_batch {mb} × dp {dp_world_size}"
                )
        elif tb and gas:
            mb, rem = divmod(tb, gas * dp_world_size)
            if rem:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} not divisible by gas {gas} × dp {dp_world_size}"
                )
        elif mb and gas:
            tb = mb * gas * dp_world_size
        elif mb:
            gas = 1
            tb = mb * dp_world_size
        elif tb:
            mb, rem = divmod(tb, dp_world_size)
            gas = 1
            if rem:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} not divisible by dp world size {dp_world_size}"
                )
        else:
            raise DeepSpeedConfigError(
                "At least one of train_batch_size / train_micro_batch_size_per_gpu / "
                "gradient_accumulation_steps must be set"
            )
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = gas

    def _do_sanity_check(self) -> None:
        if self.fp16_enabled and self.bfloat16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        if self.zero_enabled and self.zero_optimization_stage > int(ZeroStageEnum.max_stage):
            raise DeepSpeedConfigError(
                f"ZeRO stage {self.zero_optimization_stage} > max {int(ZeroStageEnum.max_stage)}"
            )
        if self.optimizer_config and self.optimizer_config.type:
            from deepspeed_tpu_torch.runtime.constants import DEEPSPEED_OPTIMIZERS

            name = self.optimizer_config.type.lower()
            if name not in DEEPSPEED_OPTIMIZERS:
                logger.warning(f"optimizer {name!r} is not a DeepSpeed optimizer; treating as client-style")

    def print_config(self, name: str = "DeepSpeedConfig") -> None:
        logger.info(f"{name}:\n" + json.dumps(self._param_dict, indent=2, cls=ScientificNotationEncoder))


def _noauto(v):
    return None if v == "auto" else v


def unported_switches(cfg: DeepSpeedConfig) -> List[str]:
    """Messages for every switch set in ``cfg`` whose path the port's
    training engine does not have yet, each naming its ROADMAP item."""
    z = cfg.zero_config
    found = []
    if z.zero_quantized_weights or z.zero_quantized_gradients or z.zero_quantized_nontrainable_weights:
        found.append("ZeRO++ quantized weights / gradients: ROADMAP P1")
    if z.zero_hpz_partition_size > 1 or z.mics_shard_size > 0:
        found.append("ZeRO++ hpZ / MiCS shard groups: ROADMAP P1")
    mc = cfg.mesh_config
    if max(mc.model, mc.sequence, mc.pipe) > 1:
        found.append("mesh model / sequence / pipe axes > 1 (tensor, sequence, pipeline parallel): ROADMAP P1")
    if mc.data_outer > 1:
        found.append("mesh.data_outer > 1 (MiCS shard groups): ROADMAP P1")
    if cfg.sparse_gradients_enabled:
        found.append("sparse_gradients: ROADMAP P1")
    if cfg.comms_config.comms_logger_enabled:
        found.append("comms_logger.enabled: ROADMAP P1")
    if cfg.flops_profiler_config.enabled:
        found.append("flops_profiler.enabled: ROADMAP X1")
    if cfg.monitor_config.active:
        found.append("monitor / tensorboard / wandb / csv_monitor: ROADMAP X1")
    if cfg.tracing_config.flight_recorder:
        found.append("tracing.flight_recorder: ROADMAP X1")
    if cfg.analysis_config.verify != "off":
        found.append("analysis.verify: ROADMAP X1")
    for name, section in (("hybrid_engine", cfg.hybrid_engine), ("eigenvalue", cfg.eigenvalue_config),
                          ("elasticity", cfg.elasticity_config), ("autotuning", cfg.autotuning_config)):
        if section.enabled:
            found.append(f"{name}.enabled: ROADMAP X1")
    if cfg.compression_config:
        found.append("compression_training: ROADMAP X1")
    return found
