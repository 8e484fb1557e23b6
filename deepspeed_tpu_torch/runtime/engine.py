"""The training engine: forward, backward and the optimizer step.

Counterpart of the core of ``deepspeed_tpu/runtime/engine.py``
(``DeepSpeedEngine``) for one rank. The state is what JAX keeps:

* the fp32 master, a flat ``path -> tensor`` dict in the JAX tree's paths;
* the compute-dtype parameters (the same tensors as the master in fp32
  training), leaves with ``requires_grad`` that the model's functional
  ``apply`` reads;
* the Adam state, an fp32 gradient-accumulation buffer (dtype from
  ``data_types.grad_accum_dtype``) and the loss-scale state.

``forward`` runs the model and returns the loss with its graph;
``backward`` back-propagates the loss times the loss scale and moves each
leaf's gradient into the accumulation buffer (torch would otherwise sum
microbatches in the leaves' dtype, bf16); ``step`` applies the update at
the accumulation boundary. ``_update_from_grads`` is JAX's
``update_from_grads`` and ``step_fn`` (``engine.py:1259-1304``) in one
place: unscale by ``1 / (scale · gas)``; the global L2 norm of the fp32
gradients (reported by ``get_global_grad_norm``, before clipping);
``coef = min(1, clip / (norm + 1e-6))``; the optimizer on the master;
under fp16 an overflow keeps the old state and shrinks the scale; the
compute parameters are re-cast from the master, never updated in bf16.

Checkpoints (JAX ``engine.py:3240-3736``): ``save_checkpoint`` writes the
full replay state (module, fp32 master, Adam moments, loss scale, lr
schedule, counters, the dropout generator's state) through the torch
checkpoint engine, staged and committed atomically, synchronously or
through the async writer (``checkpoint.async_snapshot``: the step pays only
the device→host copy); ``checkpoint.interval_steps`` with ``save_dir``
saves from inside ``step``; ``load_checkpoint(auto_resume=True)`` resumes
from the newest valid tag, and the resumed losses are bit-identical to an
uninterrupted run's.

Data parallelism (JAX ``partition.py:1-25``; ``runtime/zero/``): under a
``torch.distributed`` group the engine is one rank of ``mesh.data`` (the
world by default). Every rank passes the same global micro batch (``micro
× dp`` rows) and takes its own rows (JAX's multi-host batch contract,
``engine.py:978-1001``). The ZeRO stage decides where the state lives,
never the math:

* stage 0: all state replicated; the accumulated gradients are summed
  over the ranks at the boundary (one bucketed all-reduce);
* stage 1: the fp32 master and the Adam moments hold this rank's slice
  (``partition.ZeroPartitioner``); the summed gradients' slice updates it
  and the new compute parameters are all-gathered;
* stage 2: the gradient accumulators are slices too, each microbatch's
  gradients reduce-scattered into them (``overlap.GradBuckets``, issued
  while backward runs under ``overlap_comm``);
* stage 3: the compute parameters are stored sliced and gathered layer by
  layer (``overlap.OverlapPlan``), again in backward, then freed.

The gradients are the global-batch mean: each rank back-propagates its
rows' token sum over the global token count times dp, the reduction sums
and the update divides by dp; the loss ``forward`` returns is the global
mean on every rank. The clipping norm is global (at stage >= 2 the
squares of the slices, all-reduced); under fp16 an overflow on any rank
skips the step on every rank. ``global_samples`` counts ``micro × dp``.
At one rank nothing is sharded and every step is the one-rank engine's,
bit for bit. ``set_params`` / ``get_param_treedef`` are the two halves of
``zero.GatheredParameters``; ``get_params`` / ``get_master_params`` return
the whole tree on every rank. Checkpoints hold whole arrays whatever the
dp (the slices gathered, rank 0 writes) and load at any dp.

Expert parallelism (JAX ``partition.py:83``, ``moe/a2a.py``): with
``mesh.expert`` > 1, or the topology ``utils.groups.initialize``
established when the config names no mesh (``parallel/mesh.topology_for``),
the ``data × expert`` ranks are the data-parallel world. Each expert leaf
``[L, E, ...]`` holds this rank's ``E/e`` experts and no ZeRO slice at any
stage (the master and the moments alike); its gradient is reduced over the
expert-data group only, and the global grad norm counts each expert shard
once. Across ranks an MoE model's loss is the LM loss weighted by this
rank's share, as above, plus the load-balance loss, one global value whose
gradient reaches this rank's own tokens (times dp). The a2a stage
(``overlap.A2AStage``, the plan's at stage 3) carries ``moe_quantized_a2a``
to the layers. Checkpoints gather the experts: whole arrays, as at dp > 1.
ZeRO optimizer offload keeps each rank's expert slices on the host.

Offload (JAX ``engine.py:779-890``): ``zero_optimization.offload_param``
(stage 3) trains through the layer stream (``runtime/zero/param_offload.py``);
``offload_optimizer`` (stage >= 1) keeps the fp32 master and the moments on
the host, streamed bucket by bucket through the engine's own update
(``runtime/zero/host_offload.py``, with ``pipeline_read`` or
``pipeline_write`` and ``device=cpu``; bit for bit the on-card engine) or
updated by the host Adam (``runtime/zero/offload_states.py``, the legacy
path, ``device=cpu|nvme``). Both run Adam/AdamW only and refuse a client
optimizer. Their checkpoints carry ``optimizer["param_stream"]`` or
``optimizer["host_offload"]`` (JAX's records) and no ``master``.

Step programs (JAX ``engine.py:19-31``, ``:1317-1620``): the update runs on
device state only. The loss scale, the lr, the Adam step count and the
overflow flag are device scalars, an overflow keeps master and moments by
``torch.where`` and walks the scale in place, and nothing is read on the
host inside the step. ``compile.fuse_grad_accum`` (gas > 1, through
``train_batch``) runs the gas microbatches and the update as one step
program; ``compile.multi_step`` runs ``horizon`` whole steps as one, the
window's per-step results drained to the host one window late. On the card
a step program's first call runs eagerly on a side stream (PyTorch's
warm-up: a real step), the second captures it as a ``torch.cuda.CUDAGraph``
and replays it, every later call copies its batch into the static buffers
and replays; on the CPU the same body runs eagerly. The eager path runs the
same ops, so both equal each other bit for bit. The batch-size setters,
``get_last_grads`` and the per-leaf state surface of
``utils/tensor_fragment.py`` write in place, so a captured program sees
them.

The data pipeline (JAX ``engine.py:289-346``, ``:487``, ``:648-690``,
``:1038-1058``): ``training_data`` builds ``training_dataloader``
(``deepspeed_io``, ``runtime/dataloader.py``); ``curriculum_learning``
truncates each training batch's sequence to the scheduler's difficulty at
``global_steps + 1``; ``progressive_layer_drop`` and
``data_efficiency.data_routing.random_ltd`` hand the model each
microbatch's keep flags and token indices (``_model_kwargs``), drawn from
a ``torch.Generator`` on the engine's device seeded with the microbatch's
own seed, so a step program and the eager path draw the same ones and a
resumed run redraws them; the schedules advance at the step boundary.
Under ``fuse_grad_accum`` the flags and indices are inputs of the captured
step (its key carries their shapes); the schedules only grow, so a program
whose shape they left is released with its graph. With
``compile.multi_step`` the window's look-ahead is a ``PrefetchingLoader``
whose batches the engine places on the card ahead (``_place_ahead``);
checkpoints carry the data cursor of the first batch not yet trained
(``_data_cursor_state``) and the random-LTD schedule.

The unported switches raise ``NotImplementedError`` naming their ROADMAP
item. The engine runs on ``cuda`` unless the caller names another device,
and raises without a card.
"""

from __future__ import annotations

import copy
import math
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.checkpoint.jax_params import (
    flatten_tree,
    is_expert_leaf,
    jax_tree_to_tensors,
    tensors_to_jax_tree,
    unflatten_tree,
)
from deepspeed_tpu_torch.models.transformer import TransformerLM, _split_batch
from deepspeed_tpu_torch.ops.adagrad.cpu_adagrad import DeepSpeedCPUAdagrad
from deepspeed_tpu_torch.ops.adam.fused_adam import AdamState, AdamW, FusedAdam
from deepspeed_tpu_torch.ops.optimizer import DSOptimizer
from deepspeed_tpu_torch.moe.a2a import EXPERT_AXIS
from deepspeed_tpu_torch.parallel.mesh import topology_for
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.checkpoint_engine.async_snapshot import (
    AsyncCheckpointWriter,
    PinnedPool,
    host_snapshot,
)
from deepspeed_tpu_torch.runtime.checkpoint_engine.atomic import (
    CheckpointCorruptError,
    CheckpointLoadError,
    list_valid_tags,
    read_latest_marker,
    write_latest_marker,
)
from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_checkpoint_engine import TorchCheckpointEngine
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, unported_switches
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import CreateLossScaler, has_inf_or_nan
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_scheduler
from deepspeed_tpu_torch.runtime.zero.host_offload import HostOffloadStreamer
from deepspeed_tpu_torch.runtime.zero.offload_states import HostOffloadAdam, assemble_records
from deepspeed_tpu_torch.runtime.zero.overlap import (
    A2AStage,
    GradBuckets,
    activate,
    build_overlap_plan,
    gather_full,
    split_buckets,
)
from deepspeed_tpu_torch.runtime.zero.param_offload import ParamStreamEngine
from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartitioner, shard, shard_shape
from deepspeed_tpu_torch.utils import chaos
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.tensor_fragment import _flatten_with_paths

# "adam" is FusedAdam with decoupled decay, as in JAX (engine.py:118-125); the host-offload variant of
# cpu_adam is chosen by the ZeRO offload config
_OPTIMIZERS = {
    C.ADAM_OPTIMIZER: FusedAdam,
    C.ADAMW_OPTIMIZER: AdamW,
    C.FUSED_ADAM_OPTIMIZER: FusedAdam,
    C.CPU_ADAM_OPTIMIZER: FusedAdam,
    C.CPU_ADAGRAD_OPTIMIZER: DeepSpeedCPUAdagrad,
    C.ADAGRAD_OPTIMIZER: DeepSpeedCPUAdagrad,
}
_HOST_ADAM_OPTIMIZERS = (C.ADAM_OPTIMIZER, C.ADAMW_OPTIMIZER, C.FUSED_ADAM_OPTIMIZER, C.CPU_ADAM_OPTIMIZER)
_UNPORTED_OPTIMIZERS = {
    C.LAMB_OPTIMIZER: "X1", C.FUSED_LAMB_OPTIMIZER: "X1", C.SGD_OPTIMIZER: "X1",
    C.ONEBIT_ADAM_OPTIMIZER: "P1", C.ONEBIT_LAMB_OPTIMIZER: "P1", C.ZERO_ONE_ADAM_OPTIMIZER: "P1",
}
_ACC_DTYPES = {"fp32": torch.float32, "float32": torch.float32, "bf16": torch.bfloat16,
               "bfloat16": torch.bfloat16, "fp16": torch.float16, "float16": torch.float16}
_IGNORE_INDEX = -100  # models.transformer.cross_entropy_loss
_NO_WINDOW = object()
_UPDATE_CHUNK = 1 << 24  # elements of one piece of a leaf in the in-place update (elementwise: any cut is exact)


class _GlobalLoss(torch.autograd.Function):
    """The value of the global-batch loss, the gradient of this rank's
    share of it (``forward(local, value)`` returns ``value``; backward
    passes the gradient on to ``local`` unchanged)."""

    @staticmethod
    def forward(ctx, local, value):  # noqa: ARG004
        return value.clone()

    @staticmethod
    def backward(ctx, grad):  # noqa: ARG004
        return grad, None


class DeepSpeedEngine:
    def __init__(self, model: TransformerLM, config: Any = None, model_parameters: Any = None,
                 optimizer: Optional[DSOptimizer] = None, lr_scheduler=None, device=None,
                 attn_impl: Optional[str] = None, training_data=None, collate_fn=None):
        if not isinstance(model, TransformerLM):
            raise NotImplementedError("deepspeed_tpu_torch trains its own TransformerLM; other modules "
                                      "are not ported yet (ROADMAP X1)")
        self._config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config or {})
        _validate_multi_step_config(self._config)
        unported = unported_switches(self._config)
        if unported:
            raise NotImplementedError("not ported to deepspeed_tpu_torch yet: " + "; ".join(unported))
        self.topo = topology_for(self._config.mesh_config)
        self.dp = self.topo.get_data_parallel_world_size()
        self.dp_rank = comm.get_rank() if self.dp > 1 else 0
        self.ep = self.topo.axis_size(EXPERT_AXIS)
        # the expert-parallel a2a stage (JAX overlap.py:339-343, engine.py:1795-1806); a stage-3 plan carries it
        self._a2a = A2AStage().set_a2a(self.topo, getattr(model.config, "moe_quantized_a2a", None))
        self.module = model
        self.device = resolve_device(device)
        self.attn_impl = attn_impl
        self._config.resolve_batch_triad(self.dp)

        if self._config.bfloat16_enabled:
            self.compute_dtype = torch.bfloat16
        elif self._config.fp16_enabled:
            self.compute_dtype = torch.float16
        else:
            self.compute_dtype = torch.float32
        self.mixed_precision = self.compute_dtype != torch.float32
        self.dynamic_loss_scale = self._config.fp16_enabled and self._config.loss_scale == 0
        self.loss_scaler = CreateLossScaler(self.compute_dtype, self._config.loss_scale,
                                            self.dynamic_loss_scale, self._config.dynamic_loss_scale_args)
        self._acc_dtype = self._grad_accum_dtype()
        self.client_optimizer = optimizer
        self.optimizer = self._configure_optimizer(optimizer)
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)

        self.micro_steps = 0
        self.global_steps = 0
        self.global_samples = 0
        self.skipped_steps = 0
        self._training_mode = True
        self._in_forward = False
        self._last_grad_norm = None
        seed = self._config.seed if self._config.seed is not None else 42
        self._dropout_rng = np.random.default_rng(seed)  # one draw per microbatch seeds its masks

        if model_parameters is None:
            raise ValueError("model_parameters is required: weights enter the port as the JAX tree in numpy "
                             "(models.transformer.init_params draws one with the JAX init's distributions)")
        self._host_offload = None  # HostOffloadStreamer (streamed) or HostOffloadAdam (legacy)
        self._streamed_offload = False
        self._param_stream: Optional[ParamStreamEngine] = None
        if self._param_offload_enabled():
            self._init_param_stream(model_parameters)
        else:
            self._init_state(jax_tree_to_tensors(model.config, model_parameters, device=self.device,
                                                 dtype=torch.float32))
            if self._offload_enabled():
                self._init_host_offload()
        self._scale_state = self.loss_scaler.init_state(self.device)  # device scalars, updated in place
        self._lr_t = torch.zeros((), dtype=torch.float32, device=self.device)  # the step's lr as a device scalar

        self.checkpoint_engine = TorchCheckpointEngine(self._config)
        self._ckpt_writer: Optional[AsyncCheckpointWriter] = None  # built at the first async save
        self._pinned = PinnedPool()  # host buffers of device snapshots, reused across saves
        self._ckpt_metrics = {
            "saves": 0,
            "async_saves": 0,
            "last_stall_ms": 0.0,  # device->host snapshot time (async path)
            "total_stall_ms": 0.0,
            "last_save_s": 0.0,  # full persist wall time (staging + commit)
            "last_restore_s": 0.0,
        }
        self._init_data_pipeline(training_data, collate_fn)
        self._init_step_programs()
        log_dist(
            f"DeepSpeedEngine: zero_stage={self.zero_optimization_stage()} dtype={self.compute_dtype} "
            f"device={self.device} batch triad=({self.train_batch_size()},"
            f"{self.train_micro_batch_size_per_gpu()},{self.gradient_accumulation_steps()}) "
            f"params={self.num_parameters():,}",
            ranks=[0],
        )

    # --- the data pipeline (JAX engine.py:289-346, :487, :648-690) ------------
    def _init_data_pipeline(self, training_data, collate_fn) -> None:
        """The curriculum scheduler, progressive layer drop, the random-LTD
        schedule and the engine dataloader, with JAX's refusals."""
        from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
        from deepspeed_tpu_torch.runtime.data_pipeline.data_routing import RandomLTDScheduler
        from deepspeed_tpu_torch.runtime.progressive_layer_drop import ProgressiveLayerDrop

        cfg = self._config
        cl_cfg = cfg.curriculum_learning_config
        self.curriculum_scheduler = CurriculumScheduler(cl_cfg) if cl_cfg and cl_cfg.get("enabled", False) else None
        self.progressive_layer_drop = None
        if cfg.pld_config.enabled:
            self.progressive_layer_drop = ProgressiveLayerDrop(theta=cfg.pld_config.theta, gamma=cfg.pld_config.gamma)
        self.random_ltd_scheduler = None
        self._ltd_layer_num = 0
        de_cfg = cfg.data_efficiency_config or {}
        routing = de_cfg.get("data_routing", {})
        ltd_cfg = routing.get("random_ltd", {})
        if de_cfg.get("enabled") and routing.get("enabled") and ltd_cfg.get("enabled"):
            sched = ltd_cfg.get("random_ltd_schedule", {})
            if "min_value" not in sched or "max_value" not in sched:
                raise ValueError("random_ltd.random_ltd_schedule needs min_value and max_value (kept-token counts)")
            scfg = sched.get("schedule_config", {})
            self.random_ltd_scheduler = RandomLTDScheduler(
                start_token_num=int(sched["min_value"]), max_token_num=int(sched["max_value"]),
                total_steps=int(scfg.get("require_steps", 1000)), step_size=int(scfg.get("seq_per_step", 16)))
            self._ltd_layer_num = int(ltd_cfg.get("random_ltd_layer_num", 1))
            if self._ltd_layer_num < 1:
                raise ValueError(f"random_ltd_layer_num={self._ltd_layer_num} must be >= 1 (0 would silently disable "
                                 "the feature)")
            if cfg.pld_config.enabled:
                raise ValueError("progressive_layer_drop and random_ltd cannot be combined")
        if self._param_stream is not None and (self.progressive_layer_drop is not None
                                               or self.random_ltd_scheduler is not None):
            raise NotImplementedError("progressive_layer_drop / random_ltd are unsupported on the param-offload path "
                                      "(the layer streamer replays a fixed layer sequence)")
        self.training_data = training_data
        self.collate_fn = collate_fn
        self.training_dataloader = self.deepspeed_io(training_data) if training_data is not None else None
        self._last_kwargs: Dict[str, Any] = {}  # the model kwargs of the last training microbatch

    def deepspeed_io(self, dataset, batch_size=None, route=None, pin_memory=True, data_sampler=None,  # noqa: ARG002
                     collate_fn=None, num_local_io_workers=None):
        """The engine dataloader over ``dataset`` (JAX ``engine.py:761``):
        global micro batches of ``train_micro_batch_size_per_gpu × dp`` rows
        as numpy, each rank taking its rows when the engine places them.
        ``route``, ``pin_memory``, ``data_sampler`` and
        ``num_local_io_workers`` are accepted and not used, as in JAX (a
        sampled order is the dataset's: index it with the sampler's
        stream)."""
        from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader

        return DeepSpeedDataLoader(dataset, batch_size=batch_size or self.train_micro_batch_size_per_gpu() * self.dp,
                                   collate_fn=collate_fn or self.collate_fn)

    def set_data_post_process_func(self, post_process_func) -> None:
        """A per-batch transform on the engine dataloader (JAX
        ``engine.py:648``)."""
        if self.training_dataloader is None:
            raise ValueError("set_data_post_process_func needs an engine-owned dataloader: pass training_data to "
                             "initialize() (a silently dropped hook would train on unprocessed batches)")
        self.training_dataloader.post_process_func = post_process_func

    def set_custom_curriculum_learning_schedule(self, schedule_func_dict) -> None:
        """Custom curriculum schedule functions (JAX ``engine.py:659``): a
        bare callable drives the engine's (seqlen) scheduler; a
        ``{metric_name: fn}`` dict routes ``seqlen`` / ``default`` to the
        engine's scheduler and any other metric to the curriculum sampler's."""
        if callable(schedule_func_dict):
            if self.curriculum_scheduler is None:
                raise ValueError("curriculum learning is not enabled")
            self.curriculum_scheduler.set_custom_get_difficulty(schedule_func_dict)
            return
        if not isinstance(schedule_func_dict, dict):
            raise TypeError(f"expected a callable or a {{metric_name: schedule_fn}} dict, got "
                            f"{type(schedule_func_dict).__name__}")
        sampler = getattr(self.training_dataloader, "data_sampler", None)
        sampler_sched = getattr(sampler, "scheduler", None)
        for metric, fn in schedule_func_dict.items():
            if not callable(fn):
                raise TypeError(f"schedule for metric {metric!r} is not callable")
            if metric in ("seqlen", "default") and self.curriculum_scheduler is not None:
                self.curriculum_scheduler.set_custom_get_difficulty(fn)
            elif sampler_sched is not None:
                sampler_sched.set_custom_get_difficulty(fn)
            elif self.curriculum_scheduler is not None:
                self.curriculum_scheduler.set_custom_get_difficulty(fn)
            else:
                raise ValueError(f"no curriculum scheduler to receive metric {metric!r} (enable curriculum_learning "
                                 "or use a curriculum sampler)")

    def _curriculum(self, batch):
        """A training batch truncated to the curriculum's difficulty at the
        coming step (JAX ``engine.py:1866-1868``)."""
        if self.curriculum_scheduler is None:
            return batch
        return _truncate_seq(batch, self.curriculum_scheduler.update_difficulty(self.global_steps + 1))

    def _model_kwargs(self, B: int, T: int, seed: int, host_keep: bool) -> Dict[str, Any]:
        """One microbatch's ``pld_keep`` / ``ltd_idx`` (JAX ``_model_kwargs``,
        ``engine.py:1038``): drawn from a generator on the engine's device
        seeded with the microbatch's seed. PLD keeps layer ``i`` with
        probability ``1 - (i + 1) / L · (1 - θ)``; ``host_keep`` reads the
        flags on the host (the eager path skips a dropped layer), else they
        stay a device tensor (a step program's input). LTD draws its
        indices only when the kept count is below ``T``."""
        kwargs: Dict[str, Any] = {}
        if self.progressive_layer_drop is None and self.random_ltd_scheduler is None:
            return kwargs
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        if self.progressive_layer_drop is not None:
            L = self.module.config.num_layers
            theta = float(self.progressive_layer_drop.get_theta())
            keep_p = 1.0 - (torch.arange(L, dtype=torch.float32, device=self.device) + 1.0) / L * (1.0 - theta)
            keep = torch.rand(L, generator=gen, device=self.device) < keep_p
            kwargs["pld_keep"] = keep.tolist() if host_keep else keep
        if self.random_ltd_scheduler is not None:
            from deepspeed_tpu_torch.runtime.data_pipeline.data_routing import sample_layer_token_indices

            kept = min(self.random_ltd_scheduler.current, T)
            if kept < T:
                kwargs["ltd_idx"] = sample_layer_token_indices(gen, self._ltd_layer_num, B, T, kept)
        return kwargs

    def _data_cursor_state(self):
        """The data cursor a checkpoint carries (JAX ``engine.py:3218``):
        the look-ahead's snapshot before its first untrained batch when it
        reads the engine dataloader, else the dataloader's own cursor."""
        pl = self._active_prefetcher
        if pl is not None and self.training_dataloader is not None and pl._state_source is self.training_dataloader:
            return pl.state_dict()
        if self.training_dataloader is not None and hasattr(self.training_dataloader, "state_dict"):
            return self.training_dataloader.state_dict()
        return None

    def _place_ahead(self, batch):
        """The look-ahead's placement: tokens and labels as int64, on the
        card through pinned host buffers and ``non_blocking`` copies on a
        side stream, which the current stream waits for by an event (and
        whose blocks it records, so the allocator keeps them until it has
        used them); a CPU engine keeps them on the host."""
        tokens, labels = _split_batch(batch)
        host = [None if x is None else _as_long(x) for x in (tokens, labels)]
        if self.device.type != "cuda":
            return tuple(host) if labels is not None else host[0]
        cur = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device, "h2d")
        placed = []
        with torch.cuda.stream(side):
            for h in host:
                if h is None:
                    placed.append(None)
                    continue
                h = h if h.device.type != "cpu" or h.is_pinned() else h.pin_memory()
                placed.append(h.to(self.device, non_blocking=True))
        done = torch.cuda.Event()
        done.record(side)
        cur.wait_event(done)
        for t in placed:
            if t is not None:
                t.record_stream(cur)
        return tuple(placed) if labels is not None else placed[0]

    # --- configuration accessors ------------------------------------------
    def train_batch_size(self) -> int:
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self._config.gradient_accumulation_steps

    def zero_optimization_stage(self) -> int:
        return self._config.zero_optimization_stage

    def zero_optimization(self) -> bool:
        return self._config.zero_enabled

    def fp16_enabled(self) -> bool:
        return self._config.fp16_enabled

    def bfloat16_enabled(self) -> bool:
        return self._config.bfloat16_enabled

    def gradient_clipping(self) -> float:
        return self._config.gradient_clipping

    def data_parallel_world_size(self) -> int:
        return self.dp

    def set_train_batch_size(self, train_batch_size: int) -> None:
        """Resize the global batch by changing the number of microbatches
        (gas), keeping the micro batch (JAX ``engine.py:509-575``). The
        step programs depend on gas, so every captured graph is dropped and
        its memory pool released before the next step captures anew."""
        micro, dp = self.train_micro_batch_size_per_gpu(), max(1, self.dp)
        if train_batch_size % (micro * dp) != 0:
            raise ValueError(f"Train batch size must be divisible by micro-batch * data parallelism ({micro} * {dp})")
        new_gas = train_batch_size // (micro * dp)
        if new_gas < 1:
            raise ValueError(f"train_batch_size={train_batch_size} is below one micro-batch per data shard "
                             f"({micro} * {dp})")
        if new_gas == self.gradient_accumulation_steps():
            self._config.train_batch_size = train_batch_size
            return
        self._check_resize_allowed()
        cc = self._config.compile_config
        if cc.multi_step.enable and new_gas > 1 and not cc.fuse_grad_accum:
            raise ValueError(f"set_train_batch_size: gradient_accumulation_steps={new_gas} with compile.multi_step "
                             "enabled requires compile.fuse_grad_accum (the window scans the fused grad-accum body)")
        self._config.train_batch_size = train_batch_size
        self._config.gradient_accumulation_steps = new_gas
        # re-base the counter: boundaries are micro_steps % gas
        self.micro_steps = 0
        self.invalidate_compiled_step()
        armed = self._window_armed
        self._arm_step_programs(new_gas)
        if armed != self._window_armed:
            self._active_prefetcher = self._prefetch_key = None
        log_dist(f"set_train_batch_size: train_batch={train_batch_size} gas={new_gas}", ranks=[0])

    def _check_resize_allowed(self) -> None:
        """JAX ``engine.py:577``: no resize mid-step, mid-window, inside an
        accumulation window, or on the offload paths."""
        if self._in_forward:
            raise RuntimeError("cannot resize the batch mid-step: finish backward()+step() first")
        if self._window_stash:
            raise RuntimeError("cannot resize the batch mid-window: the multi-step window's remaining train_batch "
                               "calls must commit first")
        if self.micro_steps % self.gradient_accumulation_steps() != 0:
            raise RuntimeError("cannot resize the batch inside an accumulation window: step() must complete the "
                               "current window first")
        if self._param_stream is not None or self._host_offload is not None:
            raise NotImplementedError("batch resizing is unsupported on the offload paths")

    def set_train_micro_batch_size(self, micro_batch_size: int) -> None:
        """Change the micro batch, keeping gas (JAX ``engine.py:602``). The
        step programs are keyed by their batch shapes, so a new micro batch
        captures its own; the old ones are dropped with their pools."""
        if micro_batch_size < 1:
            raise ValueError(f"micro_batch_size={micro_batch_size} must be >= 1")
        self._check_resize_allowed()
        gas, dp = self.gradient_accumulation_steps(), max(1, self.dp)
        self._config.train_batch_size = micro_batch_size * gas * dp
        self._config.train_micro_batch_size_per_gpu = micro_batch_size
        self.invalidate_compiled_step()

    # --- one leaf's fp32 state, whole (utils/tensor_fragment.py's surface) -------------
    def _leaf_state(self, name: str, field: str) -> Optional[np.ndarray]:
        """The whole fp32 ``field`` (``master`` or an optimizer state such as
        ``exp_avg``) of leaf ``name`` as numpy, on every rank (the slices
        gathered at dp > 1), wherever the engine keeps it: on the card, in
        the streamed or legacy host offload, or in the layer stream. None
        for an unknown leaf or field."""
        if name not in self._shapes:
            return None
        shape = self._shapes[name]
        if self._param_stream is not None:
            return self._param_stream.leaf_state(name, field)
        if self._host_offload is not None:
            if field not in ("master", "exp_avg", "exp_avg_sq"):
                return None
            ho = self._host_offload
            if self._streamed_offload:
                ho.drain_writes()
                if field == "master" and not self.mixed_precision:  # fp32: the parameters are the master
                    return _host_copy(self._gather_tree({name: self._params[name].detach()},
                                                        {name: self._pdim[name]})[name], shape)
                t = ho.leaf_tensor(name, field)
            else:
                t = torch.from_numpy(ho.leaf_state(name)[field]).reshape(self._slice_shape(name))
            return _host_copy(self._gather_host({name: t})[name], shape)
        if field == "master":
            t = self._master[name]
        else:
            tree = getattr(self._opt_state, field, None)
            if not isinstance(tree, dict):
                return None
            t = tree[name]
        return _host_copy(self._gather_tree({name: t.detach()}, {name: self._mdim[name]})[name], shape)

    @torch.no_grad()
    def _set_leaf_state(self, name: str, field: str, value) -> bool:
        """Write the whole fp32 ``field`` of leaf ``name`` (every rank passes
        the whole value and keeps its slice), in place: a captured step
        program's next replay reads it. Writing ``master`` refreshes the
        compute-dtype copy. False for an unknown leaf or field."""
        if name not in self._shapes:
            return False
        full = torch.as_tensor(np.asarray(value, np.float32)).reshape(self._shapes[name])
        if self._param_stream is not None:
            return self._param_stream.set_leaf_state(name, field, full.numpy())
        r, W = self.dp_rank, self.dp
        mine = self._own(name, full, self._mdim[name])
        if self._host_offload is not None:
            if field not in ("master", "exp_avg", "exp_avg_sq"):
                return False
            ho = self._host_offload
            if self._streamed_offload:
                ho.drain_writes()
                t = ho.leaf_tensor(name, field)
                t.copy_(mine.reshape(t.shape))
            else:
                ho.set_leaf_state(name, field, mine.numpy())
        elif field == "master":
            self._master[name].copy_(mine)
        else:
            tree = getattr(self._opt_state, field, None)
            if not isinstance(tree, dict):
                return False
            tree[name].copy_(mine)
        if field == "master":
            p = self._params[name]
            if self._master is None or p is not self._master[name]:
                p.copy_(self._own(name, full, self._pdim[name]))
        return True

    def _slice_shape(self, name: str):
        return self._own(name, torch.empty(self._shapes[name], device="meta"), self._mdim[name]).shape

    def get_last_grads(self):
        """The gradient tree of the latest training microbatch, fp32 numpy
        (JAX ``engine.py:3755``, the surface behind ``safe_get_full_grad``).
        On the accumulating path it is the live accumulator; where the last
        step ran as a step program (and at gas = 1, where JAX always fuses)
        the gradients died inside it, so they are recomputed on the stashed
        microbatch with its dropout seed and loss scale, at the current
        (post-update) parameters, as JAX documents. Under
        ``offload_param``, the layer stream's ``debug_grads()``."""
        if self._param_stream is not None:
            return self._param_stream.debug_grads()
        gas1 = self.gradient_accumulation_steps() == 1 and self._host_offload is None
        if not gas1 and not self._last_fused:
            return tensors_to_jax_tree({k: g.detach().float().clone()
                                        for k, g in self._gather_tree(self._grad_acc, self._gdim).items()})
        if self._last_batch is None:
            return None
        tokens, labels, seed = self._last_batch
        params = {k: p.detach().clone().requires_grad_(True) for k, p in self._full_params().items()}
        tokens = tokens.to(self.device)
        labels = labels.to(self.device)
        loss = self.module.apply(unflatten_tree(params), (tokens, labels), dropout_seed=seed, train=True,
                                 attn_impl=self.attn_impl, **self._last_kwargs)
        (loss.float() * self._last_fwd_scale).backward()
        return tensors_to_jax_tree({k: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
                                    for k, p in params.items()})

    @property
    def loss_scale(self) -> float:
        return float(self._scale_state.scale)

    def get_lr(self):
        return self.optimizer.get_lr()

    def get_global_grad_norm(self) -> Optional[float]:
        return None if self._last_grad_norm is None else float(self._last_grad_norm)

    def is_gradient_accumulation_boundary(self) -> bool:
        return (self.micro_steps + 1) % self.gradient_accumulation_steps() == 0

    def train(self, mode: bool = True):
        if not mode and self._window_stash:
            raise RuntimeError(
                "eval() called with a multi-step window mid-flight: the window already advanced the model "
                f"state but {len(self._window_stash)} step(s) are uncommitted; finish the window's train_batch "
                "calls before switching to eval")
        self._training_mode = mode
        return self

    def eval(self):
        return self.train(False)

    def num_parameters(self) -> int:
        return sum(math.prod(s) for s in self._shapes.values())

    def get_params(self):
        """The compute-dtype tree as numpy (bf16 widened to fp32 exactly),
        whole on every rank (under ``offload_param``, from the host store)."""
        if self._param_stream is not None:
            return tensors_to_jax_tree(self._param_stream.gathered_params())
        return tensors_to_jax_tree(self._full_params())

    def get_master_params(self):
        """The fp32 master tree as numpy, whole on every rank (the host
        master on the offload paths)."""
        if self._param_stream is not None:
            return tensors_to_jax_tree(self._param_stream.master_params())
        return tensors_to_jax_tree(self._full_master())

    def get_param_treedef(self):
        """The nesting of ``get_params()`` (dicts, None at the leaves),
        without gathering it (JAX ``engine.py:3747``)."""
        return unflatten_tree({k: None for k in self._shapes})

    def offload_stream_stats(self) -> Optional[Dict[str, Any]]:
        """The streamed offload path's transfer accounting
        (``HostOffloadStreamer.stream_stats``); None on every other path
        (JAX ``engine.py:3206``)."""
        if not self._streamed_offload:
            return None
        return self._host_offload.stream_stats()

    @torch.no_grad()
    def set_params(self, tree, src_rank: Optional[int] = None) -> None:
        """Adopt a whole parameter tree (numpy, nested or flat paths) as the
        new weights: the fp32 master and the compute store are refreshed,
        each rank keeping its slices, and the optimizer moments are kept
        (JAX ``engine.py:3798``). With ``src_rank`` the tree of that rank
        is broadcast to every rank first."""
        # offload_param never holds the whole tree on the card
        full = jax_tree_to_tensors(self.module.config, tree, device="cpu" if self._param_stream is not None
                                   else self.device, dtype=torch.float32)
        if src_rank is not None and self.dp > 1:
            for t in full.values():
                comm.broadcast(t, src=src_rank)
        r, W = self.dp_rank, self.dp
        if self._param_stream is not None:
            self._param_stream.set_master(full)
            return
        if self._host_offload is not None:
            self._host_offload.set_master_leaves({k: self._own(k, full[k], self._mdim[k]) for k in self._shapes})
            for k, p in self._params.items():
                p.copy_(self._own(k, full[k], self._pdim[k]))
            return
        for k, m in self._master.items():
            m.copy_(self._own(k, full[k], self._mdim[k]))
            p = self._params[k]
            if p is not m:
                p.copy_(self._own(k, full[k], self._pdim[k]))

    # --- the state and its slices ------------------------------------------
    @torch.no_grad()
    def _init_state(self, full: Dict[str, torch.Tensor]) -> None:
        """Master, compute store, optimizer state and accumulators, each
        leaf this rank's slice as the ZeRO stage places it (whole at one
        rank: the master is ``full`` itself, and in fp32 the compute store
        is the master)."""
        zc = self._config.zero_config
        self._shapes = {k: tuple(t.shape) for k, t in full.items()}
        # an expert leaf holds this rank's experts and no ZeRO slice (JAX partition.py:83): dim 1 of [L, E, ...]
        self._edim = {k: 1 for k in self._shapes if is_expert_leaf(k)} if self.ep > 1 else {}
        part = ZeroPartitioner(zc, self.topo, expert=self._edim)
        self._pdim = part.dims(part.param_specs(self._shapes))
        self._mdim = part.dims(part.master_specs(self._shapes))
        self._gdim = part.dims(part.grad_accum_specs(self._shapes))
        r, W = self.dp_rank, self.dp
        full = {k: self._eslice(k, t).contiguous() for k, t in full.items()}
        self._master = {k: t if self._mdim[k] is None else shard(t, self._mdim[k], r, W).clone()
                        for k, t in full.items()}
        self._params = {}
        keep = self.module.keep_fp32_params(unflatten_tree(self._shapes)) \
            if hasattr(self.module, "keep_fp32_params") else None
        keep32 = {k for k, v in flatten_tree(keep).items() if v} if keep is not None else set()
        for k, t in full.items():
            dt = torch.float32 if k in keep32 else self.compute_dtype  # an MoE router stays fp32 (JAX keep_fp32)
            if (dt == torch.float32) and self._pdim[k] == self._mdim[k]:
                self._params[k] = self._master[k].requires_grad_(True)
            elif self._pdim[k] is None:
                self._params[k] = t.to(dt).requires_grad_(True)
            else:
                self._params[k] = shard(t, self._pdim[k], r, W).to(dt).clone().requires_grad_(True)
        self._param_tree = unflatten_tree(self._params)
        # the offload paths keep the moments on the host
        self._opt_state = None if self._offload_enabled() else self.optimizer.init_state(self._master)
        if self._opt_state is not None and getattr(self.optimizer, "capturable", False):
            # the step count lives on the device, as JAX's int32 scalar: the captured step advances it
            self._opt_state = self._opt_state._replace(step=torch.zeros((), dtype=torch.int32, device=self.device))
        self._grad_acc = {k: torch.zeros(shard_shape(tuple(full[k].shape), self._gdim[k], W), dtype=self._acc_dtype,
                                         device=self.device) for k in self._params}
        self._plan = build_overlap_plan(zc, self._params, self._pdim, self.module.config.num_layers,
                                        self._acc_dtype, topo=self.topo,
                                        moe_quantized_a2a=self._a2a.a2a_quantized) if W > 1 else None
        # stage >= 2 with overlap_comm: each gradient joins a reduce bucket as backward accumulates it
        self._buckets: Optional[GradBuckets] = None
        self._eager_buckets = W > 1 and self.zero_optimization_stage() >= 2 and zc.overlap_comm and zc.reduce_scatter
        if self._eager_buckets:
            for k, p in self._params.items():
                if (self._plan is None or self._pdim[k] is None) and k not in self._edim:
                    p.register_post_accumulate_grad_hook(self._grad_ready(k))

    # --- expert leaves (an expert mesh axis) ---------------------------------
    def _eslice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's experts of a whole leaf (the leaf itself when it is
        not an expert leaf, or without an expert axis)."""
        d = self._edim.get(name)
        return t if d is None else shard(t, d, self.topo.expert_rank, self.ep)

    def _own(self, name: str, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's slice of a whole leaf: its experts, then its ZeRO
        block along ``dim``."""
        return shard(self._eslice(name, t), dim, self.dp_rank, self.dp)

    def _grad_ready(self, name: str):
        def hook(p):
            if self._buckets is not None:
                self._buckets.add(name, p.grad.to(self._acc_dtype))
                p.grad = None
        return hook

    def _gather_tree(self, tensors: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]]
                     ) -> Dict[str, torch.Tensor]:
        """``tensors`` with every sliced leaf gathered whole (one all-gather
        a bucket of ``allgather_bucket_size`` elements and one dtype)."""
        if self.dp == 1:
            return tensors
        out = {k: t.detach() for k, t in tensors.items()}
        by_dtype: Dict[torch.dtype, list] = {}
        for k, t in tensors.items():
            if dims[k] is not None:
                by_dtype.setdefault(t.dtype, []).append(k)
        cap = self._config.zero_config.allgather_bucket_size
        for names in by_dtype.values():
            for bucket in split_buckets([tensors[k].numel() for k in names], cap):
                keys = [names[i] for i in bucket]
                out.update(zip(keys, gather_full([tensors[k] for k in keys], [dims[k] for k in keys])))
        experts = [k for k in tensors if k in self._edim]
        for k in experts:  # the expert shards, gathered over the expert group
            out[k] = gather_full([out[k]], [self._edim[k]], self.topo.expert_group)[0]
        return out

    def _full_params(self) -> Dict[str, torch.Tensor]:
        return self._gather_tree(self._params, self._pdim)

    def _full_master(self) -> Dict[str, torch.Tensor]:
        if self._host_offload is not None:
            return self._gather_host(self._host_offload.master_leaves())
        return self._gather_tree(self._master, self._mdim)

    def _gather_host(self, slices: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole leaves from this rank's host slices (through the card at
        dp > 1, where the collectives run)."""
        if self.dp == 1:
            return slices
        return self._gather_tree({k: t.to(self.device) for k, t in slices.items()}, self._mdim)

    def _full_opt_state(self):
        st = self._opt_state
        return type(st)(**{f: self._gather_tree(v, self._mdim) if isinstance(v, dict) else v
                           for f, v in st._asdict().items()})

    @torch.no_grad()
    def _refresh_params(self) -> None:
        """The compute store from the master: a local cast where both hold
        the same slice, an all-gather of the cast slices where the store is
        whole and the master sliced."""
        gather = []
        for k, m in self._master.items():
            p = self._params[k]
            if p is m:
                continue
            if self._pdim[k] == self._mdim[k]:
                p.copy_(m)
            else:
                gather.append(k)
        if gather:
            full = self._gather_tree({k: self._master[k].to(self._params[k].dtype) for k in gather},
                                     {k: self._mdim[k] for k in gather})
            for k in gather:
                self._params[k].copy_(full[k])

    # --- offload (JAX engine.py:2207-2304) ----------------------------------
    @staticmethod
    def _offload_requested(off) -> bool:
        return off is not None and str(off.device.value) != "none"

    def _offload_enabled(self) -> bool:
        requested = self._offload_requested(self._config.zero_config.offload_optimizer)
        if requested and self._config.zero_optimization_stage < 1:
            raise ValueError("offload_optimizer requires ZeRO stage >= 1 (stage 0 keeps full optimizer state on "
                             "device; set zero_optimization.stage)")
        return requested

    def _param_offload_enabled(self) -> bool:
        requested = self._offload_requested(self._config.zero_config.offload_param)
        if requested and self._config.zero_optimization_stage != 3:
            raise ValueError("offload_param requires ZeRO stage 3 (set zero_optimization.stage=3); got stage "
                             f"{self._config.zero_optimization_stage}")
        return requested

    def _validate_host_adam(self, feature: str) -> None:
        """Both offload paths run the host Adam/AdamW (or, streamed, the
        engine's Adam on host-resident state): the configured optimizer must
        be an Adam variant and there can be no client optimizer."""
        opt_cfg = self._config.optimizer_config
        opt_type = opt_cfg.type.lower() if opt_cfg is not None and opt_cfg.type else C.ADAM_OPTIMIZER
        if opt_type not in _HOST_ADAM_OPTIMIZERS:
            raise ValueError(f"{feature} runs the host Adam/AdamW (DeepSpeedCPUAdam analog); configured optimizer "
                             f"{opt_type!r} is unsupported — use an adam variant or disable {feature}")
        if self.client_optimizer is not None:
            raise ValueError(f"{feature} is incompatible with a client optimizer: the host offload path owns the "
                             "update rule (Adam/AdamW)")

    def _host_adam_params(self) -> Dict[str, Any]:
        opt_cfg = self._config.optimizer_config
        return dict(opt_cfg.params) if opt_cfg is not None else {}

    def _slice_index(self, name: str) -> list:
        """Where this rank's master slice of ``name`` sits in the whole leaf,
        as JAX's shard records say it: ``(start, stop)`` a dim, None for a
        whole dim."""
        idx = [(None, None)] * len(self._shapes[name])
        d = self._mdim[name]
        if d is not None and self.dp > 1:
            n = self._shapes[name][d] // self.dp
            idx[d] = (self.dp_rank * n, (self.dp_rank + 1) * n)
        e = self._edim.get(name)
        if e is not None:  # an expert leaf: this rank's experts
            n = self._shapes[name][e] // self.ep
            idx[e] = (self.topo.expert_rank * n, (self.topo.expert_rank + 1) * n)
        return idx

    def _init_host_offload(self) -> None:
        """``offload_optimizer``: the streamed path (``pipeline_read`` or
        ``pipeline_write`` with ``device=cpu``) or the legacy host Adam; the
        card's master is freed either way (the fp32 parameters stay)."""
        offcfg = self._config.zero_config.offload_optimizer
        self._validate_host_adam("offload_optimizer")
        names = sorted(self._master)  # JAX's tree order: the buckets' and the checkpoint records'
        master = {k: self._master[k] for k in names}
        if offcfg.pipeline and offcfg.device.value == "cpu":
            self._host_offload = HostOffloadStreamer(master, offcfg, mixed_precision=self.mixed_precision,
                                                     device=self.device)
            self._streamed_offload = True
        else:
            p = self._host_adam_params()
            self._host_offload = HostOffloadAdam(
                master, {k: self._slice_index(k) for k in names}, {k: self._params[k].dtype for k in names},
                offcfg, self.device, aio_param_dict=self._config._param_dict,
                betas=tuple(p.get("betas", (0.9, 0.999))), eps=p.get("eps", 1e-8),
                weight_decay=p.get("weight_decay", 0.0), adamw_mode=p.get("adam_w_mode", True), rank=self.dp_rank)
        del master
        self._master = None

    def _init_param_stream(self, model_parameters) -> None:
        """``offload_param``: the layers live on the host or on disk and
        stream through the card (``runtime/zero/param_offload.py``); the
        tree never lands on the card whole. Pure data parallelism only: the
        layers stay whole on every rank."""
        self._validate_host_adam("offload_param")
        from deepspeed_tpu_torch.checkpoint.jax_params import _checked_flat

        flat = _checked_flat(self.module.config, model_parameters)
        self._shapes = {k: tuple(np.shape(v)) for k, v in flat.items()}
        self._params = None
        self._master = None
        self._opt_state = None
        self._plan = None
        self._grad_acc = {}
        self._param_stream = ParamStreamEngine(
            self.module, flat, self._config.zero_config, self._host_adam_params(), self.compute_dtype, self.device,
            fp16=self._config.fp16_enabled, act_offload=self._config.activation_checkpointing_config.cpu_checkpointing,
            attn_impl=self.attn_impl, dp=self.dp, dp_rank=self.dp_rank)
        log_dist(f"Initialized param-offload state: {self._param_stream.num_parameters():,} parameters", ranks=[0])

    @torch.no_grad()
    def _install_slices(self, new: Dict[str, torch.Tensor]) -> None:
        """The compute store from new master slices (``_refresh_params``'s
        ops): a local copy where the store holds the same slice, an
        all-gather of the cast slices where it is whole."""
        gather = []
        for k, m in new.items():
            if self._pdim[k] == self._mdim[k]:
                self._params[k].copy_(m)
            else:
                gather.append(k)
        if gather:
            full = self._gather_tree({k: new[k].to(self._params[k].dtype) for k in gather},
                                     {k: self._mdim[k] for k in gather})
            for k in gather:
                self._params[k].copy_(full[k])

    @torch.no_grad()
    def _take_offload_step(self, lr: float) -> bool:
        """The legacy host-Adam step (JAX ``_take_offload_step``): the card
        computes the norm of the raw accumulators and the overflow flag,
        the host Adam updates this rank's slices, the new parameters come
        back. Returns the overflow flag."""
        gas, dp, r, stage = self.gradient_accumulation_steps(), self.dp, self.dp_rank, self.zero_optimization_stage()
        if dp > 1 and stage <= 1:
            self._all_reduce_accum()
        elif dp > 1 and self._edim:
            self._all_reduce_accum(experts_only=True)
        inv = 1.0 / (float(self._scale_state.scale) * gas * dp)
        acc = self._grad_acc
        if dp > 1 and (stage >= 2 or self._edim):
            first = self.topo.expert_data_rank == 0  # an expert shard counted once (see _grad_stats)
            parts = [torch.sum(torch.square(g.float())) for k, g in acc.items()
                     if (first if k in self._edim else self._gdim[k] is not None or r == 0)]
            sq = comm.all_reduce(torch.stack(parts).sum() if parts else torch.zeros((), device=self.device))
        else:
            sq = torch.stack([torch.sum(torch.square(g.float())) for g in acc.values()]).sum()
        grad_norm = torch.sqrt(sq) * inv
        overflow = False
        if self._config.fp16_enabled:
            flag = has_inf_or_nan(acc.values())
            if dp > 1:
                flag = comm.all_reduce(flag.float(), op=comm.ReduceOp.MAX)
            overflow = bool(flag)
        if not overflow:
            clip = self._config.gradient_clipping
            norm = float(grad_norm)
            clip_coef = min(1.0, clip / (norm + 1e-6)) if clip > 0 else 1.0
            grads = {k: shard(acc[k], self._mdim[k], r, dp) if self._gdim[k] is None else acc[k]
                     for k in self._host_offload.names}
            self._install_slices(self._host_offload.step(grads, lr, inv, clip_coef))
        self.loss_scaler.update_(self._scale_state, overflow)
        for g in acc.values():
            g.zero_()
        self._last_grad_norm = grad_norm
        return overflow

    @torch.no_grad()
    def _take_streamed_offload_step(self, lr: float) -> bool:
        """The streamed step (JAX ``_take_streamed_offload_step``): buckets 0
        and 1 upload behind the tail of backward; the norm, clip
        coefficient and overflow flag come from every gradient first, with
        ``_update_from_grads``'s ops; then each bucket's leaves take that
        function's update (``optimizer.apply`` on the bucket), bucket
        ``i+2`` uploads while bucket ``i`` updates, and bucket ``i`` writes
        back while ``i+1`` updates. An fp16 overflow drops the uploads and
        writes nothing back. Returns the overflow flag."""
        ho = self._host_offload
        nb = ho.num_buckets
        ho.h2d_bucket(0)
        if nb > 1:
            ho.h2d_bucket(1)
        dp, r = self.dp, self.dp_rank
        inv = self._unscale_inv()
        acc = self._grad_acc
        # the unscaled gradients leaf by leaf, never all at once (the same ops as the on-device update)
        flag, grad_norm, coef = self._grad_stats(lambda: ((k, g.float() * inv) for k, g in acc.items()))
        overflow = bool(flag)  # this path's host loop branches on it
        if overflow:
            ho.discard_staged()
        else:
            for bi in range(nb):
                names = ho.bucket_names(bi)
                masters, ms, vs = ho.take_staged(bi)
                grads = {}
                for k in names:
                    g = acc[k].float() * inv
                    if coef is not None:
                        g = g * coef
                    grads[k] = shard(g, self._mdim[k], r, dp) if self._gdim[k] is None else g
                if masters is not None:
                    master = dict(zip(names, masters))
                else:  # fp32: the parameters hold the master (its slice, where they are whole)
                    master = {k: shard(self._params[k].detach(), self._mdim[k] if self._pdim[k] is None else None, r, dp)
                              for k in names}
                state = AdamState(step=ho.step_count, exp_avg=dict(zip(names, ms)), exp_avg_sq=dict(zip(names, vs)))
                new_master, new_state = self.optimizer.apply(grads, state, master, lr)
                self._install_slices(new_master)
                if bi + 2 < nb:
                    ho.h2d_bucket(bi + 2)
                chaos.point("train.mid_offload_stream", bucket=bi)
                ho.d2h_bucket(bi, [new_master[k] for k in names], [new_state.exp_avg[k] for k in names],
                              [new_state.exp_avg_sq[k] for k in names])
                ho.materialize_writes(keep=1)
            ho.step_count += 1
        ho.note_step()
        self.loss_scaler.update_(self._scale_state, overflow)
        for g in acc.values():
            g.zero_()
        self._last_grad_norm = grad_norm
        return overflow

    # --- wiring ------------------------------------------------------------
    def _grad_accum_dtype(self) -> torch.dtype:
        name = self._config.data_types_config.grad_accum_dtype
        if name is None:
            return torch.float32
        if str(name) not in _ACC_DTYPES:
            raise ValueError(f"data_types.grad_accum_dtype={name!r} is not one of fp32/bf16/fp16")
        dtype = _ACC_DTYPES[str(name)]
        if dtype == torch.float16 and not self._config.fp16_enabled:
            raise ValueError("grad_accum_dtype=fp16 requires fp16.enabled (overflow detection covers "
                             "fp16 accumulation only on the fp16 path)")
        return dtype

    def _configure_optimizer(self, client) -> DSOptimizer:
        if client is not None:
            if not isinstance(client, DSOptimizer):
                raise TypeError("client optimizer must be a deepspeed_tpu_torch DSOptimizer")
            return client
        opt_cfg = self._config.optimizer_config
        if opt_cfg is None or not opt_cfg.type:
            return FusedAdam(lr=1e-3)
        name = opt_cfg.type.lower()
        if name in _UNPORTED_OPTIMIZERS:
            raise NotImplementedError(f"optimizer {opt_cfg.type!r} is not ported yet "
                                      f"(ROADMAP {_UNPORTED_OPTIMIZERS[name]})")
        cls = _OPTIMIZERS.get(name)
        if cls is None:
            raise ValueError(f"Unknown optimizer {opt_cfg.type!r}")
        params = dict(opt_cfg.params)
        params.pop("torch_adam", None)
        if "betas" in params:
            params["betas"] = tuple(params["betas"])
        return cls(**params)

    def _configure_lr_scheduler(self, client):
        if client is not None:
            return client(self.optimizer) if callable(client) else client
        sched_cfg = self._config.scheduler_config
        if sched_cfg is None or not sched_cfg.type:
            return None
        return get_lr_scheduler(sched_cfg.type, self.optimizer, **sched_cfg.params)

    def _place(self, batch):
        """Tokens and labels as int64 tensors on the engine's device; at dp
        > 1 this rank's rows of the global micro batch, and this rank's
        share of the global batch's labelled tokens (None at one rank)."""
        def place(x):
            if x is None:
                return None
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
            return t.to(device=self.device, dtype=torch.long, non_blocking=True)

        tokens, labels = _split_batch(batch)
        tokens, labels = place(tokens), place(labels)
        if self.dp == 1:
            return tokens, labels, None
        B = tokens.shape[0]
        if B % self.dp:
            raise ValueError(f"every rank passes the global micro batch ({self.dp} x "
                             f"train_micro_batch_size_per_gpu rows); got {B} rows, not divisible by dp={self.dp}")
        b = B // self.dp
        rows = slice(self.dp_rank * b, (self.dp_rank + 1) * b)
        share = None
        if labels is not None:
            valid = labels != _IGNORE_INDEX
            share = valid[rows].sum().float() / valid.sum().clamp(min=1).float()
            labels = labels[rows]
        return tokens[rows], labels, share

    def _model_tree(self, train: bool):
        """The tree ``apply`` reads and its layer stream: at stage 3 the
        non-layer leaves gathered and the layers left to the plan."""
        if self._plan is None:
            return self._param_tree, {}
        return unflatten_tree(self._plan.begin(train)), {"layer_stream": self._plan}

    # --- the step ------------------------------------------------------------
    def __call__(self, batch):
        return self.forward(batch)

    def forward(self, batch):
        """Training: the microbatch's loss with its graph (call ``backward``
        then ``step``). Eval: the loss (or logits without labels), no graph."""
        if self._window_stash:
            raise RuntimeError(
                "forward() called with a multi-step window mid-flight: "
                f"{len(self._window_stash)} computed step(s) are uncommitted; drive them through "
                "train_batch(data_iter) first")
        if self._training_mode:
            batch = self._curriculum(batch)
        tokens, labels, share = self._place(batch)
        if self._param_stream is not None:
            return self._stream_forward(tokens, labels, share)
        model_batch = tokens if labels is None else (tokens, labels)
        if not self._training_mode:
            with torch.no_grad(), activate(self._plan or self._a2a):
                tree, stream = self._model_tree(False)
                out = self.module.apply(tree, model_batch, train=False, attn_impl=self.attn_impl, **stream)
                if self.dp > 1:  # the global batch's loss or logits on every rank
                    if labels is None:
                        out = torch.cat(comm.all_gather(None, out), dim=0)
                    else:
                        out = comm.all_reduce(out.float() * share).to(out.dtype)
                return out
        if labels is None:
            raise ValueError("training expects (tokens, labels) batches (a dict with input_ids/labels, "
                             "or a 2-tuple)")
        if self._in_forward:
            raise RuntimeError("forward() called again before backward()")
        if self._fused_accum_enabled and not self._warned_unfused_fallback and not self._in_step_program:
            # JAX engine.py:1946-1955: the fused step engages only through train_batch
            self._warned_unfused_fallback = True
            logger.warning("fuse_grad_accum is on but forward() is being driven per microbatch; the "
                           "single-dispatch fused step only engages through train_batch() — falling back to the "
                           "unfused per-microbatch programs")
        seed = int(self._dropout_rng.integers(0, 2**62))
        kwargs = self._model_kwargs(tokens.shape[0], tokens.shape[1], seed, host_keep=True)
        with activate(self._plan or self._a2a):
            tree, stream = self._model_tree(True)
            loss = self.module.apply(tree, model_batch, dropout_seed=seed, train=True, attn_impl=self.attn_impl,
                                     split_aux=self.dp > 1, **stream, **kwargs)
        if self.dp > 1:
            # back-propagate this rank's token sum over the global count times dp (its mean when every
            # rank holds as many tokens: a factor of exactly 1); report the global mean. An MoE loss is
            # one global value on every rank whose gradient reaches this rank's own tokens: times dp
            loss, aux = loss
            value = comm.all_reduce(loss.detach().float() * share)
            local = loss * (share * self.dp).to(loss.dtype)
            if aux is not None:
                value = value + aux.detach().float()
                local = local + aux * self.dp
            loss = _GlobalLoss.apply(local, value.to(loss.dtype))
        self._last_batch = (tokens, labels, seed)
        self._last_kwargs = kwargs
        self._last_fwd_scale = self._scale_state.scale.clone()
        self._in_forward = True
        return loss

    def _stream_forward(self, tokens, labels, share):
        """``forward`` under ``offload_param``: the layer stream's eval
        forward, or its training forward (which stashes what ``backward``
        recomputes from)."""
        ps = self._param_stream
        if not self._training_mode:
            out = ps.eval_forward(tokens, labels)
            if self.dp > 1:
                if labels is None:
                    out = torch.cat(comm.all_gather(None, out), dim=0)
                else:
                    out = comm.all_reduce(out.float() * share).to(out.dtype)
            return out
        if labels is None:
            raise ValueError("param-offload training expects (tokens, labels) batches (dict with input_ids/labels, "
                             "or a 2-tuple)")
        if self._in_forward:
            raise RuntimeError("forward() called again before backward() on the param-offload path: each "
                               "microbatch's gradients are produced by backward(), so every training forward must "
                               "complete backward() first")
        seed = int(self._dropout_rng.integers(0, 2**62))
        weight = None if self.dp == 1 else (share * self.dp)
        loss = ps.forward(tokens, labels, seed, weight)
        if self.dp > 1:
            loss = comm.all_reduce(loss.detach().float() * share).to(loss.dtype)
        self._in_forward = True
        return loss.detach()

    def backward(self, loss, retain_graph: bool = False):
        """Back-propagate ``loss × scale`` and move every leaf's gradient
        into the accumulation buffer (under ``offload_param``: the layer
        stream's backward, into the host accumulators)."""
        if not self._training_mode:
            raise RuntimeError("backward() called in eval mode")
        if not self._in_forward:
            raise RuntimeError("backward() called before forward()")
        if self._param_stream is not None:
            self._param_stream.backward(float(self._scale_state.scale))
            self._in_forward = False
            return loss
        self._backward_core(loss, retain_graph)
        self._in_forward = False
        return loss

    def _backward_core(self, loss, retain_graph: bool = False) -> None:
        """``backward``'s work, which the fused step programs run too: the
        scaled backward (the scale a device scalar) and each leaf's gradient
        into the accumulator."""
        # stage 3's sharded leaves are reduced by the plan as backward passes each layer; the rest
        # accumulate whole (stages 0-1, reduced at the boundary) or go through the reduce buckets
        # (stage >= 2 at dp > 1)
        cap = self._config.zero_config.reduce_bucket_size
        if self._eager_buckets:
            self._buckets = GradBuckets(self._gdim, cap, eager=True)
        if self._plan is not None:
            self._plan.in_backward = True
        try:
            (loss.float() * self._scale_state.scale).backward(retain_graph=retain_graph)
        finally:
            if self._plan is not None:
                self._plan.in_backward = False
        with torch.no_grad():
            if self._plan is not None:
                self._plan.end_backward()
                for k, g in self._plan.collect_grads().items():
                    self._grad_acc[k].add_(g.to(self._acc_dtype))
            buckets = self._buckets
            if buckets is None and self.zero_optimization_stage() >= 2 and self.dp > 1:
                buckets = GradBuckets(self._gdim, cap, eager=False)
            self._buckets = None
            for k, p in self._params.items():
                if p.grad is None:
                    continue
                g = p.grad
                p.grad = None
                if buckets is not None and k not in self._edim:  # expert leaves reduce at the boundary
                    buckets.add(k, g.to(self._acc_dtype))
                else:
                    # an fp32 accumulator adds the gradient exactly widened, without a widened copy
                    acc = self._grad_acc[k]
                    acc.add_(g if acc.dtype == torch.float32 else g.to(acc.dtype))
            if buckets is not None:
                for k, g in buckets.finish().items():
                    self._grad_acc[k].add_(g)

    def step(self, lr_kwargs=None):  # noqa: ARG002
        if self._in_forward:
            raise RuntimeError("step() called before backward()")
        boundary = self.is_gradient_accumulation_boundary()
        if boundary:
            self._take_model_step()
        self.micro_steps += 1
        self.global_samples += self.train_micro_batch_size_per_gpu() * self.dp
        # interval auto-save (JAX engine.py:2424-2429), after this microbatch
        # is counted: a save before the count would resume one microbatch
        # early and, at gas > 1, take the next step after a single microbatch
        ccfg = self._config.checkpoint_config
        if boundary and ccfg.save_dir and ccfg.interval_steps > 0 and self.global_steps % ccfg.interval_steps == 0:
            self.save_checkpoint(ccfg.save_dir)

    @torch.no_grad()
    def _update_from_grads(self, lr: torch.Tensor):
        """One optimizer update from the accumulation buffer (see the module
        docstring), JAX's ``update_from_grads`` on device state only: the
        loss scale, the lr (``lr``, an fp32 device scalar) and the step
        count are device scalars, the overflow flag is a device bool that
        keeps master and moments by ``torch.where`` and walks the scale in
        place, and no value is read on the host, so a CUDA graph can capture
        it. Master, moments and accumulators are written in place, a leaf
        (or a piece of a leaf) at a time. Returns ``(overflow, grad_norm)``
        as device scalars."""
        dp, r = self.dp, self.dp_rank
        inv = self._unscale_inv()
        acc = self._grad_acc
        overflow, grad_norm, coef = self._grad_stats(lambda: ((k, g.float() * inv) for k, g in acc.items()))
        fp16 = self._config.fp16_enabled
        opt, st = self.optimizer, self._opt_state
        if not getattr(opt, "capturable", False):
            # a client optimizer: its own apply, on host numbers, outside any captured program
            grads = {k: g.float() * inv for k, g in acc.items()}
            if coef is not None:
                grads = {k: g * coef for k, g in grads.items()}
            if not bool(overflow):
                grads = {k: shard(g, self._mdim[k], r, dp) if self._gdim[k] is None else g for k, g in grads.items()}
                new_master, self._opt_state = opt.apply(grads, st, self._master, float(lr))
                for k, m in self._master.items():
                    m.copy_(new_master[k])
                self._refresh_params()
        else:
            moments = opt.moments(st)
            bc1, bc2 = opt.bias_corrections(st.step + 1, self.device)
            for k, a in acc.items():
                g = a.float() * inv
                if coef is not None:
                    g = g * coef
                if self._gdim[k] is None:
                    g = shard(g, self._mdim[k], r, dp)  # the owner-shard update: this rank's slice
                state = [self._master[k]] + [t[k] for t in moments]
                for piece in _pieces(g, state, chunked=dp == 1):
                    gp, old = piece[0], piece[1:]
                    new = opt.leaf(gp, *old, bc1, bc2, lr)
                    for o, n in zip(old, new):
                        o.copy_(torch.where(overflow, o, n) if fp16 else n)
            # the step count advances on a taken step only (JAX's where over the whole optimizer state)
            st.step.add_((~overflow).to(st.step.dtype) if fp16 else 1)
            self._refresh_params()
        self.loss_scaler.update_(self._scale_state, overflow)
        for g in acc.values():
            g.zero_()
        self._last_grad_norm = grad_norm
        return overflow, grad_norm

    def _unscale_inv(self) -> torch.Tensor:
        """``1 / (scale · gas [· dp])`` as an fp32 device scalar, after
        summing the whole accumulators over the ranks at stages 0-1."""
        denom = self._scale_state.scale * float(self.gradient_accumulation_steps())
        if self.dp > 1:
            denom = denom * float(self.dp)  # the gradients are summed over the ranks
            if self.zero_optimization_stage() <= 1:
                self._all_reduce_accum()
            elif self._edim:
                self._all_reduce_accum(experts_only=True)
        return 1.0 / denom

    def _grad_stats(self, grads: Callable):
        """``(overflow, grad_norm, clip coefficient or None)`` of the unscaled
        fp32 gradients ``grads()`` yields as ``(name, tensor)`` pairs (called
        once for the flag, once for the norm), all device scalars; the flag
        is False outside fp16."""
        dp, r = self.dp, self.dp_rank
        if self._config.fp16_enabled:
            overflow = has_inf_or_nan(g for _, g in grads())
            if dp > 1:  # every rank skips together
                overflow = comm.all_reduce(overflow.float(), op=comm.ReduceOp.MAX) > 0
        else:
            overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        if dp > 1 and (self.zero_optimization_stage() >= 2 or self._edim):
            # the global norm from the slices' squares: a replicated leaf counted on rank 0 only, an expert
            # shard once for each expert coordinate (on the first rank of its expert-data group)
            first = self.topo.expert_data_rank == 0
            parts = [torch.sum(torch.square(g)) for k, g in grads()
                     if (first if k in self._edim else self._gdim[k] is not None or r == 0)]
            sq = comm.all_reduce(torch.stack(parts).sum() if parts else torch.zeros((), device=self.device))
        else:
            sq = torch.stack([torch.sum(torch.square(g)) for _, g in grads()]).sum()
        grad_norm = torch.sqrt(sq)
        clip = self._config.gradient_clipping
        coef = torch.clamp(clip / (grad_norm + 1e-6), max=1.0) if clip > 0 else None
        return overflow, grad_norm, coef

    def _all_reduce_accum(self, experts_only: bool = False) -> None:
        """Stages 0-1: sum the whole accumulators over the ranks, one
        all-reduce a bucket of ``reduce_bucket_size`` elements; the expert
        leaves over their expert-data group only (with ``experts_only``,
        stages 2-3, those alone)."""
        dense = [] if experts_only else [k for k in self._grad_acc if k not in self._edim]
        experts = [k for k in self._grad_acc if k in self._edim]
        for names, group, size in ((dense, None, self.dp), (experts, self.topo.expert_data_group,
                                                              self.topo.get_expert_data_parallel_world_size())):
            if not names or size == 1:
                continue
            for bucket in split_buckets([self._grad_acc[k].numel() for k in names],
                                        self._config.zero_config.reduce_bucket_size):
                comm.all_reduce_coalesced([self._grad_acc[names[i]] for i in bucket], group=group)

    def _take_model_step(self) -> None:
        """The eager optimizer step at the accumulation boundary: one
        dispatch, its overflow read on the host afterwards for the
        bookkeeping."""
        lr = self.optimizer.param_groups[0]["lr"]
        self._dispatches += 1
        self._last_fused = False
        if self._param_stream is not None:
            grad_norm, overflow = self._param_stream.step(lr, float(self._scale_state.scale),
                                                          self._config.gradient_clipping)
            self._last_grad_norm = torch.tensor(grad_norm, dtype=torch.float32)
            self.loss_scaler.update_(self._scale_state, overflow)
        elif self._streamed_offload:
            overflow = self._take_streamed_offload_step(lr)
        elif self._host_offload is not None:
            overflow = self._take_offload_step(lr)
        else:
            self._lr_t.fill_(lr)
            overflow = self._update_from_grads(self._lr_t)[0]
            overflow = bool(overflow) if self._config.fp16_enabled else False
        self._finish_step_bookkeeping(overflow)

    def _finish_step_bookkeeping(self, overflow: bool, save: bool = False) -> None:
        """The host tail every step flavour shares (JAX ``engine.py:2389``):
        the preemption instant (the state holds the update, nothing of the
        step is committed on the host yet), the counters, the overflow
        accounting, the lr schedule (not advanced on a skipped step), and,
        with ``save``, the interval auto-save (the sequential path saves in
        ``step`` once the microbatch is counted)."""
        chaos.point("train.mid_step")
        self.global_steps += 1
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        if self.random_ltd_scheduler is not None:
            self.random_ltd_scheduler.update(self.global_steps)
        if overflow:
            self.skipped_steps += 1
            log_dist(f"[deepspeed_tpu_torch] OVERFLOW! skipping step, new loss scale: {self.loss_scale}",
                     ranks=[0])
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()
        ccfg = self._config.checkpoint_config
        if save and ccfg.save_dir and ccfg.interval_steps > 0 and self.global_steps % ccfg.interval_steps == 0:
            self.save_checkpoint(ccfg.save_dir)

    def train_batch(self, data_iter=None, batch=None):
        """One optimizer step over ``gas`` microbatches: ``batch`` is the
        full-step batch (its leading dim is sliced into ``gas`` microbatches),
        or ``data_iter`` yields the microbatches. Returns the mean loss.

        With ``compile.fuse_grad_accum`` at gas > 1 the step is one step
        program (``_fused_train_batch``): on the card one replay of a
        captured CUDA graph. With ``compile.multi_step`` and a ``data_iter``
        a call at a step boundary runs a window of ``horizon`` whole steps
        as one program (``_try_train_window``), and the next horizon - 1
        calls commit the steps it already computed; such calls return the
        step's loss as a 0-d device tensor, and the host values arrive
        through ``drained_losses()`` one window late."""
        gas = self.gradient_accumulation_steps()
        if self._window_stash:
            if batch is not None:
                raise RuntimeError(
                    "train_batch(batch=...) called with a multi-step window mid-flight: the window's remaining "
                    "steps already consumed their data; keep driving with train_batch(data_iter)")
            return self._commit_window_step()
        if (self._window_armed and data_iter is not None and batch is None and self._training_mode
                and not self._in_forward):
            out = self._try_train_window(data_iter)
            if out is not _NO_WINDOW:
                return out
        if batch is not None:
            micro = self._split_step_batch(batch, gas)
        elif data_iter is not None:
            # an armed engine keeps pulling through its loader, so batches a window
            # looked ahead at are never dropped
            src = self._window_loader(data_iter) if (self._window_armed and self._training_mode) else data_iter
            micro = [next(src) for _ in range(gas)]
        else:
            raise ValueError("train_batch needs data_iter or batch")
        if self._training_mode:
            micro = [self._curriculum(b) for b in micro]
        fused = (self._fused_accum_enabled and self._training_mode and not self._in_forward
                 and self.micro_steps % gas == 0)
        if fused and self.dp == 1:
            return self._fused_train_batch(micro)
        if fused:
            self._fused_step_uncaptured(micro)
        losses = []
        try:
            for b in micro:
                loss = self.forward(b)
                self.backward(loss)
                self.step()
                losses.append(loss.detach())
        finally:
            self._in_step_program = False
        if fused:
            self._last_fused = True  # get_last_grads recomputes, as after a fused step
        return float(torch.stack(losses).float().mean())

    def _split_step_batch(self, batch, gas: int):
        if gas == 1:
            return [batch]
        tokens, labels = _split_batch(batch)
        B = tokens.shape[0]
        if B % gas:
            raise ValueError(f"train_batch(batch=...) leading dim {B} is not divisible by "
                             f"gradient_accumulation_steps={gas}")
        b = B // gas
        cut = lambda x, g: None if x is None else x[g * b:(g + 1) * b]  # noqa: E731
        return [(cut(tokens, g), cut(labels, g)) if labels is not None else cut(tokens, g) for g in range(gas)]

    # --- the step programs: fused accumulation and multi-step windows (JAX engine.py:1317-1620, 2662-3205)
    def _init_step_programs(self) -> None:
        """The switches of ``compile``: ``fuse_grad_accum`` at gas > 1 (not on
        the offload paths, as in JAX) and ``multi_step`` (checked by
        ``_validate_multi_step``); the captured graphs, built at first use."""
        cc = self._config.compile_config
        gas = self.gradient_accumulation_steps()
        if cc.fuse_grad_accum and gas > 1 and (self._host_offload is not None or self._param_stream is not None):
            logger.warning("compile.fuse_grad_accum does not engage on the offload paths (their host loop owns "
                           "the update, as in the reference): steps run per microbatch")
        self._warned_unfused_fallback = False
        self._in_step_program = False  # the fused step's own forward calls do not warn
        self._graphs: Dict[Any, _StepProgram] = {}
        # one memory pool for every captured program: they never run at once, and everything they keep
        # between replays (state, static buffers) lives outside it, so a second batch shape reuses the
        # first one's activations instead of holding a pool of its own
        self._graph_pool = None  # the handle, taken anew whenever no captured graph holds the pool
        self._graph_counts = {"captures": 0, "replays": 0, "warmups": 0, "uncaptured": 0}
        self._dispatches = 0  # calls of a step program: eager steps, fused steps, windows
        self._last_batch = None  # get_last_grads' stash: (tokens, labels, seed) of the last microbatch
        self._last_fwd_scale = None  # and the loss scale it was back-propagated at
        self._last_fused = False  # the last step ran a step program (its gradients died inside it)
        self._validate_multi_step()
        self._arm_step_programs(gas)
        self._window_stash: deque = deque()  # computed-but-uncommitted steps
        self._pending_drains: deque = deque()  # windows whose host copies are in flight
        self._drained_log: deque = deque(maxlen=4096)
        self._drained_dropped = 0
        self._window_metrics = {
            "window_steps": 0,
            "windowed_opt_steps": 0,
            "window_break_reasons": {
                "checkpoint": 0,  # a checkpoint-interval boundary inside the horizon
                "monitor": 0,  # a monitor flush inside the horizon (monitors are not ported: never)
                "data": 0,  # the iterator ran out before a full window
                "profiler": 0,  # the flops-profiler step (not ported: never)
            },
        }
        self._active_prefetcher = None  # the window's PrefetchingLoader over the live data iterator
        self._prefetch_key = None

    def _arm_step_programs(self, gas: int) -> None:
        """Whether fused accumulation and multi-step windows engage at
        ``gas`` microbatches a step, at construction and after every resize:
        fused accumulation at gas > 1 off the offload paths; windows at gas 1,
        over the fused body, or on the streamed offload path. A window's body
        runs every rank's microbatches whole, and an MoE layer across ranks
        gates each rank's own rows (its token shard), so an MoE model at
        dp > 1 steps sequentially, through forward."""
        cc = self._config.compile_config
        offload = self._host_offload is not None or self._param_stream is not None
        self._fused_accum_enabled = bool(cc.fuse_grad_accum) and gas > 1 and not offload
        streamed_ok = self._streamed_offload and (gas == 1 or bool(cc.fuse_grad_accum))
        moe_across_ranks = self.dp > 1 and getattr(self.module, "_moe", False)
        self._window_armed = (bool(cc.multi_step.enable) and not moe_across_ranks
                              and (gas == 1 or self._fused_accum_enabled or streamed_ok))
        self._window_horizon = int(cc.multi_step.horizon) if self._window_armed else 0

    def _validate_multi_step(self) -> None:
        """JAX ``_validate_multi_step`` (``engine.py:2083``), the checks that
        need the built engine (the config-only ones ran first,
        ``_validate_multi_step_config``)."""
        if not self._config.compile_config.multi_step.enable:
            return
        if self.gradient_accumulation_steps() > 1 and not self._config.compile_config.fuse_grad_accum:
            raise ValueError("compile.multi_step with gradient_accumulation_steps > 1 requires "
                             "compile.fuse_grad_accum (the window scans the fused grad-accum body)")
        if self.lr_scheduler is not None and not (hasattr(self.lr_scheduler, "state_dict")
                                                  and hasattr(self.lr_scheduler, "load_state_dict")):
            raise ValueError("compile.multi_step requires an lr scheduler with state_dict/load_state_dict (the "
                             "window pre-evaluates the schedule via snapshot -> replay -> restore)")
        self._require_capturable("compile.multi_step")

    def _require_capturable(self, what: str) -> None:
        if not getattr(self.optimizer, "capturable", False):
            raise ValueError(f"{what} needs an optimizer whose step runs on device scalars (FusedAdam, Adam, "
                             "AdamW, Adagrad); a client optimizer's host apply cannot run inside one step program")

    def _step_body(self, tokens, labels, seeds, lr, routing=None):
        """One whole optimizer step on device state (JAX ``full_step_core``,
        ``engine.py:1317-1395``): forward, scaled backward and accumulation
        per microbatch of ``tokens``/``labels`` ``[gas, b, T]``, then the
        update. ``routing`` holds the microbatches' stacked ``pld_keep``
        ``[gas, L]`` or ``ltd_idx`` ``[gas, n, b, kept]``. The same ops as
        ``forward``/``backward``/``step``, so the fused programs equal the
        sequential run. Returns ``(mean loss, grad_norm, overflow, the loss
        scale the step used)`` as device scalars."""
        pre_scale = self._scale_state.scale.clone()
        losses = []
        for g in range(tokens.shape[0]):
            seed = seeds[g] if self._has_dropout else None
            kwargs = {k: v[g] for k, v in (routing or {}).items()}
            loss = self.module.apply(self._param_tree, (tokens[g], labels[g]), dropout_seed=seed, train=True,
                                     attn_impl=self.attn_impl, **kwargs)
            self._backward_core(loss)
            losses.append(loss.detach())
        loss = torch.stack(losses).float().mean()
        overflow, grad_norm = self._update_from_grads(lr)
        return loss, grad_norm, overflow, pre_scale

    @property
    def _has_dropout(self) -> bool:
        """The step's seeds reach the model: dropout masks, or an MoE
        model's gate noise."""
        c = self.module.config
        return c.attn_dropout > 0 or c.hidden_dropout > 0 or getattr(self.module, "_moe", False)

    def _stack_micro(self, micro) -> Dict[str, torch.Tensor]:
        """The step's microbatches as host or device int64 ``[n, b, T]``
        tokens and labels, and one dropout seed a microbatch drawn from the
        engine's generator in the sequential path's order."""
        toks, labs = [], []
        for b in micro:
            t, lab = _split_batch(b)
            if lab is None:
                raise ValueError("training expects (tokens, labels) batches (a dict with input_ids/labels, "
                                 "or a 2-tuple)")
            toks.append(_as_long(t))
            labs.append(_as_long(lab))
        seeds = [int(self._dropout_rng.integers(0, 2**62)) for _ in micro]
        data = {"tokens": torch.stack(toks), "labels": torch.stack(labs),
                "seeds": torch.tensor(seeds, dtype=torch.int64)}
        b, T = data["tokens"].shape[1:]
        per_micro = [self._model_kwargs(b, T, sd, host_keep=False) for sd in seeds]
        for k in per_micro[0]:
            data[k] = torch.stack([kw[k] for kw in per_micro])
        return data

    def _program(self, key, inputs: Dict[str, torch.Tensor], outputs: Dict[str, tuple], body) -> "_StepProgram":
        """Run the step program ``key`` once on ``inputs`` (host or device
        tensors, copied into its static buffers): on the card the first call
        runs ``body`` eagerly on a side stream (PyTorch's warm-up, a real
        step), the second captures it as a ``torch.cuda.CUDAGraph`` into the
        engine's shared graph pool and replays it, every later call
        replays; on the CPU ``body`` runs eagerly. A failed capture
        raises."""
        prog = self._graphs.get(key)
        if prog is None:
            if self.curriculum_scheduler is not None or self.random_ltd_scheduler is not None:
                # the schedules only grow: a program whose shape they left never replays again
                left = [k for k in self._graphs if k[0] == key[0]]
                for k in left:
                    self._graphs.pop(k).release()
                if left and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                    torch.cuda.empty_cache()
            prog = self._graphs[key] = _StepProgram(inputs, outputs, self.device)
        prog.load(inputs)
        self._dispatches += 1
        if self.device.type != "cuda":
            body(prog)
            self._graph_counts["uncaptured"] += 1
        elif prog.runs == 0:
            side = _side_stream(self.device, "warmup")
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                body(prog)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self._graph_counts["warmups"] += 1
        else:
            if prog.graph is None:
                if not any(p.graph is not None for p in self._graphs.values()):
                    # a pool whose last graph was freed cannot take another capture: start a new one
                    self._graph_pool = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self._graph_pool):
                    body(prog)
                prog.graph = graph
                self._graph_counts["captures"] += 1
            prog.start.record()
            prog.graph.replay()
            prog.end.record()
            self._graph_counts["replays"] += 1
        prog.runs += 1
        return prog

    def invalidate_compiled_step(self) -> None:
        """Drop every captured step program (JAX ``engine.py:1077``): their
        graphs and static buffers are released and the caching allocator's
        graph pools returned, so a resize never holds two sets."""
        for prog in self._graphs.values():
            prog.release()
        self._graphs.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _fused_step_uncaptured(self, micro) -> None:
        """``compile.fuse_grad_accum`` at dp > 1: the collectives are gloo's
        or NCCL's host calls, so the step runs as ``train_batch``'s
        sequential loop, uncaptured and counted in ``window_stats()``; its
        ``forward`` calls do not warn. The batches must be host batches
        (JAX ``engine.py:963-973``)."""
        self._require_capturable("compile.fuse_grad_accum")
        for b in micro:
            if any(isinstance(x, torch.Tensor) and x.device.type != "cpu" for x in _split_batch(b)):
                raise NotImplementedError(
                    "fuse_grad_accum on multi-process runs requires host (numpy or CPU tensor) microbatches; "
                    "pre-placed device batches cannot be re-stacked across ranks — feed host batches or "
                    "disable compile.fuse_grad_accum")
        self._graph_counts["uncaptured"] += 1
        self._in_step_program = True

    def _fused_train_batch(self, micro):
        """``compile.fuse_grad_accum`` at dp = 1 (JAX ``_fused_train_batch``,
        ``engine.py:2700``): the gas microbatches stacked, then forward,
        backward and accumulation per microbatch and the update as one step
        program (one replay a step on the card). Returns the mean loss as a
        host number."""
        gas = len(micro)
        self._require_capturable("compile.fuse_grad_accum")
        data = self._stack_micro(micro)
        data["lr"] = torch.tensor([self.optimizer.param_groups[0]["lr"]], dtype=torch.float32)
        tokens = data["tokens"]
        routing = {k: data[k] for k in _ROUTING if k in data}
        key = ("fused", tuple(tokens.shape)) + tuple((k, tuple(v.shape)) for k, v in routing.items())
        prog = self._program(key, data,
                             {"loss": ((), torch.float32), "norm": ((), torch.float32),
                              "overflow": ((), torch.bool), "scale": ((), torch.float32)}, self._fused_body)
        loss, self._last_grad_norm, overflow = prog.out["loss"], prog.out["norm"], prog.out["overflow"]
        self._last_batch = (tokens[-1], data["labels"][-1], int(data["seeds"][-1]))
        self._last_kwargs = {k: v[-1] for k, v in routing.items()}
        self._last_fwd_scale = prog.out["scale"].clone()
        self._last_fused = True
        self.micro_steps += gas
        self.global_samples += self.train_micro_batch_size_per_gpu() * self.dp * gas
        self._finish_step_bookkeeping(bool(overflow) if self._config.fp16_enabled else False, save=True)
        return float(loss)

    def _fused_body(self, prog: "_StepProgram") -> None:
        i, o = prog.inp, prog.out
        loss, norm, overflow, scale = self._step_body(i["tokens"], i["labels"], i["seeds"], i["lr"][0],
                                                      {k: i[k] for k in _ROUTING if k in i})
        o["loss"].copy_(loss)
        o["norm"].copy_(norm)
        o["overflow"].copy_(overflow)
        o["scale"].copy_(scale)

    # --- multi-step windows (JAX engine.py:2867-3205) ---------------------------------
    def _window_loader(self, data_iter):
        """The window's look-ahead over the live ``data_iter`` (JAX
        ``engine.py:2869-2916``): a ``PrefetchingLoader``, cached by iterator
        identity, keeping ``gas × horizon`` batches placed on the card ahead
        (``_place_ahead``; none with ``multi_step.prefetch`` off), whose
        cursor snapshots ``training_dataloader`` before each pull, so a
        checkpoint cut while batches wait resumes on them. A window checks
        that a whole horizon exists before it forms; batches it looked at go
        to the sequential path if it does not."""
        from deepspeed_tpu_torch.runtime.dataloader import PrefetchingLoader

        if self._active_prefetcher is not None and self._prefetch_key == id(data_iter):
            return self._active_prefetcher
        if (self._active_prefetcher is not None and data_iter is not self._active_prefetcher
                and self._active_prefetcher.buffered()):
            logger.warning(f"multi_step prefetcher: a new data iterator replaces one with "
                           f"{self._active_prefetcher.buffered()} staged-but-untrained batch(es); those samples "
                           "are dropped. Drive epochs through one continuous iterator (e.g. a RepeatingLoader) or "
                           "set compile.multi_step.prefetch=false")
        if isinstance(data_iter, PrefetchingLoader):
            self._active_prefetcher, self._prefetch_key = data_iter, id(data_iter)
            return data_iter
        depth = self.gradient_accumulation_steps() * self._window_horizon \
            if self._config.compile_config.multi_step.prefetch else 0
        source = self.training_dataloader if self.training_dataloader is not None and hasattr(
            self.training_dataloader, "state_dict") else None
        self._active_prefetcher = PrefetchingLoader(data_iter, place_fn=self._place_ahead, depth=depth,
                                                    state_source=source)
        self._prefetch_key = id(data_iter)
        return self._active_prefetcher

    def _window_break(self, reason: str):
        self._window_metrics["window_break_reasons"][reason] += 1
        return _NO_WINDOW

    def _window_lrs(self, n: int) -> List[float]:
        """The next ``n`` lr values of the host schedule without advancing it
        (JAX ``engine.py:2926``): snapshot, replay, restore, and the live
        param groups' lr put back for a never-stepped schedule."""
        lr0 = float(self.optimizer.param_groups[0]["lr"])
        if self.lr_scheduler is None or n == 1:
            return [lr0] * n
        sd = copy.deepcopy(self.lr_scheduler.state_dict())
        group_lrs = [g["lr"] for g in self.optimizer.param_groups]
        lrs = [lr0]
        try:
            for _ in range(n - 1):
                self.lr_scheduler.step()
                lrs.append(float(self.optimizer.param_groups[0]["lr"]))
        finally:
            self.lr_scheduler.load_state_dict(sd)
            for group, lr in zip(self.optimizer.param_groups, group_lrs):
                group["lr"] = lr
        return lrs

    def _try_train_window(self, data_iter):
        """Form and run one window of ``horizon`` whole steps as one step
        program, or return ``_NO_WINDOW`` (counting why) so the caller runs
        the step sequentially (JAX ``engine.py:2958``). A window forms only
        when it ends at or before the next checkpoint-interval boundary and
        a whole horizon of data exists."""
        gas = self.gradient_accumulation_steps()
        H = self._window_horizon
        if self.micro_steps % gas != 0:
            return _NO_WINDOW  # mid-accumulation: the sequential path owns it
        ccfg = self._config.checkpoint_config
        if ccfg.save_dir and ccfg.interval_steps > 0:
            if ccfg.interval_steps - (self.global_steps % ccfg.interval_steps) < H:
                return self._window_break("checkpoint")
        loader = self._window_loader(data_iter)
        if loader.fill(gas * H) < gas * H:
            return self._window_break("data")
        micro = [next(loader) for _ in range(gas * H)]
        data = self._stack_micro(micro)
        tokens = data["tokens"]
        data["tokens"] = tokens.reshape((H, gas) + tuple(tokens.shape[1:]))
        data["labels"] = data["labels"].reshape((H, gas) + tuple(tokens.shape[1:]))
        data["seeds"] = data["seeds"].reshape(H, gas)
        data["lrs"] = torch.tensor(self._window_lrs(H), dtype=torch.float32)
        if self._streamed_offload:
            self._window_gather_offload()
        prog = self._program(("window", tuple(data["tokens"].shape)), data,
                             {"losses": ((H,), torch.float32), "norms": ((H,), torch.float32),
                              "overflows": ((H,), torch.bool), "scale": ((), torch.float32)}, self._window_body)
        # the window's results as tensors of their own (the next replay rewrites the program's outputs),
        # copied to pinned host memory behind an event and drained one window late
        vals = (prog.out["losses"].clone(), prog.out["norms"].clone(), prog.out["overflows"].clone())
        drain = _Drain(vals, self.global_steps)
        self._last_batch = (data["tokens"][-1, -1], data["labels"][-1, -1], int(data["seeds"][-1, -1]))
        self._last_fwd_scale = prog.out["scale"].clone()
        self._last_fused = True
        self._window_metrics["window_steps"] += 1
        self._window_metrics["windowed_opt_steps"] += H
        chaos.point("train.mid_window")
        fp16 = self._config.fp16_enabled
        if fp16:
            # the skip counters and the lr schedule follow the overflow verdicts: drain this window now
            self._append_drain(drain)
            ovfs = [bool(x) for x in drain.wait()[2]]
        else:
            self._pending_drains.append(drain)
            self._drain_pending(keep=1)
            ovfs = [None] * H
        if self._streamed_offload:
            self._window_scatter_offload(H - sum(1 for x in ovfs if x))
            prog.drop_graph()
        self._window_stash.extend({"loss": vals[0][k], "norm": vals[1][k], "ovf": ovfs[k]} for k in range(H))
        return self._commit_window_step()

    @torch.no_grad()
    def _window_gather_offload(self) -> None:
        """Streamed offload: the host master and moments to the card for the
        window (JAX ``engine.py:3000-3040``); the window's step body runs on
        the staged tensors as on the on-card engine's state. They live for
        this window only (``_window_scatter_offload`` writes them back and
        lets them go, with the window's graph, which read their addresses),
        so between windows the card holds what the streamed sequential step
        holds, and each window after the warm-up captures anew. Under fp32
        the parameters are the master."""
        ho = self._host_offload
        masters, ms, vs = ho.gather_device_state()
        self._master = dict(zip(ho.names, masters)) if masters is not None else dict(self._params)
        step = torch.full((), ho.step_count, dtype=torch.int32, device=self.device)
        self._opt_state = AdamState(step=step, exp_avg=dict(zip(ho.names, ms)), exp_avg_sq=dict(zip(ho.names, vs)))

    def _window_scatter_offload(self, taken: int) -> None:
        """The window's master and moments back to the host buffers, which
        are authoritative again; ``taken`` steps advance the host count."""
        ho = self._host_offload
        st = self._opt_state
        self._host_offload.scatter_device_state([self._master[k] for k in ho.names],
                                                [st.exp_avg[k] for k in ho.names],
                                                [st.exp_avg_sq[k] for k in ho.names], taken)
        self._master = None
        self._opt_state = None

    def _window_body(self, prog: "_StepProgram") -> None:
        """H whole steps in one program: the step body per step, the lr taken
        from the window's pre-evaluated schedule at a cursor that advances
        only on a step that did not overflow (JAX ``engine.py:1553-1582``)."""
        i, o = prog.inp, prog.out
        cursor = torch.zeros(1, dtype=torch.int64, device=self.device)
        for h in range(i["tokens"].shape[0]):
            lr = torch.index_select(i["lrs"], 0, cursor)[0]
            loss, norm, overflow, scale = self._step_body(i["tokens"][h], i["labels"][h], i["seeds"][h], lr)
            o["scale"].copy_(scale)  # the last step's, for get_last_grads
            o["losses"][h].copy_(loss)
            o["norms"][h].copy_(norm)
            o["overflows"][h].copy_(overflow)
            cursor = cursor + (~overflow).long()

    def _commit_window_step(self):
        """Commit one already-computed window step to the host bookkeeping
        (JAX ``engine.py:3114``): counters, lr schedule, fp16 skip
        accounting and the interval auto-save, which the formation rule
        lets fire only at a window's last step."""
        rec = self._window_stash.popleft()
        gas = self.gradient_accumulation_steps()
        self._last_grad_norm = rec["norm"]
        self.micro_steps += gas
        self.global_samples += self.train_micro_batch_size_per_gpu() * self.dp * gas
        self._finish_step_bookkeeping(bool(rec["ovf"]), save=True)
        return rec["loss"]

    def _append_drain(self, drain: "_Drain") -> None:
        for k, (loss, norm, ovf) in enumerate(zip(*drain.wait())):
            if len(self._drained_log) == self._drained_log.maxlen:
                self._drained_dropped += 1
            self._drained_log.append({"step": drain.base_step + k + 1, "loss": float(loss),
                                      "grad_norm": float(norm), "overflow": bool(ovf)})

    def _drain_pending(self, keep: int = 0) -> None:
        while len(self._pending_drains) > keep:
            self._append_drain(self._pending_drains.popleft())

    def flush_loss_drain(self) -> None:
        """Force the deferred loss drain: ``drained_losses()`` then covers
        every committed window step."""
        self._drain_pending(keep=0)

    def drained_losses(self):
        """The windows' per-step results on the host, ``{step, loss,
        grad_norm, overflow}`` in step order, delivered one window late
        (JAX ``engine.py:3155``). Bounded at 4096 entries;
        ``window_stats()["drained_dropped"]`` counts evictions.
        ``load_checkpoint`` resets it to the resumed timeline."""
        return list(self._drained_log)

    def window_stats(self) -> Dict[str, Any]:
        """JAX's window telemetry (``engine.py:3174``): window counts, break
        reasons, and ``dispatches_per_opt_step``, calls of a step program
        (an eager step, a fused step, a window) over optimizer steps, 1/H on
        a windowed run. ``graphs`` (the port's) counts the captured
        programs' warm-ups, captures and replays, and the step programs run
        uncaptured (on the CPU, or the fused step at dp > 1)."""
        return {
            "multi_step_enabled": self._window_armed,
            "window_horizon": self._window_horizon,
            "window_steps": self._window_metrics["window_steps"],
            "windowed_opt_steps": self._window_metrics["windowed_opt_steps"],
            "opt_steps": self.global_steps,
            "window_break_reasons": dict(self._window_metrics["window_break_reasons"]),
            "dispatches": self._dispatches,
            "dispatches_per_opt_step": self._dispatches / self.global_steps if self.global_steps else 0.0,
            "pending_loss_drains": len(self._pending_drains),
            "stashed_steps": len(self._window_stash),
            "drained_dropped": self._drained_dropped,
            "graphs": dict(self._graph_counts),
        }

    def window_device_ms(self) -> List[float]:
        """Device time of each captured program's last replay, by CUDA
        events (``[]`` before a replay or off the card)."""
        return [p.device_ms() for p in self._graphs.values() if p.device_ms() is not None]

    # --- checkpoints (JAX engine.py:3240-3736) --------------------------------------
    def _ckpt_dir(self, save_dir: str, tag: str) -> str:
        return os.path.join(save_dir, str(tag))

    def _checkpoint_state(self, client_state: Optional[Dict]) -> Dict[str, Any]:
        """The full replay state under JAX's keys and tree paths, whole
        arrays at any dp (a collective at dp > 1: every rank gathers its
        slices). At one rank the tensors are the live ones (the caller
        snapshots them); the optimizer and loss-scale scalars ride as 0-d
        tensors, where JAX has arrays."""
        from deepspeed_tpu_torch import __version__

        s = self._scale_state
        if self._param_stream is not None:
            # the fp32 master and moments are the stream's host state; the module its compute-dtype store
            module, master = _sorted_tree(self._param_stream.gathered_params()), None
            optimizer = {"param_stream": self._param_stream.state_dict()}
        elif self._host_offload is not None:
            # the fp32 master lives inside the host-offload records (no second copy)
            module, master = _sorted_tree(self._full_params()), None
            optimizer = {"host_offload": self._host_offload_state()}
        else:
            module = unflatten_tree(self._full_params())
            master = unflatten_tree(self._full_master()) if self.mixed_precision else None
            optimizer = _opt_state_to_tree(self._full_opt_state())
        return {
            "module": module,
            "master": master,
            "optimizer": optimizer,
            "loss_scaler": {"scale": torch.tensor(float(s.scale), dtype=torch.float64),
                            "good_steps": torch.tensor(int(s.good_steps)),
                            "hysteresis": torch.tensor(int(s.hysteresis))},
            "lr_scheduler": self.lr_scheduler.state_dict() if self.lr_scheduler is not None else None,
            "random_ltd": self.random_ltd_scheduler.state_dict() if self.random_ltd_scheduler is not None else None,
            "moq": None,
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
            # exact-resume replay state: the generator the next microbatch
            # draws its seed from (JAX's PRNG key; the dropout masks, gate
            # noise, PLD flags and LTD indices all derive from that seed),
            # the data cursor of the first untrained batch, the mesh
            "rng": self._dropout_rng.bit_generator.state,
            "data_cursor": self._data_cursor_state(),
            "mesh": self._mesh_shape(),
            "ds_config": self._config._param_dict,
            "ds_version": __version__,
            "client_state": client_state or {},
        }

    def _host_offload_state(self) -> Dict[str, Any]:
        """``optimizer["host_offload"]``: the engine's records, whole leaves
        at any dp (the slices gathered through the card at dp > 1: one
        record a leaf, its index whole)."""
        ho = self._host_offload
        if self.dp == 1:
            return ho.state_dict()
        if self._streamed_offload:
            st = ho.state_dict()
            for k, rec in zip(ho.names, st["leaves"]):
                for f in ("master", "exp_avg", "exp_avg_sq"):
                    rec[f] = self._gather_host({k: rec[f]})[k].cpu()
            return st
        leaves = []
        for k in ho.names:
            rec = {f: self._gather_host({k: torch.from_numpy(a).reshape(self._slice_shape(k))})[k].cpu().reshape(-1)
                   for f, a in ho.leaf_state(k).items()}
            leaves.append([dict(index=[(None, None)] * len(self._shapes[k]), **rec)])
        return {"step": ho.step_count, "leaves": leaves}

    def _mesh_shape(self) -> Dict[str, int]:
        """The mesh a checkpoint records: ``{"data": dp}``, or under an
        expert axis every axis, as JAX writes it (``engine.py:3316``)."""
        return {"data": self.dp} if self.ep == 1 else dict(self.topo.sizes)

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None, client_state: Optional[Dict] = None,
                        save_latest: bool = True, exclude_frozen_parameters: bool = False,  # noqa: ARG002
                        asynchronous: Optional[bool] = None):
        """Write one atomic checkpoint under ``save_dir/tag`` (default
        ``global_step<N>``) holding the full replay state, so that
        ``load_checkpoint(auto_resume=True)`` resumes bit-identically.
        Staged, committed by one rename, then the ``latest`` marker: a kill
        at any instant leaves the newest valid checkpoint discoverable.
        ``asynchronous`` (default ``checkpoint.async_snapshot``) copies the
        state to pinned host memory and persists it from a background
        writer, so the step pays only the copy
        (``checkpoint_stats()["last_stall_ms"]``). At dp > 1 every rank
        calls it: the slices are gathered and rank 0 writes the one layout;
        a synchronous save returns on every rank once it is committed."""
        if self._in_forward:
            raise RuntimeError("save_checkpoint() between forward() and backward(): the step's graph is "
                               "not part of a checkpoint; call backward() and step() first")
        if self._window_stash:
            raise RuntimeError(
                "save_checkpoint() called mid-window: the multi-step window already advanced the model state but "
                f"{len(self._window_stash)} step(s) are uncommitted (counters/lr would be inconsistent); finish "
                "the window's train_batch calls first")
        if tag is None:
            tag = f"global_step{self.global_steps}"
        tag = self._validate_checkpoint_tag(tag)
        path = self._ckpt_dir(save_dir, tag)
        use_async = self._config.checkpoint_config.async_snapshot if asynchronous is None else bool(asynchronous)
        t0 = time.perf_counter()
        state = self._checkpoint_state(client_state)
        if self.dp_rank != 0:
            del state
            if not use_async:
                comm.barrier()
            self._ckpt_metrics["saves"] += 1
            return True
        self.checkpoint_engine.create(tag)
        if not use_async:
            # a synchronous save must not interleave with queued async writes:
            # an older snapshot committing after it would regress `latest`
            self.wait_pending_checkpoint()
        pool = self._pinned if self.device.type == "cuda" else None
        host_state, pinned = host_snapshot(state, pool)
        del state
        release = (lambda: pool.give(pinned)) if pool is not None else None  # noqa: E731
        if use_async:
            stall_ms = (time.perf_counter() - t0) * 1e3
            if self._ckpt_writer is None:
                self._ckpt_writer = AsyncCheckpointWriter(
                    self.checkpoint_engine, max_inflight=self._config.checkpoint_config.max_inflight_snapshots)
            self._ckpt_writer.submit(host_state, path, tag, save_dir if save_latest else None, release=release)
            self._ckpt_metrics["async_saves"] += 1
            self._ckpt_metrics["last_stall_ms"] = stall_ms
            self._ckpt_metrics["total_stall_ms"] += stall_ms
        else:
            try:
                self.checkpoint_engine.save(host_state, path)
                # the commit rename comes before the marker, which may only
                # ever name a committed checkpoint
                self.checkpoint_engine.commit(tag)
                if save_latest:
                    write_latest_marker(save_dir, tag)
            finally:
                if release is not None:
                    release()
                if self.dp > 1:
                    comm.barrier()
            self._ckpt_metrics["last_save_s"] = time.perf_counter() - t0
        self._ckpt_metrics["saves"] += 1
        return True

    def wait_pending_checkpoint(self) -> None:
        """Fence the async writer: returns once every queued snapshot is
        committed; re-raises a background persist failure."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()
            if self._ckpt_writer.saves:
                self._ckpt_metrics["last_save_s"] = self._ckpt_writer.last_save_s

    def checkpoint_stats(self) -> Dict[str, Any]:
        """Save counts, the async snapshot stall (``last_stall_ms``), the
        full persist and restore wall times, and the writer's queue depth
        (JAX ``engine.py:3393-3402``)."""
        out = dict(self._ckpt_metrics)
        out["async_snapshot"] = self._config.checkpoint_config.async_snapshot
        out["pending"] = self._ckpt_writer.pending() if self._ckpt_writer else 0
        return out

    def _validate_checkpoint_tag(self, tag: str) -> str:
        """The cross-rank tag check (JAX ``engine.py:3404-3422``): every
        rank's tag gathered; on a mismatch ``checkpoint.tag_validation``
        ``Fail`` raises and ``Warn`` warns and saves under rank 0's tag (one
        layout under one tag, which rank 0 writes)."""
        if not self._config.checkpoint_tag_validation_enabled or comm.get_world_size() == 1:
            return tag
        tags = comm.all_gather_object(str(tag))
        if any(t != str(tag) for t in tags):
            msg = f"checkpoint tag mismatch across ranks: {tags}"
            if self._config.checkpoint_tag_validation_fail:
                raise RuntimeError(msg)
            logger.warning(msg + f" — saving under rank 0's tag {tags[0]!r}")
            return tags[0]
        return tag

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None, load_module_strict: bool = True,
                        load_optimizer_states: bool = True, load_lr_scheduler_states: bool = True,
                        load_module_only: bool = False, custom_load_fn: Optional[Callable] = None,  # noqa: ARG002
                        auto_resume: bool = False):
        """Load a checkpoint; returns ``(path, client_state)``, or ``(None,
        {})`` when there is nothing to load. ``auto_resume`` scans for the
        newest valid tag (the ``latest`` marker is only a hint) and falls
        back past a tag that turns out torn at load time. With
        ``load_module_strict`` every module leaf is checked against the live
        state first: a mismatch raises one ``CheckpointLoadError`` naming
        the leaf and both shapes or dtypes. The state is written into the
        live tensors, so captured step programs replay the loaded state."""
        if self._window_stash:
            raise RuntimeError(
                f"load_checkpoint() called mid-window: {len(self._window_stash)} computed step(s) are uncommitted; "
                "finish the window's train_batch calls (or rebuild the engine) before loading")
        self.wait_pending_checkpoint()
        if self.dp > 1:  # rank 0's async writes are committed before any rank reads
            comm.barrier()
        t_load = time.perf_counter()
        state = None
        if tag is None:
            if auto_resume:
                for cand in reversed(list_valid_tags(load_dir)):
                    try:
                        state = self.checkpoint_engine.load(self._ckpt_dir(load_dir, cand))
                        tag = cand
                        break
                    except CheckpointCorruptError as e:
                        logger.warning(f"auto_resume: skipping torn checkpoint {cand}: {e}")
                if state is None:
                    logger.warning(f"auto_resume: no valid checkpoint under {load_dir}; nothing loaded "
                                   "(fresh start)")
                    return None, {}
            else:
                tag = read_latest_marker(load_dir)
                if tag is None:
                    logger.warning(f"no 'latest' file at {os.path.join(load_dir, 'latest')}; nothing loaded")
                    return None, {}
        path = self._ckpt_dir(load_dir, tag)
        if state is None:
            state = self.checkpoint_engine.load(path)
        if load_module_strict:
            self._validate_checkpoint_state(state, path)
        full_opt = load_optimizer_states and not load_module_only
        opt = state.get("optimizer")
        if self._param_stream is not None:  # JAX engine.py:3495-3521
            if not (isinstance(opt, dict) and "param_stream" in opt):
                raise NotImplementedError("param-offload load_checkpoint requires a checkpoint saved by the "
                                          "param-offload engine (optimizer['param_stream'])")
            if full_opt:
                self._param_stream.load_state_dict(opt["param_stream"])
            else:  # weights only: fresh moments and step count
                self._param_stream.load_master_state(opt["param_stream"])
        else:
            self._adopt_weights(state)
        if self._host_offload is not None:  # JAX engine.py:3532-3565
            ho = self._host_offload
            if isinstance(opt, dict) and "host_offload" in opt:
                if not full_opt:
                    # a module-only load still refreshes the host master, or the next step would write the
                    # stale one over the loaded weights
                    ho.load_master_only(opt["host_offload"], self._offload_slicer(opt["host_offload"]))
            else:  # a non-offload checkpoint: its master, or (fp32) its module, is the master
                src = flatten_tree(state["master"] if state.get("master") is not None else state["module"])
                ho.set_master_leaves({k: self._own(k, _cpu_tensor(src[k]), self._mdim[k]) for k in ho.names})
            if full_opt and opt is not None:
                ho.load_state_dict(opt["host_offload"], self._offload_slicer(opt["host_offload"]))
        elif self._param_stream is None and full_opt and opt is not None:
            if isinstance(opt, dict) and ("param_stream" in opt or "host_offload" in opt):
                kind = "param_stream" if "param_stream" in opt else "host_offload"
                raise NotImplementedError(
                    f"this checkpoint's optimizer state was saved by the {kind} offload engine and cannot be loaded "
                    "into a non-offload engine; pass load_optimizer_states=False to adopt the module weights with a "
                    "fresh optimizer")
            slicer = None if self.dp == 1 else (lambda k, t: self._own(k, t, self._mdim[k]))
            # into the live tensors: a captured step program reads their storage
            self._opt_state = _copy_opt_state(self._opt_state,
                                              _opt_state_from_tree(opt, self._opt_state, self.device, slicer))
        if state.get("loss_scaler") is not None:
            ls = state["loss_scaler"]
            for t, v in zip(self._scale_state, (float(ls["scale"]), int(ls["good_steps"]), int(ls["hysteresis"]))):
                t.fill_(v)
        if load_lr_scheduler_states and self.lr_scheduler is not None and state.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(state["lr_scheduler"])
        if self.random_ltd_scheduler is not None and state.get("random_ltd"):
            self.random_ltd_scheduler.load_state_dict(state["random_ltd"])
        if not load_module_only:
            self.global_steps = state.get("global_steps", 0)
            self.global_samples = state.get("global_samples", 0)
            self.micro_steps = state.get("micro_steps", 0)
            self.skipped_steps = state.get("skipped_steps", 0)
            self._restore_replay_state(state)
            if self.progressive_layer_drop is not None:
                # theta is a function of global_steps: the first resumed step drops layers as the uninterrupted run
                self.progressive_layer_drop.update_state(self.global_steps)
        with torch.no_grad():  # a loaded state starts at an accumulation boundary
            for g in self._grad_acc.values():
                g.zero_()
        self._in_forward = False
        # the drains and the drained log belong to the abandoned timeline: the resumed run re-drains its steps
        # (JAX engine.py:3620-3635); the look-ahead loader held batches of the old cursor
        self._active_prefetcher = self._prefetch_key = None
        self._pending_drains.clear()
        self._drained_log.clear()
        self._drained_dropped = 0
        self._ckpt_metrics["last_restore_s"] = time.perf_counter() - t_load
        return path, state.get("client_state", {})

    def _offload_slicer(self, rec: Dict[str, Any]):
        """The host-offload engine's reader of a checkpoint's records: this
        rank's slice of each whole leaf (streamed records are whole; legacy
        records are reassembled from their slices first, JAX's
        ``zero_to_fp32`` rule)."""
        if self._streamed_offload:
            return lambda k, whole: self._own(k, whole.reshape(self._shapes[k]), self._mdim[k])
        records = dict(zip(self._host_offload.names, rec["leaves"])) if "leaves" in rec else {}

        def leaf(k, key):
            whole = torch.from_numpy(assemble_records(records[k], key, self._shapes[k]))
            return self._own(k, whole, self._mdim[k]).reshape(-1).numpy()
        return leaf

    @torch.no_grad()
    def _adopt_weights(self, state: Dict) -> None:
        """The module (compute dtype) and the fp32 master, each rank taking
        its slices of the whole arrays. A checkpoint without a master (fp32
        training, or module-only) rebuilds it from the module, or the next
        step would recast the stale one over it. On the offload paths the
        master is the host engine's (``load_checkpoint``)."""
        module = flatten_tree(state["module"])
        master = flatten_tree(state["master"]) if state.get("master") is not None else None
        r, W = self.dp_rank, self.dp
        if self._master is None:
            for k, p in self._params.items():
                if k in module:
                    p.copy_(shard(module[k], self._pdim[k], r, W))
            return
        for k, m in self._master.items():
            if master is not None and k in master:
                m.copy_(self._own(k, master[k], self._mdim[k]))
            elif k in module:
                m.copy_(self._own(k, module[k], self._mdim[k]))
            p = self._params[k]
            if p is not m and k in module:
                p.copy_(self._own(k, module[k], self._pdim[k]))

    def _restore_replay_state(self, state: Dict) -> None:
        """The generator the next microbatch draws its seed from (JAX's PRNG
        key) and the engine dataloader's cursor (JAX ``engine.py:3600-3630``;
        the caller drops the live look-ahead)."""
        rng = state.get("rng")
        if isinstance(rng, dict):
            self._dropout_rng.bit_generator.state = rng
        else:
            logger.warning("checkpoint carries no dropout generator state: resumed dropout masks will "
                           "diverge from the uninterrupted run")
        cursor = state.get("data_cursor")
        if cursor and self.training_dataloader is not None and hasattr(self.training_dataloader, "load_state_dict"):
            self.training_dataloader.load_state_dict(cursor)

    def _validate_checkpoint_state(self, state: Dict, path: str) -> None:
        """Fail fast, with names (JAX ``engine.py:3624-3683``): a checkpoint
        whose mesh or module leaves disagree with the live run raises one
        ``CheckpointLoadError``."""
        saved_mesh = state.get("mesh")
        cur_mesh = self._mesh_shape()
        if saved_mesh is not None and dict(saved_mesh) != cur_mesh:
            raise CheckpointLoadError(
                f"mesh topology mismatch loading {path}: checkpoint was saved on mesh {dict(saved_mesh)} but "
                f"this run uses {cur_mesh}; re-shard the checkpoint or rebuild the engine with the saved "
                "topology")
        module = state.get("module")
        if module is None:
            raise CheckpointLoadError(f"{path} holds no module state")
        if self._params is None:
            return  # offload_param: the layer stream validates its own store
        saved = _flatten_with_paths(module)
        cur = _flatten_with_paths(unflatten_tree({k: torch.empty(self._shapes[k], dtype=p.dtype, device="meta")
                                                  for k, p in self._params.items()}))
        missing = sorted(set(cur) - set(saved))
        extra = sorted(set(saved) - set(cur))
        if missing or extra:
            raise CheckpointLoadError(
                f"module tree mismatch loading {path}: "
                + (f"checkpoint lacks {missing[:3]}" if missing else "")
                + (" and " if missing and extra else "")
                + (f"checkpoint has unknown {extra[:3]}" if extra else "")
                + " (pass load_module_strict=False to adopt loosely)")
        for name, c_leaf in cur.items():
            s_leaf = saved[name]
            s_shape, c_shape = tuple(s_leaf.shape), tuple(c_leaf.shape)
            if s_shape != c_shape:
                raise CheckpointLoadError(
                    f"shape mismatch loading {path} at module leaf {name!r}: checkpoint has {s_shape}, current "
                    f"state has {c_shape} (model config differs from the one that saved this checkpoint)")
            if s_leaf.dtype != c_leaf.dtype:
                raise CheckpointLoadError(
                    f"dtype mismatch loading {path} at module leaf {name!r}: checkpoint has {s_leaf.dtype}, "
                    f"current state has {c_leaf.dtype} (precision config differs from the run that saved this "
                    "checkpoint; pass load_module_strict=False to skip validation)")

    def consolidated_16bit_state_dict(self) -> Dict[str, torch.Tensor]:
        """The compute-dtype weights as a flat ``path -> CPU tensor`` dict in
        JAX's path order (JAX ``engine.py:3685``)."""
        full = self._param_stream.gathered_params() if self._param_stream is not None else self._full_params()
        return {name: t.detach().cpu() for name, t in _flatten_with_paths(unflatten_tree(full)).items()}

    def save_reference_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                                  dp_shards: Optional[int] = None) -> str:
        """Write the reference's training-checkpoint layout
        (``mp_rank_00_model_states.pt``, ``zero_pp_rank_*_optim_states.pt``,
        ``latest``); see ``checkpoint/reference_export.py``."""
        from deepspeed_tpu_torch.checkpoint.reference_export import export_reference_checkpoint

        return export_reference_checkpoint(self, save_dir, tag=tag, dp_shards=dp_shards)

    def save_16bit_model(self, save_dir: str, save_filename: str = "pytorch_model.bin",
                         exclude_frozen_parameters: bool = False):  # noqa: ARG002
        """One consolidated weights file loadable without the engine (JAX
        ``engine.py:3716-3736``): ``.bin`` and ``.pt`` names save a torch
        state dict of fp32 tensors; any other name an ``npz`` of the
        compute-dtype weights under the same flat names (bf16 as the raw
        2-byte values numpy stores for JAX's bf16)."""
        sd = self.consolidated_16bit_state_dict()  # a collective at dp > 1; rank 0 writes
        if self.dp_rank == 0:
            os.makedirs(save_dir, exist_ok=True)
            path = os.path.join(save_dir, save_filename)
            if save_filename.endswith((".bin", ".pt")):
                torch.save({k: v.float().contiguous() for k, v in sd.items()}, path)
            else:
                np.savez(path, **{k: _npz_array(v) for k, v in sd.items()})
        comm.barrier()
        return True


def _opt_state_to_tree(state) -> Dict[str, Any]:
    """An optimizer state (a NamedTuple of scalars and flat ``path ->
    tensor`` dicts) as JAX's ``_namedtuple_to_dict`` of its state: nested
    trees, scalars as 0-d tensors."""
    return {f: unflatten_tree(v) if isinstance(v, dict) else torch.tensor(v.item() if isinstance(v, torch.Tensor) else v)
            for f, v in state._asdict().items()}


def _opt_state_from_tree(tree: Dict[str, Any], like, device, slicer=None) -> Any:
    """The inverse of ``_opt_state_to_tree``, shaped like the live state
    ``like`` and placed on ``device``; ``slicer(path, whole)`` takes this
    rank's slice of a leaf."""
    fields = {}
    for f, cur in like._asdict().items():
        saved = tree[f]
        if isinstance(cur, dict):
            flat = flatten_tree(saved)
            if slicer is not None:
                flat = {k: slicer(k, flat[k]).contiguous() for k in cur}
            fields[f] = {k: flat[k].to(device=device, dtype=t.dtype) for k, t in cur.items()}
        else:
            val = saved.item() if isinstance(saved, torch.Tensor) else saved
            fields[f] = torch.tensor(val, dtype=cur.dtype, device=cur.device) if isinstance(cur, torch.Tensor) \
                else type(cur)(val)
    return type(like)(**fields)


@torch.no_grad()
def _copy_opt_state(live, new):
    """``new`` written into ``live``'s tensors (dict leaves and a tensor
    step count); host scalars are taken as they come. Returns the state to
    keep."""
    fields = {}
    for f, cur in live._asdict().items():
        val = getattr(new, f)
        if isinstance(cur, dict):
            for k, t in cur.items():
                t.copy_(val[k])
            fields[f] = cur
        elif isinstance(cur, torch.Tensor):
            cur.copy_(val)
            fields[f] = cur
        else:
            fields[f] = val
    return type(live)(**fields)


def _sorted_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The nested tree of ``flat`` with every level in sorted key order
    (JAX's tree order, which the offload records' leaf lists follow)."""
    return unflatten_tree(dict(sorted(flat.items())))


def _cpu_tensor(x) -> torch.Tensor:
    return x.detach().cpu().float() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))


def _npz_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as the array ``np.savez`` stores for JAX's leaf of the
    same dtype: bf16 (which numpy lacks) as its raw 2-byte values."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _validate_multi_step_config(cfg: DeepSpeedConfig) -> None:
    """JAX ``_validate_multi_step`` (``engine.py:2083-2180``), the checks a
    config alone decides, made before anything else is built: each of
    these features puts a host decision between optimizer steps, which a
    window removes, so arming both is refused, not worked around."""
    if not cfg.compile_config.multi_step.enable:
        return
    if comm.is_initialized() and comm.get_world_size() > 1:
        raise NotImplementedError(
            "compile.multi_step currently requires a single-process run (the window former stacks the "
            "microbatches of one process); disable multi_step on multi-process launches")
    if (cfg.curriculum_learning_config or {}).get("enabled", False):
        raise ValueError("compile.multi_step is incompatible with curriculum_learning (the per-step seqlen "
                         "schedule changes batch shapes inside the window)")
    if cfg.pld_config.enabled:
        raise ValueError("compile.multi_step is incompatible with progressive_layer_drop (theta is a per-step "
                         "host kwarg)")
    de = cfg.data_efficiency_config or {}
    routing = de.get("data_routing", {})
    if de.get("enabled") and routing.get("enabled") and routing.get("random_ltd", {}).get("enabled"):
        raise ValueError("compile.multi_step is incompatible with random_ltd (per-step host-sampled index shapes "
                         "change the program)")
    shared = (cfg.compression_config or {}).get("weight_quantization", {}).get("shared_parameters", {})
    if shared.get("enabled", False) and not shared.get("quantize_weight_in_forward", False):
        raise ValueError("compile.multi_step is incompatible with MoQ (the host re-quantizes the compute store "
                         "between optimizer steps)")
    z = cfg.zero_config
    if z.zero_quantized_gradients:
        raise ValueError("compile.multi_step is incompatible with zero_quantized_gradients (the qgZ grad path is "
                         "unfused)")
    requested = lambda off: off is not None and str(off.device.value) != "none"  # noqa: E731
    if requested(z.offload_param):
        raise ValueError("compile.multi_step is incompatible with offload_param (the layer stream owns the "
                         "per-microbatch update loop)")
    off = z.offload_optimizer
    if requested(off) and not (off.pipeline and str(off.device.value) == "cpu"):
        raise ValueError("compile.multi_step is incompatible with the LEGACY host-Adam offload (the host owns that "
                         "update loop); the streamed ZeRO-Infinity path (offload_optimizer.device=cpu with "
                         "pipeline_read/pipeline_write) composes with windows")


_ROUTING = ("pld_keep", "ltd_idx")  # the per-microbatch model kwargs a step program takes as inputs


def _truncate_seq(batch, seqlen: int):
    """Every rank >= 2 leaf of the batch cut to ``seqlen`` along dim 1
    (curriculum; JAX ``engine.py:3876``)."""
    def leaf(x):
        if x is not None and np.ndim(x) >= 2 and np.shape(x)[1] > seqlen:
            return x[:, :seqlen]
        return x

    if isinstance(batch, dict):
        return {k: leaf(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(leaf(v) for v in batch)
    return leaf(batch)


def _host_copy(t: torch.Tensor, shape) -> np.ndarray:
    """A host fp32 numpy copy of ``t`` (never a view of live state)."""
    return t.detach().float().cpu().numpy().reshape(shape).copy()


def _as_long(x) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(torch.long)


def _pieces(g: torch.Tensor, state: List[torch.Tensor], chunked: bool):
    """``[g] + state`` whole, or (``chunked``: all of one shape) cut into
    aligned flat pieces of ``_UPDATE_CHUNK`` elements, so that the update's
    temporaries stay small on a large leaf (the ops are elementwise: the
    pieces give the whole leaf's bits)."""
    if not chunked or g.numel() <= _UPDATE_CHUNK:
        yield [g] + list(state)
        return
    flat = [t.view(-1) for t in [g] + list(state)]
    for start in range(0, g.numel(), _UPDATE_CHUNK):
        yield [t[start:start + _UPDATE_CHUNK] for t in flat]


_SIDE_STREAMS: Dict[tuple, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device, use: str) -> "torch.cuda.Stream":
    """The side stream of ``use`` ("warmup": step programs' first calls;
    "h2d": the look-ahead's host-to-device copies), one a device for the
    process: cuBLAS keeps a workspace for every stream it has run on (64 MB
    on an H100) for the life of the process, so a new stream each time
    would hold one more each time."""
    key = (use, torch.cuda.current_device() if device.index is None else device.index)
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(key[1])
    return _SIDE_STREAMS[key]


class _StepProgram:
    """One step program (a fused step or a window): its static input and
    output buffers on the engine's device, and its CUDA graph once
    captured. ``load`` copies a call's inputs in; host inputs go through
    pinned staging buffers, so the copy does not wait for the card."""

    def __init__(self, inputs: Dict[str, torch.Tensor], outputs: Dict[str, tuple], device: torch.device):
        self.device = device
        self.inp = {k: torch.empty(v.shape, dtype=v.dtype, device=device) for k, v in inputs.items()}
        self.out = {k: torch.zeros(shape, dtype=dt, device=device) for k, (shape, dt) in outputs.items()}
        self.graph = None
        self.runs = 0
        cuda = device.type == "cuda"
        self.start = torch.cuda.Event(enable_timing=True) if cuda else None
        self.end = torch.cuda.Event(enable_timing=True) if cuda else None
        self._stage: Dict[str, torch.Tensor] = {}
        self._staged = None  # the event after the last staged copies

    def load(self, inputs: Dict[str, torch.Tensor]) -> None:
        cuda = self.device.type == "cuda"
        if cuda and self._staged is not None:
            self._staged.synchronize()  # the staging buffers' last copies have left
        for k, v in inputs.items():
            dst = self.inp[k]
            if tuple(v.shape) != tuple(dst.shape):
                raise ValueError(f"step program input {k!r}: {tuple(v.shape)} against its buffer {tuple(dst.shape)}")
            if cuda and v.device.type == "cpu":
                st = self._stage.get(k)
                if st is None:
                    st = self._stage[k] = torch.empty(dst.shape, dtype=dst.dtype, pin_memory=True)
                st.copy_(v)
                dst.copy_(st, non_blocking=True)
            else:
                dst.copy_(v)
        if cuda:
            self._staged = torch.cuda.Event()
            self._staged.record()

    def device_ms(self) -> Optional[float]:
        if self.graph is None or self.start is None:
            return None
        self.end.synchronize()
        return self.start.elapsed_time(self.end)

    def drop_graph(self) -> None:
        """Free the captured graph (its pool memory back to the caching
        allocator); the next call captures anew."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None

    def release(self) -> None:
        self.drop_graph()
        self.inp.clear()
        self.out.clear()
        self._stage.clear()


class _Drain:
    """A window's per-step losses, grad norms and overflow flags on their
    way to the host: copied ``non_blocking`` into pinned buffers behind a
    CUDA event, read when ``wait`` is called (one window later)."""

    def __init__(self, vals, base_step: int):
        self.base_step = base_step
        self.event = None
        if vals[0].device.type == "cuda":
            self.host = [torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for v in vals]
            for h, v in zip(self.host, vals):
                h.copy_(v, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [v.clone() for v in vals]

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return [h.tolist() for h in self.host]
