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

The unported switches raise ``NotImplementedError`` naming their ROADMAP
item. The engine runs on ``cuda`` unless the caller names another device,
and raises without a card.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.checkpoint.jax_params import (
    flatten_tree,
    jax_tree_to_tensors,
    tensors_to_jax_tree,
    unflatten_tree,
)
from deepspeed_tpu_torch.models.transformer import TransformerLM, _split_batch
from deepspeed_tpu_torch.ops.adagrad.cpu_adagrad import DeepSpeedCPUAdagrad
from deepspeed_tpu_torch.ops.adam.fused_adam import AdamState, AdamW, FusedAdam
from deepspeed_tpu_torch.ops.optimizer import DSOptimizer
from deepspeed_tpu_torch.parallel.mesh import build_topology
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
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import CreateLossScaler, LossScaleState, has_inf_or_nan
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_scheduler
from deepspeed_tpu_torch.runtime.zero.host_offload import HostOffloadStreamer
from deepspeed_tpu_torch.runtime.zero.offload_states import HostOffloadAdam, assemble_records
from deepspeed_tpu_torch.runtime.zero.overlap import GradBuckets, build_overlap_plan, gather_full, split_buckets
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
    C.LION_OPTIMIZER: "X1",
}
_ACC_DTYPES = {"fp32": torch.float32, "float32": torch.float32, "bf16": torch.bfloat16,
               "bfloat16": torch.bfloat16, "fp16": torch.float16, "float16": torch.float16}
_IGNORE_INDEX = -100  # models.transformer.cross_entropy_loss


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
                 attn_impl: Optional[str] = None):
        if not isinstance(model, TransformerLM):
            raise NotImplementedError("deepspeed_tpu_torch trains its own TransformerLM; other modules "
                                      "are not ported yet (ROADMAP X1)")
        self._config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config or {})
        unported = unported_switches(self._config)
        if unported:
            raise NotImplementedError("not ported to deepspeed_tpu_torch yet: " + "; ".join(unported))
        self.topo = build_topology(self._config.mesh_config)
        self.dp = self.topo.get_data_parallel_world_size()
        self.dp_rank = comm.get_rank() if self.dp > 1 else 0
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
        self._scale_state = self.loss_scaler.init_state()

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
        log_dist(
            f"DeepSpeedEngine: zero_stage={self.zero_optimization_stage()} dtype={self.compute_dtype} "
            f"device={self.device} batch triad=({self.train_batch_size()},"
            f"{self.train_micro_batch_size_per_gpu()},{self.gradient_accumulation_steps()}) "
            f"params={self.num_parameters():,}",
            ranks=[0],
        )

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
            self._host_offload.set_master_leaves({k: shard(full[k], self._mdim[k], r, W) for k in self._shapes})
            for k, p in self._params.items():
                p.copy_(shard(full[k], self._pdim[k], r, W))
            return
        for k, m in self._master.items():
            m.copy_(shard(full[k], self._mdim[k], r, W))
            p = self._params[k]
            if p is not m:
                p.copy_(shard(full[k], self._pdim[k], r, W))

    # --- the state and its slices ------------------------------------------
    @torch.no_grad()
    def _init_state(self, full: Dict[str, torch.Tensor]) -> None:
        """Master, compute store, optimizer state and accumulators, each
        leaf this rank's slice as the ZeRO stage places it (whole at one
        rank: the master is ``full`` itself, and in fp32 the compute store
        is the master)."""
        zc = self._config.zero_config
        part = ZeroPartitioner(zc, self.topo)
        self._shapes = {k: tuple(t.shape) for k, t in full.items()}
        self._pdim = part.dims(part.param_specs(self._shapes))
        self._mdim = part.dims(part.master_specs(self._shapes))
        self._gdim = part.dims(part.grad_accum_specs(self._shapes))
        r, W = self.dp_rank, self.dp
        self._master = {k: t if self._mdim[k] is None else shard(t, self._mdim[k], r, W).clone()
                        for k, t in full.items()}
        self._params = {}
        for k, t in full.items():
            if not self.mixed_precision and self._pdim[k] == self._mdim[k]:
                self._params[k] = self._master[k].requires_grad_(True)
            elif self._pdim[k] is None:
                self._params[k] = t.to(self.compute_dtype).requires_grad_(True)
            else:
                self._params[k] = shard(t, self._pdim[k], r, W).to(self.compute_dtype).clone().requires_grad_(True)
        self._param_tree = unflatten_tree(self._params)
        # the offload paths keep the moments on the host
        self._opt_state = None if self._offload_enabled() else self.optimizer.init_state(self._master)
        self._grad_acc = {k: torch.zeros(shard_shape(self._shapes[k], self._gdim[k], W), dtype=self._acc_dtype,
                                         device=self.device) for k in self._params}
        self._plan = build_overlap_plan(zc, self._params, self._pdim, self.module.config.num_layers,
                                        self._acc_dtype) if W > 1 else None
        # stage >= 2 with overlap_comm: each gradient joins a reduce bucket as backward accumulates it
        self._buckets: Optional[GradBuckets] = None
        self._eager_buckets = W > 1 and self.zero_optimization_stage() >= 2 and zc.overlap_comm and zc.reduce_scatter
        if self._eager_buckets:
            for k, p in self._params.items():
                if self._plan is None or self._pdim[k] is None:
                    p.register_post_accumulate_grad_hook(self._grad_ready(k))

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
        inv = 1.0 / (float(self._scale_state.scale) * gas * dp)
        acc = self._grad_acc
        if dp > 1 and stage >= 2:
            parts = [torch.sum(torch.square(g.float())) for k, g in acc.items() if self._gdim[k] is not None or r == 0]
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
        self._scale_state = self.loss_scaler.update(self._scale_state, overflow)
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
        overflow, grad_norm, coef = self._grad_stats(lambda: ((k, g.float() * inv) for k, g in acc.items()))
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
        self._scale_state = self.loss_scaler.update(self._scale_state, overflow)
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
        tokens, labels, share = self._place(batch)
        if self._param_stream is not None:
            return self._stream_forward(tokens, labels, share)
        model_batch = tokens if labels is None else (tokens, labels)
        if not self._training_mode:
            with torch.no_grad():
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
        seed = int(self._dropout_rng.integers(0, 2**62))
        tree, stream = self._model_tree(True)
        loss = self.module.apply(tree, model_batch, dropout_seed=seed, train=True, attn_impl=self.attn_impl,
                                 **stream)
        if self.dp > 1:
            # back-propagate this rank's token sum over the global count times dp (its mean when every
            # rank holds as many tokens: a factor of exactly 1); report the global mean
            value = comm.all_reduce(loss.detach().float() * share)
            loss = _GlobalLoss.apply(loss * (share * self.dp).to(loss.dtype), value.to(loss.dtype))
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
        scale = torch.tensor(self._scale_state.scale, dtype=torch.float32, device=loss.device)
        # stage 3's sharded leaves are reduced by the plan as backward passes each layer; the rest
        # accumulate whole (stages 0-1, reduced at the boundary) or go through the reduce buckets
        # (stage >= 2 at dp > 1)
        cap = self._config.zero_config.reduce_bucket_size
        if self._eager_buckets:
            self._buckets = GradBuckets(self._gdim, cap, eager=True)
        if self._plan is not None:
            self._plan.in_backward = True
        try:
            (loss.float() * scale).backward(retain_graph=retain_graph)
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
                g = p.grad.to(self._acc_dtype)
                p.grad = None
                if buckets is not None:
                    buckets.add(k, g)
                else:
                    self._grad_acc[k].add_(g)
            if buckets is not None:
                for k, g in buckets.finish().items():
                    self._grad_acc[k].add_(g)
        self._in_forward = False
        return loss

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
    def _update_from_grads(self, lr: float):
        """One optimizer update from the accumulation buffer (see the module
        docstring). Returns the overflow flag (always False outside fp16)."""
        dp, r = self.dp, self.dp_rank
        inv = self._unscale_inv()
        grads = {k: g.float() * inv for k, g in self._grad_acc.items()}
        overflow, grad_norm, coef = self._grad_stats(lambda: grads.items())
        if coef is not None:
            grads = {k: g * coef for k, g in grads.items()}
        if not overflow:
            # the owner-shard update: this rank's slice of each (whole) gradient
            grads = {k: shard(g, self._mdim[k], r, dp) if self._gdim[k] is None else g for k, g in grads.items()}
            new_master, self._opt_state = self.optimizer.apply(grads, self._opt_state, self._master, lr)
            for k, m in self._master.items():
                m.copy_(new_master[k])
            self._refresh_params()
        self._scale_state = self.loss_scaler.update(self._scale_state, overflow)
        for g in self._grad_acc.values():
            g.zero_()
        self._last_grad_norm = grad_norm
        return overflow

    def _unscale_inv(self) -> float:
        """``1 / (scale · gas [· dp])`` in fp32, after summing the whole
        accumulators over the ranks at stages 0-1."""
        denom = np.float32(self._scale_state.scale) * np.float32(self.gradient_accumulation_steps())
        if self.dp > 1:
            denom = denom * np.float32(self.dp)  # the gradients are summed over the ranks
            if self.zero_optimization_stage() <= 1:
                self._all_reduce_accum()
        return float(np.float32(1.0) / denom)

    def _grad_stats(self, grads: Callable):
        """``(overflow, grad_norm, clip coefficient or None)`` of the unscaled
        fp32 gradients ``grads()`` yields as ``(name, tensor)`` pairs (called
        once for the flag, once for the norm)."""
        dp, r = self.dp, self.dp_rank
        overflow = False
        if self._config.fp16_enabled:
            flag = has_inf_or_nan(g for _, g in grads())
            if dp > 1:  # every rank skips together
                flag = comm.all_reduce(flag.float(), op=comm.ReduceOp.MAX)
            overflow = bool(flag)
        if dp > 1 and self.zero_optimization_stage() >= 2:
            # the global norm from the slices' squares (a replicated leaf counted on rank 0 only)
            parts = [torch.sum(torch.square(g)) for k, g in grads() if self._gdim[k] is not None or r == 0]
            sq = comm.all_reduce(torch.stack(parts).sum() if parts else torch.zeros((), device=self.device))
        else:
            sq = torch.stack([torch.sum(torch.square(g)) for _, g in grads()]).sum()
        grad_norm = torch.sqrt(sq)
        clip = self._config.gradient_clipping
        coef = torch.clamp(clip / (grad_norm + 1e-6), max=1.0) if clip > 0 else None
        return overflow, grad_norm, coef

    def _all_reduce_accum(self) -> None:
        """Stages 0-1: sum the whole accumulators over the ranks, one
        all-reduce a bucket of ``reduce_bucket_size`` elements."""
        names = list(self._grad_acc)
        for bucket in split_buckets([self._grad_acc[k].numel() for k in names],
                                    self._config.zero_config.reduce_bucket_size):
            comm.all_reduce_coalesced([self._grad_acc[names[i]] for i in bucket])

    def _take_model_step(self) -> None:
        lr = self.optimizer.param_groups[0]["lr"]
        if self._param_stream is not None:
            grad_norm, overflow = self._param_stream.step(lr, float(self._scale_state.scale),
                                                          self._config.gradient_clipping)
            self._last_grad_norm = torch.tensor(grad_norm, dtype=torch.float32)
            self._scale_state = self.loss_scaler.update(self._scale_state, overflow)
        elif self._streamed_offload:
            overflow = self._take_streamed_offload_step(lr)
        elif self._host_offload is not None:
            overflow = self._take_offload_step(lr)
        else:
            overflow = self._update_from_grads(lr)
        # the preemption instant: the master holds the update, nothing of the
        # step is committed on the host yet
        chaos.point("train.mid_step")
        self.global_steps += 1
        if overflow:
            self.skipped_steps += 1
            log_dist(f"[deepspeed_tpu_torch] OVERFLOW! skipping step, new loss scale: {self.loss_scale}",
                     ranks=[0])
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()

    def train_batch(self, data_iter=None, batch=None):
        """One optimizer step over ``gas`` microbatches: ``batch`` is the
        full-step batch (its leading dim is sliced into ``gas`` microbatches),
        or ``data_iter`` yields the microbatches. Returns the mean loss."""
        gas = self.gradient_accumulation_steps()
        if batch is not None:
            micro = self._split_step_batch(batch, gas)
        elif data_iter is not None:
            micro = [next(data_iter) for _ in range(gas)]
        else:
            raise ValueError("train_batch needs data_iter or batch")
        losses = []
        for b in micro:
            loss = self.forward(b)
            self.backward(loss)
            self.step()
            losses.append(loss.detach())
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
            "random_ltd": None,
            "moq": None,
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
            # exact-resume replay state: the dropout generator the next
            # microbatch draws its seed from (JAX's PRNG key), no data cursor
            # (the port has no engine dataloader), the one-rank mesh
            "rng": self._dropout_rng.bit_generator.state,
            "data_cursor": None,
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
            slice_shape = shard(torch.empty(self._shapes[k], device="meta"), self._mdim[k], self.dp_rank, self.dp).shape
            rec = {f: self._gather_host({k: torch.from_numpy(a).reshape(slice_shape)})[k].cpu().reshape(-1)
                   for f, a in ho.leaf_state(k).items()}
            leaves.append([dict(index=[(None, None)] * len(self._shapes[k]), **rec)])
        return {"step": ho.step_count, "leaves": leaves}

    def _mesh_shape(self) -> Dict[str, int]:
        return {"data": self.dp}

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
        the leaf and both shapes or dtypes."""
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
                ho.set_master_leaves({k: shard(_cpu_tensor(src[k]), self._mdim[k], self.dp_rank, self.dp)
                                      for k in ho.names})
            if full_opt and opt is not None:
                ho.load_state_dict(opt["host_offload"], self._offload_slicer(opt["host_offload"]))
        elif self._param_stream is None and full_opt and opt is not None:
            if isinstance(opt, dict) and ("param_stream" in opt or "host_offload" in opt):
                kind = "param_stream" if "param_stream" in opt else "host_offload"
                raise NotImplementedError(
                    f"this checkpoint's optimizer state was saved by the {kind} offload engine and cannot be loaded "
                    "into a non-offload engine; pass load_optimizer_states=False to adopt the module weights with a "
                    "fresh optimizer")
            slicer = None if self.dp == 1 else (lambda k, t: shard(t, self._mdim[k], self.dp_rank, self.dp))
            self._opt_state = _opt_state_from_tree(opt, self._opt_state, self.device, slicer)
        if state.get("loss_scaler") is not None:
            ls = state["loss_scaler"]
            self._scale_state = LossScaleState(scale=float(ls["scale"]), good_steps=int(ls["good_steps"]),
                                               hysteresis=int(ls["hysteresis"]))
        if load_lr_scheduler_states and self.lr_scheduler is not None and state.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(state["lr_scheduler"])
        if not load_module_only:
            self.global_steps = state.get("global_steps", 0)
            self.global_samples = state.get("global_samples", 0)
            self.micro_steps = state.get("micro_steps", 0)
            self.skipped_steps = state.get("skipped_steps", 0)
            self._restore_replay_state(state)
        with torch.no_grad():  # a loaded state starts at an accumulation boundary
            for g in self._grad_acc.values():
                g.zero_()
        self._in_forward = False
        self._ckpt_metrics["last_restore_s"] = time.perf_counter() - t_load
        return path, state.get("client_state", {})

    def _offload_slicer(self, rec: Dict[str, Any]):
        """The host-offload engine's reader of a checkpoint's records: this
        rank's slice of each whole leaf (streamed records are whole; legacy
        records are reassembled from their slices first, JAX's
        ``zero_to_fp32`` rule)."""
        r, W = self.dp_rank, self.dp
        if self._streamed_offload:
            return lambda k, whole: shard(whole.reshape(self._shapes[k]), self._mdim[k], r, W)
        records = dict(zip(self._host_offload.names, rec["leaves"])) if "leaves" in rec else {}

        def leaf(k, key):
            whole = torch.from_numpy(assemble_records(records[k], key, self._shapes[k]))
            return shard(whole, self._mdim[k], r, W).reshape(-1).numpy()
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
                m.copy_(shard(master[k], self._mdim[k], r, W))
            elif k in module:
                m.copy_(shard(module[k], self._mdim[k], r, W))
            p = self._params[k]
            if p is not m and k in module:
                p.copy_(shard(module[k], self._pdim[k], r, W))

    def _restore_replay_state(self, state: Dict) -> None:
        """The dropout generator the next microbatch draws from (JAX's PRNG
        key); the port has no data cursor to restore."""
        rng = state.get("rng")
        if isinstance(rng, dict):
            self._dropout_rng.bit_generator.state = rng
        else:
            logger.warning("checkpoint carries no dropout generator state: resumed dropout masks will "
                           "diverge from the uninterrupted run")

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

    # --- not ported yet ----------------------------------------------------------
    def deepspeed_io(self, *args, **kwargs):  # noqa: ARG002
        raise NotImplementedError("deepspeed_io / the engine dataloader is not ported yet (ROADMAP T5)")


def _opt_state_to_tree(state) -> Dict[str, Any]:
    """An optimizer state (a NamedTuple of scalars and flat ``path ->
    tensor`` dicts) as JAX's ``_namedtuple_to_dict`` of its state: nested
    trees, scalars as 0-d tensors."""
    return {f: unflatten_tree(v) if isinstance(v, dict) else torch.tensor(v) for f, v in state._asdict().items()}


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
            fields[f] = type(cur)(saved.item() if isinstance(saved, torch.Tensor) else saved)
    return type(like)(**fields)


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
