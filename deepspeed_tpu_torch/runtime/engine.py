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

ZeRO stage 1 at a data-parallel world of 1 shards nothing; the engine
records the stage. Stage ≥ 2, a ``torch.distributed`` group of more than
one rank, and the other unported switches raise ``NotImplementedError``
naming their ROADMAP item. The engine runs on ``cuda`` unless the caller
names another device, and raises without a card.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.checkpoint.jax_params import jax_tree_to_tensors, tensors_to_jax_tree, unflatten_tree
from deepspeed_tpu_torch.models.transformer import TransformerLM, _split_batch
from deepspeed_tpu_torch.ops.adam.fused_adam import AdamW, FusedAdam
from deepspeed_tpu_torch.ops.optimizer import DSOptimizer
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, unported_switches
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import CreateLossScaler, has_inf_or_nan
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_scheduler
from deepspeed_tpu_torch.utils.logging import log_dist

# "adam" is FusedAdam with decoupled decay, as in JAX (engine.py:118-120)
_OPTIMIZERS = {
    C.ADAM_OPTIMIZER: FusedAdam,
    C.ADAMW_OPTIMIZER: AdamW,
    C.FUSED_ADAM_OPTIMIZER: FusedAdam,
}
_UNPORTED_OPTIMIZERS = {
    C.CPU_ADAM_OPTIMIZER: "T2", C.CPU_ADAGRAD_OPTIMIZER: "T2", C.ADAGRAD_OPTIMIZER: "X1",
    C.LAMB_OPTIMIZER: "X1", C.FUSED_LAMB_OPTIMIZER: "X1", C.SGD_OPTIMIZER: "X1",
    C.ONEBIT_ADAM_OPTIMIZER: "P1", C.ONEBIT_LAMB_OPTIMIZER: "P1", C.ZERO_ONE_ADAM_OPTIMIZER: "P1",
    C.LION_OPTIMIZER: "X1",
}
_ACC_DTYPES = {"fp32": torch.float32, "float32": torch.float32, "bf16": torch.bfloat16,
               "bfloat16": torch.bfloat16, "fp16": torch.float16, "float16": torch.float16}


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
        if torch.distributed.is_available() and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            raise NotImplementedError("multi-rank data parallelism (the ZeRO-1 owner-shard update over "
                                      "torch.distributed) is not ported yet (ROADMAP T2)")
        self.module = model
        self.device = resolve_device(device)
        self.attn_impl = attn_impl
        self._config.resolve_batch_triad(1)

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
        self._master = jax_tree_to_tensors(model.config, model_parameters, device=self.device,
                                           dtype=torch.float32)
        if self.mixed_precision:
            self._params = {k: m.to(self.compute_dtype).requires_grad_(True) for k, m in self._master.items()}
        else:
            self._params = {k: m.requires_grad_(True) for k, m in self._master.items()}
        self._param_tree = unflatten_tree(self._params)
        self._opt_state = self.optimizer.init_state(self._master)
        self._grad_acc = {k: torch.zeros(p.shape, dtype=self._acc_dtype, device=self.device)
                          for k, p in self._params.items()}
        self._scale_state = self.loss_scaler.init_state()
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
        return 1

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
        return sum(p.numel() for p in self._master.values())

    def get_params(self):
        """The compute-dtype tree as numpy (bf16 widened to fp32 exactly)."""
        return tensors_to_jax_tree(self._params)

    def get_master_params(self):
        """The fp32 master tree as numpy."""
        return tensors_to_jax_tree(self._master)

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
        """Tokens and labels as int64 tensors on the engine's device."""
        def place(x):
            if x is None:
                return None
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
            return t.to(device=self.device, dtype=torch.long, non_blocking=True)

        tokens, labels = _split_batch(batch)
        return place(tokens), place(labels)

    # --- the step ------------------------------------------------------------
    def __call__(self, batch):
        return self.forward(batch)

    def forward(self, batch):
        """Training: the microbatch's loss with its graph (call ``backward``
        then ``step``). Eval: the loss (or logits without labels), no graph."""
        tokens, labels = self._place(batch)
        model_batch = tokens if labels is None else (tokens, labels)
        if not self._training_mode:
            with torch.no_grad():
                return self.module.apply(self._param_tree, model_batch, train=False, attn_impl=self.attn_impl)
        if labels is None:
            raise ValueError("training expects (tokens, labels) batches (a dict with input_ids/labels, "
                             "or a 2-tuple)")
        if self._in_forward:
            raise RuntimeError("forward() called again before backward()")
        seed = int(self._dropout_rng.integers(0, 2**62))
        loss = self.module.apply(self._param_tree, model_batch, dropout_seed=seed, train=True,
                                 attn_impl=self.attn_impl)
        self._in_forward = True
        return loss

    def backward(self, loss, retain_graph: bool = False):
        """Back-propagate ``loss × scale`` and move every leaf's gradient
        into the accumulation buffer."""
        if not self._training_mode:
            raise RuntimeError("backward() called in eval mode")
        if not self._in_forward:
            raise RuntimeError("backward() called before forward()")
        scale = torch.tensor(self._scale_state.scale, dtype=torch.float32, device=loss.device)
        (loss.float() * scale).backward(retain_graph=retain_graph)
        with torch.no_grad():
            for k, p in self._params.items():
                if p.grad is not None:
                    self._grad_acc[k].add_(p.grad.to(self._acc_dtype))
                    p.grad = None
        self._in_forward = False
        return loss

    def step(self, lr_kwargs=None):  # noqa: ARG002
        if self._in_forward:
            raise RuntimeError("step() called before backward()")
        if self.is_gradient_accumulation_boundary():
            self._take_model_step()
        self.micro_steps += 1
        self.global_samples += self.train_micro_batch_size_per_gpu()

    @torch.no_grad()
    def _update_from_grads(self, lr: float):
        """One optimizer update from the accumulation buffer (see the module
        docstring). Returns the overflow flag (always False outside fp16)."""
        gas = self.gradient_accumulation_steps()
        inv = float(np.float32(1.0) / (np.float32(self._scale_state.scale) * np.float32(gas)))
        grads = {k: g.float() * inv for k, g in self._grad_acc.items()}
        overflow = bool(has_inf_or_nan(grads.values())) if self._config.fp16_enabled else False
        sq = torch.stack([torch.sum(torch.square(g)) for g in grads.values()]).sum()
        grad_norm = torch.sqrt(sq)
        clip = self._config.gradient_clipping
        if clip > 0:
            coef = torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
            grads = {k: g * coef for k, g in grads.items()}
        if not overflow:
            new_master, self._opt_state = self.optimizer.apply(grads, self._opt_state, self._master, lr)
            for k, m in self._master.items():
                m.copy_(new_master[k])
                if self.mixed_precision:
                    self._params[k].copy_(m)
        self._scale_state = self.loss_scaler.update(self._scale_state, overflow)
        for g in self._grad_acc.values():
            g.zero_()
        self._last_grad_norm = grad_norm
        return overflow

    def _take_model_step(self) -> None:
        overflow = self._update_from_grads(self.optimizer.param_groups[0]["lr"])
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

    # --- not ported yet ----------------------------------------------------------
    def deepspeed_io(self, *args, **kwargs):  # noqa: ARG002
        raise NotImplementedError("deepspeed_io / the engine dataloader is not ported yet (ROADMAP T5)")

    def save_checkpoint(self, *args, **kwargs):  # noqa: ARG002
        raise NotImplementedError("checkpointing is not ported yet (ROADMAP T3)")

    def load_checkpoint(self, *args, **kwargs):  # noqa: ARG002
        raise NotImplementedError("checkpointing is not ported yet (ROADMAP T3)")
