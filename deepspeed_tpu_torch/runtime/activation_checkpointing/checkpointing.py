"""Activation checkpointing, the user-facing remat API.

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing/
checkpointing.py`` (the reference's ``configure``, ``checkpoint``,
``CheckpointFunction``), over ``torch.utils.checkpoint`` with
``use_reentrant=False``, as the model's own remat runs
(``models/transformer.py``). A region's activations are recomputed in the
backward pass instead of stored, and a *policy* chooses what is kept.

JAX's policy names map to what PyTorch can say:

* ``default``, ``nothing`` (``nothing_saveable``): keep nothing inside the
  region, recompute everything (plain ``checkpoint``);
* ``everything`` (``everything_saveable``): keep everything, which is no
  checkpoint at all (the function runs as it is);
* ``dots`` (``checkpoint_dots``): keep the products (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``), recompute the rest, through PyTorch's selective
  checkpoint (``create_selective_checkpoint_contexts``);
* ``dots_no_batch`` (``checkpoint_dots_with_no_batch_dims``): keep the
  products without a batch dimension (``mm``, ``addmm``).

Any other name raises ``ValueError``: JAX warns and saves nothing, but a
policy the port cannot express is never ignored. ``cpu_checkpointing``
keeps the region's saved inputs in pinned host memory
(``torch.autograd.graph.save_on_cpu``), the reference's checkpoints in CPU.
``partition_activations``, ``contiguous_memory_optimization``,
``number_checkpoints`` and ``synchronize_checkpoint_boundary`` are kept and
reported, as JAX does, and change nothing on one card.

Recomputation replays the region with the same inputs. The port's dropout
masks are a function of a seed passed in (``models/transformer.py``), so
the region runs with ``preserve_rng_state=False`` and
``model_parallel_cuda_manual_seed`` has no global generator to fork, as in
JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from deepspeed_tpu_torch.utils.logging import logger

_config: dict = {
    "partition_activations": False,
    "cpu_checkpointing": False,
    "contiguous_memory_optimization": False,
    "number_checkpoints": None,
    "synchronize_checkpoint_boundary": False,
    "profile": False,
}
_configured = False

# JAX's policy knobs and jax.checkpoint_policies names -> the port's policies
_POLICIES = {
    "default": "nothing",
    "nothing": "nothing",
    "nothing_saveable": "nothing",
    "everything": "everything",
    "everything_saveable": "everything",
    "dots": "dots",
    "checkpoint_dots": "dots",
    "dots_no_batch": "dots_no_batch",
    "checkpoint_dots_with_no_batch_dims": "dots_no_batch",
}
_SAVED_OPS = {
    "dots": ("mm", "addmm", "bmm", "baddbmm"),
    "dots_no_batch": ("mm", "addmm"),
}


def configure(
    mpu_=None,  # noqa: ARG001 - reference parity
    deepspeed_config=None,
    partition_activations: Optional[bool] = None,
    contiguous_checkpointing: Optional[bool] = None,
    num_checkpoints: Optional[int] = None,
    checkpoint_in_cpu: Optional[bool] = None,
    synchronize: Optional[bool] = None,
    profile: Optional[bool] = None,
) -> None:
    """JAX ``configure`` (reference :1055): from a ``DeepSpeedConfig``'s
    ``activation_checkpointing`` section and/or keyword arguments."""
    global _configured
    cfg = getattr(deepspeed_config, "activation_checkpointing_config", None) if deepspeed_config is not None else None
    if cfg is not None:
        _config["partition_activations"] = cfg.partition_activations
        _config["cpu_checkpointing"] = cfg.cpu_checkpointing
        _config["contiguous_memory_optimization"] = cfg.contiguous_memory_optimization
        _config["number_checkpoints"] = cfg.number_checkpoints
        _config["synchronize_checkpoint_boundary"] = cfg.synchronize_checkpoint_boundary
        _config["profile"] = cfg.profile
    for key, val in (("partition_activations", partition_activations),
                     ("contiguous_memory_optimization", contiguous_checkpointing),
                     ("number_checkpoints", num_checkpoints), ("cpu_checkpointing", checkpoint_in_cpu),
                     ("synchronize_checkpoint_boundary", synchronize), ("profile", profile)):
        if val is not None:
            _config[key] = val
    _configured = True
    logger.info(f"activation checkpointing configured: {_config}")


def is_configured() -> bool:
    return _configured


def get_partition_activations() -> bool:
    return _config["partition_activations"]


def policy_from_name(name: Optional[str]) -> str:
    """The port's policy for a JAX policy knob or ``jax.checkpoint_policies``
    name (``None`` is ``default``); raises ``ValueError`` for a name PyTorch
    cannot express."""
    if name is None:
        return "nothing"
    if name not in _POLICIES:
        raise ValueError(f"remat policy {name!r} has no PyTorch counterpart in the port (known: "
                         f"{sorted(_POLICIES)}); it is refused rather than ignored")
    return _POLICIES[name]


def _context_fn(policy: str):
    ops = _SAVED_OPS.get(policy)
    if ops is None:
        return None
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    saved = tuple(getattr(torch.ops.aten, op).default for op in ops)

    def decide(ctx, op, *args, **kwargs):  # noqa: ARG001
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return lambda: create_selective_checkpoint_contexts(decide)


def remat(function: Callable, *args, policy: Optional[str] = None, **kwargs) -> Any:
    """``function`` rematerialized under ``policy`` alone (``configure``'s
    knobs play no part): the model's per-layer remat
    (``TransformerConfig.remat_policy``, as JAX's model reads it)."""
    pol = policy_from_name(policy)
    if pol == "everything":
        return function(*args, **kwargs)
    extra = {}
    ctx = _context_fn(pol)
    if ctx is not None:
        extra["context_fn"] = ctx
    return _torch_checkpoint(function, *args, use_reentrant=False, preserve_rng_state=False, **extra, **kwargs)


def _run(function: Callable, policy: Optional[str], args, kwargs) -> Any:
    if _config["cpu_checkpointing"]:
        with torch.autograd.graph.save_on_cpu(pin_memory=torch.cuda.is_available()):
            return remat(function, *args, policy=policy, **kwargs)
    return remat(function, *args, policy=policy, **kwargs)


def checkpoint(function: Callable, *args, policy: Optional[str] = None, **kwargs) -> Any:
    """A rematerialized call (reference ``checkpoint`` :954): the
    activations inside ``function`` are recomputed in backward instead of
    stored, except what ``policy`` keeps (``configure``'s default: keep
    nothing)."""
    return _run(function, policy, args, kwargs)


def checkpoint_wrapper(function: Callable, policy: Optional[str] = None) -> Callable:
    """The decorator form: ``function`` rematerialized."""
    policy_from_name(policy)  # an unknown name raises here, not at the first call

    def wrapped(*args, **kwargs):
        return _run(function, policy, args, kwargs)

    return wrapped


class CheckpointFunction:
    """The reference's autograd.Function surface (:475):
    ``CheckpointFunction.apply(run_fn, *args)`` remats ``run_fn``."""

    @staticmethod
    def apply(run_function: Callable, *args) -> Any:
        return checkpoint(run_function, *args)


def model_parallel_cuda_manual_seed(seed: int) -> None:  # noqa: ARG001
    """Reference :320, a no-op as in JAX: the port's dropout takes its seed
    as a value, so there is no global generator to fork per rank."""


def reset() -> None:
    """Reset between configs (reference ``reset`` :1040)."""
    global _configured
    _configured = False
