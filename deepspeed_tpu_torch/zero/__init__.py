"""The ``zero`` namespace (JAX ``deepspeed_tpu/zero/__init__.py``, the
reference's ``deepspeed/runtime/zero/__init__.py`` re-exports).

* ``Init``: the construction context, with JAX's nesting depth (an inner
  exit leaves the outer context active; ``enabled=False`` is inert). The
  engine builds every model's state sharded by the ZeRO stage, so the
  context carries intent only. ``initialize`` pauses a live context around
  engine construction and restores it (``shutdown_init_context`` /
  ``restore_init_context``).
* ``GatheredParameters``: the full parameter tree as host numpy arrays on
  enter (with ``engine=``: ``engine.get_params()``, gathered across the
  ZeRO ranks on every rank). With ``modifier_rank`` set, on exit that
  rank's tree is broadcast to every rank of the engine and
  ``engine.set_params`` re-partitions it (master and compute store
  refreshed, the Adam moments kept); a ``write_back`` callback takes a
  partial tree instead. ``modifier_rank`` on a partial tree with no way
  to write it back raises ``ValueError``, as in JAX.
* the re-exports: ``ZeroPartitioner``, ``estimate_zero_memory``,
  ``DeepSpeedZeroConfig``, ``ZeroStageEnum``, the offload config classes
  (the engine builds the offload paths from them), ``TiledLinear``
  and ``TiledLinearReturnBias``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import numpy as np

from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig, ZeroStageEnum
from deepspeed_tpu_torch.runtime.zero.offload_config import (
    DeepSpeedZeroOffloadOptimizerConfig,
    DeepSpeedZeroOffloadParamConfig,
    OffloadDeviceEnum,
)
from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartitioner, estimate_zero_memory
from deepspeed_tpu_torch.runtime.zero.tiling import (
    TiledLinear,
    TiledLinearReturnBias,
    partition_uniform,
    split_tensor_along_last_dim,
)

_init_ctx_depth = 0


class Init(contextlib.AbstractContextManager):
    """The construction context (reference ``partition_parameters.py:709``),
    nesting-safe through a depth counter."""

    def __init__(self, module=None, data_parallel_group=None, mem_efficient_linear=True,  # noqa: ARG002
                 remote_device=None, pin_memory=False, config_dict_or_path=None, config=None,  # noqa: ARG002
                 enabled=True, dtype=None, mpu=None):  # noqa: ARG002
        self.enabled = enabled

    def __enter__(self):
        global _init_ctx_depth
        if self.enabled:
            _init_ctx_depth += 1
        return self

    def __exit__(self, *exc):
        global _init_ctx_depth
        if self.enabled and _init_ctx_depth > 0:
            _init_ctx_depth -= 1
        return False


def is_init_context_active() -> bool:
    return _init_ctx_depth > 0


def shutdown_init_context() -> int:
    """Pause the context; returns the depth for ``restore_init_context``."""
    global _init_ctx_depth
    prior = _init_ctx_depth
    _init_ctx_depth = 0
    return prior


def restore_init_context(depth: int) -> None:
    global _init_ctx_depth
    _init_ctx_depth = depth


def _structure(tree: Any) -> Any:
    """The nesting of a tree of dicts, without its leaves (JAX's treedef)."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def _host_copy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):
        tree = tree.detach().float().cpu().numpy()
    return np.array(tree)


class GatheredParameters(contextlib.AbstractContextManager):
    """Yield the full parameters as host numpy arrays (reference
    ``partition_parameters.py:1938``; see the module docstring)."""

    def __init__(self, params: Any = None, modifier_rank: Optional[int] = None, fwd_module=None,  # noqa: ARG002
                 enabled: bool = True, write_back=None, engine=None):
        self.engine = engine
        if params is None:
            if engine is None:
                raise ValueError("GatheredParameters needs params or engine")
            self._is_full_tree = True
        else:
            self._is_full_tree = engine is not None and _structure(params) == engine.get_param_treedef()
        self.params = params
        self.modifier_rank = modifier_rank
        self.enabled = enabled
        self.write_back = write_back
        self.gathered = None
        if enabled and modifier_rank is not None and write_back is None and not self._is_full_tree:
            raise ValueError(
                "GatheredParameters(modifier_rank=...) on a partial tree has "
                "no write-back path: pass the engine's full param tree (or "
                "engine=..., or a write_back callback) so mutations stick"
            )

    def __enter__(self):
        params = self.params
        if params is None:
            params = self.engine.get_params()
        if not self.enabled:
            return params
        self.gathered = _host_copy(params)
        return self.gathered

    def __exit__(self, *exc):
        if not (self.enabled and self.modifier_rank is not None):
            return False
        if self.write_back is not None:
            self.write_back(self.gathered)
        elif self.engine is not None:
            self.engine.set_params(self.gathered, src_rank=self.modifier_rank)
        return False


__all__ = [
    "Init",
    "GatheredParameters",
    "DeepSpeedZeroConfig",
    "ZeroStageEnum",
    "ZeroPartitioner",
    "estimate_zero_memory",
    "OffloadDeviceEnum",
    "DeepSpeedZeroOffloadParamConfig",
    "DeepSpeedZeroOffloadOptimizerConfig",
    "is_init_context_active",
    "shutdown_init_context",
    "restore_init_context",
    "TiledLinear",
    "TiledLinearReturnBias",
    "partition_uniform",
    "split_tensor_along_last_dim",
]
