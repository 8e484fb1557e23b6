"""ZeRO partitioning: which slice of each leaf a rank owns.

Counterpart of ``deepspeed_tpu/runtime/zero/partition.py``. JAX declares
the ZeRO memory states as ``PartitionSpec``s over the ``data`` mesh axis
and lets XLA insert the collectives; the port keeps JAX's rule, as pure
shape arithmetic over the same spec entries (a tuple, one entry a dim:
None, an axis name or a tuple of names), and the engine turns each spec
into a per-rank slice (``zero_dim``, ``shard``) and moves the data itself:

* stage 0: everything replicated; gradients summed over the data-parallel
  ranks.
* stage 1: the fp32 master and the Adam moments sharded (1/dp each);
  gradients reduced whole, the update on the owner shard, the new
  compute-dtype parameters all-gathered.
* stage 2: the gradient accumulators sharded too (a reduce-scatter in
  place of the all-reduce).
* stage 3: the compute-dtype parameters stored sharded as well and
  gathered at use.

A leaf is sharded along its largest dim divisible by the ZeRO world (ties
go to a dim without tensor-parallel axes, then to the later dim, as JAX's
``max`` over candidates); below ``param_persistence_threshold`` elements
the compute parameter stays replicated. Rank ``r`` owns the ``r``-th of
``world`` equal, contiguous blocks of that dim: the slice JAX's
``NamedSharding`` puts on device ``r`` of a ``data`` mesh of ``world``
devices.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig, ZeroStageEnum

Spec = Tuple[Any, ...]


def _spec_entries(spec: Optional[Spec], ndim: int) -> list:
    entries = list(spec) if spec is not None else []
    entries += [None] * (ndim - len(entries))
    return entries


def _axes_in_use(entries) -> set:
    used = set()
    for e in entries:
        if e is None:
            continue
        if isinstance(e, (tuple, list)):
            used.update(e)
        else:
            used.add(e)
    return used


def shard_over_zero_axes(shape: Tuple[int, ...], topo, base_spec: Optional[Spec] = None, threshold: int = 0,
                         axes: Optional[Tuple[str, ...]] = None) -> Spec:
    """The spec of a leaf of ``shape`` with the ZeRO axes added to
    ``base_spec`` (which may carry tensor-parallel axes): JAX's rule line
    for line (``partition.py:59-108``), returned as a tuple of entries."""
    zero_axes = axes if axes is not None else topo.zero_shard_axes
    zero_size = math.prod(topo.axis_size(a) for a in zero_axes)
    entries = _spec_entries(base_spec, len(shape))
    if zero_size == 1:
        return tuple(entries)
    n_elements = math.prod(shape) if shape else 0
    if n_elements < max(threshold, 1) or not shape:
        return tuple(entries)
    if set(zero_axes) & _axes_in_use(entries):
        return tuple(entries)
    candidates = []
    for i, (dim_size, e) in enumerate(zip(shape, entries)):
        if e is None:
            if dim_size % zero_size == 0:
                candidates.append((dim_size, 1, i, None))
        else:
            existing = tuple(e) if isinstance(e, (tuple, list)) else (e,)
            tp_size = math.prod(topo.axis_size(a) for a in existing)
            if dim_size % (tp_size * zero_size) == 0:
                candidates.append((dim_size, 0, i, existing))
    if not candidates:
        return tuple(entries)
    _, _, best, existing = max(candidates)
    if existing is None:
        entries[best] = zero_axes if len(zero_axes) > 1 else zero_axes[0]
    else:
        entries[best] = existing + tuple(zero_axes)
    return tuple(entries)


def zero_dim(spec: Spec, zero_axes: Tuple[str, ...]) -> Optional[int]:
    """The dim of ``spec`` that carries the ZeRO axes, or None
    (replicated over the data-parallel ranks)."""
    for i, e in enumerate(spec):
        names = tuple(e) if isinstance(e, (tuple, list)) else (e,)
        if set(names) & set(zero_axes):
            return i
    return None


def shard(t: torch.Tensor, dim: Optional[int], rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` along ``dim`` (a view; ``t`` itself
    when ``dim`` is None)."""
    if dim is None or world == 1:
        return t
    n = t.shape[dim] // world
    return t.narrow(dim, rank * n, n)


def shard_shape(shape: Tuple[int, ...], dim: Optional[int], world: int) -> Tuple[int, ...]:
    if dim is None or world == 1:
        return tuple(shape)
    return tuple(s // world if i == dim else s for i, s in enumerate(shape))


class ZeroPartitioner:
    """The spec of each leaf of a tree (nested dicts, or a flat ``path ->
    leaf`` dict; leaves are tensors, arrays or shapes) for the stage and the
    topology (JAX ``partition.py:111-180``; the port has no tensor-parallel
    training, so a dense leaf's base spec is replicated). ``expert`` maps
    the paths of the expert leaves to their expert dim: their base spec
    carries the ``expert`` axis there, which the ZeRO axes overlap, so
    they take no ZeRO sharding at any stage (JAX ``partition.py:83``), the
    master and the moments alike, and ``dims`` gives them None."""

    def __init__(self, zero_config: DeepSpeedZeroConfig, topo, expert: Optional[Dict[str, int]] = None):
        self.config = zero_config
        self.stage = int(zero_config.stage)
        self.topo = topo
        self.expert = dict(expert or {})

    def _specs(self, params: Any, from_stage: int, threshold: int, path: str = "") -> Any:
        """Sharded over the ZeRO axes from ``from_stage`` on, else replicated."""
        if isinstance(params, dict):
            return {k: self._specs(v, from_stage, threshold, f"{path}/{k}" if path else k)
                    for k, v in params.items()}
        shape = tuple(params) if isinstance(params, (tuple, list)) else tuple(params.shape)
        base = None
        if path in self.expert:
            base = tuple("expert" if i == self.expert[path] else None for i in range(len(shape)))
        if self.stage >= from_stage:
            return shard_over_zero_axes(shape, self.topo, base_spec=base, threshold=threshold)
        return base if base is not None else (None,) * len(shape)

    def param_specs(self, params: Any) -> Any:
        """The live (compute-dtype) parameter store: sharded at stage 3 above
        ``param_persistence_threshold`` elements."""
        return self._specs(params, int(ZeroStageEnum.weights), int(self.config.param_persistence_threshold))

    def master_specs(self, params: Any) -> Any:
        """The fp32 master and the optimizer moments (sharded at stage >= 1)."""
        return self._specs(params, int(ZeroStageEnum.optimizer_states), 0)

    def grad_accum_specs(self, params: Any) -> Any:
        """The gradient-accumulation buffers (sharded at stage >= 2)."""
        return self._specs(params, int(ZeroStageEnum.gradients), 0)

    def dims(self, specs: Dict[str, Spec]) -> Dict[str, Optional[int]]:
        """A flat ``path -> spec`` dict as ``path -> zero_dim``."""
        return {k: None if k in self.expert else zero_dim(s, self.topo.zero_shard_axes) for k, s in specs.items()}


def estimate_zero_memory(n_params: int, stage: int, dp_size: int, bytes_per_param: int = 2,
                         optimizer_factor: int = 12) -> dict:
    """Bytes a rank holds for params, grads and optimizer state under each
    stage (JAX ``partition.py:206-232``; ``optimizer_factor=12``: fp32
    master 4 + Adam m 4 + v 4)."""
    params = n_params * bytes_per_param
    grads = n_params * bytes_per_param
    opt = n_params * optimizer_factor
    if stage >= 1:
        opt = math.ceil(opt / dp_size)
    if stage >= 2:
        grads = math.ceil(grads / dp_size)
    if stage >= 3:
        params = math.ceil(params / dp_size)
    return {"params_bytes": params, "grads_bytes": grads, "optimizer_bytes": opt,
            "total_bytes": params + grads + opt}
