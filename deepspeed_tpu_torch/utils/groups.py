"""Process-group accessors (counterpart of ``deepspeed_tpu/utils/groups.py``;
reference ``deepspeed/utils/groups.py:51-528``).

``initialize(ep_size)`` carves an ``expert`` axis of ``ep_size`` out of
``data`` in the live topology (``parallel/mesh.py``) and marks it
established, so a later ``initialize`` whose config names no mesh, and
``init_inference``, adopt it. The accessors return ``AxisGroup`` handles,
JAX's duck type (``.size``, ``.ranks``, ``len``, ``.axis``), which also
carry the ``torch.distributed`` group of their axis set
(``process_group``, None for the world or a group of one rank) and the
world ranks in it (``global_ranks``); ``comm.get_world_size`` and
``comm.get_rank`` read them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel.mesh import build_topology, get_topology, set_topology


@dataclass(frozen=True)
class AxisGroup:
    """A mesh-axis view with the comm facade's group duck type."""

    axis: Tuple[str, ...]
    size: int
    rank: int = 0
    global_ranks: List[int] = field(default_factory=list, compare=False)
    process_group: Any = field(default=None, compare=False)

    @property
    def ranks(self):
        return list(range(self.size))

    def __len__(self) -> int:
        return self.size


def _axis_group(*axes: str) -> AxisGroup:
    topo = get_topology()
    size = math.prod(topo.axis_size(a) for a in axes)
    return AxisGroup(axis=axes, size=size, rank=topo.axis_rank(axes), global_ranks=topo.group_ranks(axes),
                     process_group=topo.group(axes))


def initialize(ep_size: int = 1, mpu=None) -> None:  # noqa: ARG001
    """Establish the expert axis (JAX ``groups.py:44-82``): carved out of
    ``data``, the other axes kept; an expert axis of the same size is
    validated instead (idempotent). Every rank calls it: the groups of the
    new topology are made here."""
    if ep_size <= 1:
        return
    topo = get_topology()
    if topo.axis_size("expert") == ep_size:
        topo.user_established = True
        return
    if topo.axis_size("expert") != 1:
        raise ValueError(
            f"expert axis already sized {topo.axis_size('expert')}; "
            f"cannot re-initialize to ep_size={ep_size}"
        )
    old = topo.sizes
    if old["data"] % ep_size != 0:
        raise ValueError(
            f"ep_size={ep_size} does not divide the data axis ({old['data']}); "
            "expert groups are carved from data parallelism"
        )
    from deepspeed_tpu_torch.runtime.config import MeshConfig

    new = build_topology(MeshConfig(pipe=old["pipe"], data_outer=old["data_outer"], data=old["data"] // ep_size,
                                    expert=ep_size, sequence=old["sequence"], model=old["model"]),
                         world_size=topo.world_size)
    if new.world_size > 1:
        new.build_groups()
    new.user_established = True
    set_topology(new)


# --- accessors (reference groups.py:282-528) -------------------------------
def _get_data_parallel_group() -> AxisGroup:
    """The dense data-parallel group: data_outer × data × expert."""
    return _axis_group("data_outer", "data", "expert")


def _get_model_parallel_group() -> AxisGroup:
    return _axis_group("model")


def _get_expert_parallel_group(group_name: Optional[str] = None) -> AxisGroup:  # noqa: ARG001
    return _axis_group("expert")


def _get_expert_data_parallel_group(group_name: Optional[str] = None) -> AxisGroup:  # noqa: ARG001
    """The ranks that hold the same expert shard (reference expert-data
    groups, groups.py:113): data_outer × data at a fixed expert coordinate."""
    return _axis_group("data_outer", "data")


def _get_sequence_parallel_group() -> AxisGroup:
    return _axis_group("sequence")


def _get_sequence_data_parallel_group() -> AxisGroup:
    return _axis_group("sequence", "data_outer", "data", "expert")


def _get_max_expert_size_name() -> str:
    return f"ep_size_{_axis_group('expert').size}"


def get_data_parallel_world_size() -> int:
    return _get_data_parallel_group().size


def get_model_parallel_world_size() -> int:
    return _get_model_parallel_group().size


def get_expert_parallel_world_size(group_name: Optional[str] = None) -> int:  # noqa: ARG001
    return _get_expert_parallel_group().size


def get_expert_data_parallel_world_size(group_name: Optional[str] = None) -> int:  # noqa: ARG001
    return _get_expert_data_parallel_group().size


def get_sequence_parallel_world_size() -> int:
    return _get_sequence_parallel_group().size


def get_data_parallel_rank() -> int:
    return comm.get_rank() % max(1, get_data_parallel_world_size())


def get_model_parallel_rank() -> int:
    return _get_model_parallel_group().rank


def get_expert_parallel_rank(group_name: Optional[str] = None) -> int:  # noqa: ARG001
    return _get_expert_parallel_group().rank
