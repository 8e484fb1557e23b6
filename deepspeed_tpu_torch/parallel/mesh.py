"""Process-group topology.

Counterpart of ``deepspeed_tpu/parallel/mesh.py``. JAX names its process
groups as the axes of one device mesh; the port, like the reference
DeepSpeed, runs one process a rank over ``torch.distributed``, and a
``Topology`` maps the same axis names onto process groups, with JAX's
accessors (``get_data_parallel_world_size``, ``data_parallel_axes``,
``zero_shard_axes``, ``world_size``, ``axis_size``).

Rank ``r`` has the mesh coordinates that JAX's row-major mesh gives device
``r`` over the axis order ``pipe, data_outer, data, expert, sequence,
model``, so it holds the shard JAX puts on device ``r``. ``build_groups``
makes one ``torch.distributed`` group for each axis set the port runs
collectives over, every rank calling ``new_group`` in the same order:

* the **expert** group: the ranks that differ only in their ``expert``
  coordinate (the dispatch and combine all-to-alls, ``moe/a2a.py``);
* the **expert-data** group: the ranks that hold the same expert shard,
  the ``data_outer × data`` axes at a fixed ``expert`` coordinate (the
  expert leaves' gradient reduction; JAX ``mesh.py:45-51``);
* the dense data-parallel group, the world (the default group);
* the ``model`` group (``moe/mappings.py``'s token drop and gather).

The port trains data and expert parallel: ``mesh.data`` (0 = the world
size divided by the other axes, as JAX resolves it) times ``mesh.expert``
is the data-parallel and ZeRO world. Tensor, sequence and pipeline axes
(``model`` / ``sequence`` / ``pipe`` > 1, ROADMAP P1) and the MiCS split
(``data_outer`` > 1, P1) are refused by the engine's config check before a
topology is built. The live topology (``get_topology`` / ``set_topology``,
as JAX's ``_TOPOLOGY``) is what ``utils/groups.py`` establishes and what
the engines and the MoE layers read.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch import comm

AXIS_ORDER: Tuple[str, ...] = ("pipe", "data_outer", "data", "expert", "sequence", "model")
EXPERT_AXES: Tuple[str, ...] = ("expert",)
EXPERT_DATA_AXES: Tuple[str, ...] = ("data_outer", "data")
MODEL_AXES: Tuple[str, ...] = ("model",)

_TOPOLOGY: Optional["Topology"] = None


class Topology:
    """Axis sizes over the ranks of the default process group, and the
    process groups of the axis sets (``build_groups``)."""

    def __init__(self, sizes: Dict[str, int], rank: int = 0):
        self.sizes = {a: int(sizes.get(a, 1)) for a in AXIS_ORDER}
        self.rank = int(rank)
        self.user_established = False  # set by utils.groups.initialize: a mesh-less initialize adopts it
        self._groups: Dict[Tuple[str, ...], object] = {}

    # --- world sizes (JAX mesh.py:36-70) -------------------------------------
    def get_data_parallel_world_size(self) -> int:
        return self.sizes["data_outer"] * self.sizes["data"] * self.sizes["expert"]

    def get_expert_data_parallel_world_size(self) -> int:
        return self.sizes["data_outer"] * self.sizes["data"]

    @property
    def world_size(self) -> int:
        return math.prod(self.sizes[a] for a in AXIS_ORDER)

    # --- axis-name groups (JAX mesh.py:72-125) ----------------------------------
    @property
    def data_parallel_axes(self) -> Tuple[str, ...]:
        axes = ["data"]
        if self.sizes["data_outer"] > 1:
            axes.insert(0, "data_outer")
        if self.sizes["expert"] > 1:
            axes.append("expert")
        if self.sizes["sequence"] > 1:
            axes.append("sequence")
        return tuple(axes)

    @property
    def zero_shard_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.data_parallel_axes if a != "data_outer")

    def axis_size(self, name: str) -> int:
        return self.sizes[name]

    # --- ranks and groups ---------------------------------------------------------
    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Rank ``rank``'s mesh coordinates (row-major over ``AXIS_ORDER``)."""
        r = self.rank if rank is None else int(rank)
        out = {}
        for a in reversed(AXIS_ORDER):
            out[a] = r % self.sizes[a]
            r //= self.sizes[a]
        return out

    def axis_rank(self, axes: Tuple[str, ...], rank: Optional[int] = None) -> int:
        """The rank's index within its group over ``axes`` (row-major)."""
        c = self.coords(rank)
        i = 0
        for a in axes:
            i = i * self.sizes[a] + c[a]
        return i

    def group_ranks(self, axes: Tuple[str, ...], rank: Optional[int] = None) -> List[int]:
        """The world ranks that share every coordinate of ``rank`` outside
        ``axes``, in their order within the group."""
        c = self.coords(rank)
        return [r for r in range(self.world_size)
                if all(self.coords(r)[a] == c[a] for a in AXIS_ORDER if a not in axes)]

    def _partition(self, axes: Tuple[str, ...]) -> List[List[int]]:
        seen, out = set(), []
        for r in range(self.world_size):
            if r not in seen:
                ranks = self.group_ranks(axes, r)
                seen.update(ranks)
                out.append(ranks)
        return out

    def build_groups(self) -> "Topology":
        """Make the process groups of the expert, expert-data and model axis sets
        (every rank of the world calls this, in the same order, before any
        collective over them); a set that is the world or one rank takes
        the default group or none."""
        if self.world_size > 1 and comm.get_world_size() != self.world_size:
            raise ValueError(f"a topology of {self.world_size} ranks needs a process group of as many "
                             f"(got {comm.get_world_size()})")
        for axes in (EXPERT_AXES, EXPERT_DATA_AXES, MODEL_AXES):
            size = math.prod(self.sizes[a] for a in axes)
            if axes in self._groups or size in (1, self.world_size):
                continue
            mine = None
            for ranks in self._partition(axes):
                g = comm.new_group(ranks)
                if self.rank in ranks:
                    mine = g
            self._groups[axes] = mine
        return self

    def group(self, axes: Tuple[str, ...]):
        """The process group over ``axes`` holding this rank (None: the
        world, or a group of one rank, where every collective is local)."""
        return self._groups.get(tuple(axes))

    @property
    def expert_group(self):
        return self.group(EXPERT_AXES)

    @property
    def expert_data_group(self):
        return self.group(EXPERT_DATA_AXES)

    @property
    def expert_rank(self) -> int:
        return self.coords()["expert"]

    @property
    def expert_data_rank(self) -> int:
        return self.axis_rank(EXPERT_DATA_AXES)


def build_topology(mesh_config, world_size: int = None) -> Topology:
    """Resolve ``mesh_config`` against the world (``comm.get_world_size()``
    unless given): ``data`` 0 takes what the other axes leave, and the axes
    must multiply to the world (JAX ``MeshConfig.resolve``). Under a
    process group of more than one rank the groups are built."""
    n = comm.get_world_size() if world_size is None else int(world_size)
    fixed = (mesh_config.model * mesh_config.sequence * mesh_config.expert * mesh_config.pipe
             * mesh_config.data_outer)
    if fixed <= 0 or n % fixed:
        raise ValueError(f"mesh axes data_outer×model×sequence×expert×pipe={fixed} do not divide the world "
                         f"of {n} ranks")
    data = mesh_config.data or n // fixed
    if data * fixed != n:
        raise ValueError(f"mesh {data}×{fixed} != world of {n} ranks (mesh.data must be the world size "
                         "divided by the other axes)")
    topo = Topology({"pipe": mesh_config.pipe, "data_outer": mesh_config.data_outer, "data": data,
                     "expert": mesh_config.expert, "sequence": mesh_config.sequence, "model": mesh_config.model},
                    rank=comm.get_rank() if n > 1 else 0)
    if n > 1 and world_size is None:
        topo.build_groups()
    return topo


def config_requests_mesh(mesh_config) -> bool:
    """True when the config names a mesh shape (data > 0, or another axis
    above 1); all-default defers to a live topology (JAX
    ``engine.py:3955``)."""
    md = mesh_config.model_dump()
    return md.get("data", 0) > 0 or any(v > 1 for k, v in md.items() if k != "data")


def topology_for(mesh_config) -> Topology:
    """The training engine's topology (JAX ``engine.py:199-211``): the live
    one when ``groups.initialize`` established it and the config names no
    mesh, or when it is the mesh the config resolves to; else a new one,
    which becomes the live topology."""
    live = _TOPOLOGY
    if live is not None and live.world_size == comm.get_world_size():
        if live.user_established and not config_requests_mesh(mesh_config):
            return live
        try:
            if build_topology(mesh_config, world_size=live.world_size).sizes == live.sizes:
                return live
        except ValueError:
            pass
    return set_topology(build_topology(mesh_config))


def get_topology() -> Topology:
    """The live topology; the default one (every rank on ``data``) when
    none is set."""
    if _TOPOLOGY is None:
        from deepspeed_tpu_torch.runtime.config import MeshConfig

        set_topology(build_topology(MeshConfig()))
    return _TOPOLOGY


def live_topology() -> Optional[Topology]:
    """The live topology without making one (None before any is set)."""
    return _TOPOLOGY


def set_topology(topology: Optional[Topology]) -> Optional[Topology]:
    global _TOPOLOGY
    _TOPOLOGY = topology
    return topology


def reset_topology() -> None:
    set_topology(None)
