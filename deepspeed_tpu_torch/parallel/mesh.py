"""Process-group topology.

Counterpart of ``deepspeed_tpu/parallel/mesh.py``. JAX names its process
groups as the axes of one device mesh; the port, like the reference
DeepSpeed, runs one process a rank over ``torch.distributed``, and a
``Topology`` maps the same axis names onto process groups, with JAX's
accessors (``get_data_parallel_world_size``, ``data_parallel_axes``,
``zero_shard_axes``, ``world_size``, ``axis_size``).

The port trains data parallel only: ``mesh.data`` (0 = the world size
divided by the other axes, as JAX resolves it) is the data-parallel and
ZeRO world, its group the default one. Tensor, sequence and pipeline axes
(``model`` / ``sequence`` / ``pipe`` > 1, ROADMAP P1), the MiCS split
(``data_outer`` > 1, P1) and an ``expert`` axis (M1) are refused by the
engine's config check before a topology is built.
"""

from __future__ import annotations

from typing import Dict, Tuple

from deepspeed_tpu_torch import comm

AXIS_ORDER: Tuple[str, ...] = ("pipe", "data_outer", "data", "expert", "sequence", "model")


class Topology:
    """Axis sizes over the ranks of the default process group (the
    data-parallel group)."""

    def __init__(self, sizes: Dict[str, int]):
        self.sizes = {a: int(sizes.get(a, 1)) for a in AXIS_ORDER}

    # --- world sizes (JAX mesh.py:36-70) -------------------------------------
    def get_data_parallel_world_size(self) -> int:
        return self.sizes["data_outer"] * self.sizes["data"] * self.sizes["expert"]

    @property
    def world_size(self) -> int:
        n = 1
        for a in AXIS_ORDER:
            n *= self.sizes[a]
        return n

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


def build_topology(mesh_config, world_size: int = None) -> Topology:
    """Resolve ``mesh_config`` against the world (``comm.get_world_size()``
    unless given): ``data`` 0 takes what the other axes leave, and the axes
    must multiply to the world (JAX ``MeshConfig.resolve``)."""
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
    return Topology({"pipe": mesh_config.pipe, "data_outer": mesh_config.data_outer, "data": data,
                     "expert": mesh_config.expert, "sequence": mesh_config.sequence, "model": mesh_config.model})
