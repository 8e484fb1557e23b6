from deepspeed_tpu_torch.parallel.mesh import AXIS_ORDER, Topology, build_topology

__all__ = ["AXIS_ORDER", "Topology", "build_topology"]
