"""Elasticity: the serving fleet's resize policy (``fleet_policy.py``)."""

from deepspeed_tpu_torch.elasticity.fleet_policy import FleetResizePolicy, valid_fleet_sizes

__all__ = ["FleetResizePolicy", "valid_fleet_sizes"]
