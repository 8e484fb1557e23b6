"""Elastic resize policy for the serving fleet.

Counterpart of ``deepspeed_tpu/elasticity/fleet_policy.py`` (no JAX). The
replica count is an elastic resource: :func:`valid_fleet_sizes` runs the
elastic batch math (``get_valid_gpus``) with replicas as the "gpus" and a
replica's slot capacity as the "micro batch", so a fleet only resizes to
counts whose slot capacity divides the fleet's slot budget.
:class:`FleetResizePolicy` decides when: watermarks on the backlog a
replica (queued + live requests), a cooldown against flapping on bursty
traffic, and clamping to ``[min_replicas, max_replicas]`` within the valid
counts. ``FleetRouter.autoscale_step`` (``inference/fleet.py``) carries a
decision out: drain by migration, join by journal catch-up.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from deepspeed_tpu_torch.elasticity.elasticity import get_valid_gpus


def valid_fleet_sizes(
    fleet_slot_budget: int,
    slots_per_replica: int,
    min_replicas: int = 1,
    max_replicas: int = 4096,
) -> List[int]:
    """Replica counts whose aggregate slot capacity divides the fleet slot
    budget — ``get_valid_gpus`` with replicas as chips and per-replica
    slots as the micro batch. E.g. a 32-slot budget over 4-slot replicas
    resizes through {1, 2, 4, 8}."""
    return get_valid_gpus(
        int(fleet_slot_budget), [int(slots_per_replica)],
        int(min_replicas), int(max_replicas),
    )


@dataclass
class FleetResizePolicy:
    """Watermark + hysteresis resize decisions for a serving fleet.

    ``target_backlog_per_replica`` is the load (queued + live requests)
    one replica should carry; the policy scales toward
    ``ceil(backlog / target)`` replicas, but only once the per-replica
    load crosses ``scale_up_at × target`` (growth) or falls below
    ``scale_down_at × target`` (shrink), and never more often than one
    resize per ``cooldown_steps`` scheduler steps. Candidate sizes are
    snapped to ``valid_counts`` (upward when growing, downward when
    shrinking) and clamped to ``[min_replicas, max_replicas]``."""

    min_replicas: int = 1
    max_replicas: int = 8
    target_backlog_per_replica: float = 4.0
    scale_up_at: float = 1.5
    scale_down_at: float = 0.5
    cooldown_steps: int = 8
    valid_counts: Optional[Sequence[int]] = None
    _last_resize_step: int = field(default=-(10**9), init=False, repr=False)

    def __post_init__(self):
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}"
            )
        if self.target_backlog_per_replica <= 0:
            raise ValueError("target_backlog_per_replica must be positive")
        if not self.scale_down_at < self.scale_up_at:
            raise ValueError(
                f"watermarks must satisfy scale_down_at < scale_up_at, got "
                f"{self.scale_down_at} vs {self.scale_up_at}"
            )
        counts = sorted(
            set(self.valid_counts)
            if self.valid_counts is not None
            else range(self.min_replicas, self.max_replicas + 1)
        )
        counts = [
            c for c in counts if self.min_replicas <= c <= self.max_replicas
        ]
        if not counts:
            raise ValueError(
                f"no valid replica count inside [{self.min_replicas}, "
                f"{self.max_replicas}]"
            )
        self.valid_counts = counts

    def _snap(self, want: int, up: bool) -> int:
        """Nearest valid count: the smallest valid ≥ want when growing
        (capacity promises are met), the largest valid ≤ want when
        shrinking (never shrink past the demand estimate)."""
        if up:
            bigger = [c for c in self.valid_counts if c >= want]
            return bigger[0] if bigger else self.valid_counts[-1]
        smaller = [c for c in self.valid_counts if c <= want]
        return smaller[-1] if smaller else self.valid_counts[0]

    def decide(self, backlog: float, n_active: int, step: int) -> int:
        """Target replica count for the current load. Returns ``n_active``
        (no resize) inside the hysteresis band or during the cooldown."""
        n_active = max(int(n_active), 1)
        per = backlog / n_active
        want = max(
            1, math.ceil(backlog / self.target_backlog_per_replica)
        )
        if per >= self.scale_up_at * self.target_backlog_per_replica:
            target = self._snap(max(want, n_active + 1), up=True)
        elif per <= self.scale_down_at * self.target_backlog_per_replica:
            target = self._snap(min(want, n_active - 1), up=False)
        else:
            return n_active
        target = min(max(target, self.min_replicas), self.max_replicas)
        if target == n_active:
            return n_active
        if step - self._last_resize_step < self.cooldown_steps:
            return n_active  # hysteresis: no flapping inside the cooldown
        self._last_resize_step = step
        return target
