"""Optimizer base.

Counterpart of ``deepspeed_tpu/ops/optimizer.py``. An optimizer is a pair
of plain tensor functions, ``init_state(params)`` and ``apply(grads,
state, params, lr)``, over the engine's flat ``path -> fp32 tensor`` master;
the engine calls ``apply`` once per optimizer step, so the update math
lives in one place. The class carries torch-style ``param_groups`` (a list
of dicts with ``lr``) because the LR schedules mutate
``param_groups[i]["lr"]``; the engine reads group 0's lr at every step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


class DSOptimizer:
    """Base: subclasses implement ``init_state`` / ``apply``."""

    def __init__(self, lr: float, weight_decay: float = 0.0, **defaults):
        self.defaults: Dict[str, Any] = {"lr": lr, "weight_decay": weight_decay, **defaults}
        self.param_groups: List[Dict[str, Any]] = [dict(self.defaults)]

    @property
    def lr(self) -> float:
        return self.param_groups[0]["lr"]

    @lr.setter
    def lr(self, value: float) -> None:
        for g in self.param_groups:
            g["lr"] = value

    def get_lr(self) -> List[float]:
        return [g["lr"] for g in self.param_groups]

    def init_state(self, params: Dict[str, Any]) -> Any:
        raise NotImplementedError

    def apply(self, grads: Dict[str, Any], state: Any, params: Dict[str, Any], lr: float) -> Tuple[Dict[str, Any], Any]:
        """Return ``(new_params, new_state)``."""
        raise NotImplementedError
