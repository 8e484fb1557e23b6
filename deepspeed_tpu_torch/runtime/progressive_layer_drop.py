"""Progressive layer dropping (reference:
``deepspeed/runtime/progressive_layer_drop.py:40``, engine.py:1773).

PLD's keep-probability schedule theta(t) = (1-theta)·exp(-gamma·t) + theta;
layer i survives with probability 1 - (i+1)/L·(1 - theta) (stochastic
depth): the engine draws each microbatch's keep flags from it
(``DeepSpeedEngine._model_kwargs``). ``get_state()`` is the reference's.

The port's own copy of
``deepspeed_tpu/runtime/progressive_layer_drop.py``
(the port imports nothing of the JAX package): the same names and the
same numbers.
"""

from __future__ import annotations

import math


class ProgressiveLayerDrop:
    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int) -> None:
        def _prob(x, gamma, p):
            return (1.0 - p) * math.exp(-gamma * x) + p

        self.current_theta = _prob(global_step, self.gamma, self.theta)
