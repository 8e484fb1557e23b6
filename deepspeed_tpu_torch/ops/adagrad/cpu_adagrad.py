"""Adagrad (reference ``deepspeed/ops/adagrad/cpu_adagrad.py``).

Counterpart of ``deepspeed_tpu/ops/adagrad/cpu_adagrad.py``: the device
optimizer the engine builds for ``cpu_adagrad`` and ``adagrad``, a few
plain tensor ops per leaf on the fp32 master, term for term JAX's. The
host library of the same rule is ``ops/adam/cpu_adam_native.NativeCPUAdagrad``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.optimizer import DSOptimizer


class AdagradState(NamedTuple):
    step: int
    sum_sq: Dict[str, torch.Tensor]  # fp32


class DeepSpeedCPUAdagrad(DSOptimizer):
    def __init__(self, params=None, lr: float = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0):  # noqa: ARG002
        super().__init__(lr=lr, weight_decay=weight_decay, eps=eps)

    def init_state(self, params: Dict[str, torch.Tensor]) -> AdagradState:
        return AdagradState(step=0, sum_sq={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                            for k, p in params.items()})

    def apply(self, grads, state: AdagradState, params, lr) -> Tuple[Dict[str, torch.Tensor], AdagradState]:
        eps = self.defaults["eps"]
        wd = self.defaults["weight_decay"]
        lr = float(np.float32(lr))
        new_p, new_s = {}, {}
        for k, p in params.items():
            g = grads[k].float()
            p32 = p.float()
            if wd:
                g = g + wd * p32
            s = state.sum_sq[k] + g * g
            new_p[k] = (p32 - lr * g / (torch.sqrt(s) + eps)).to(p.dtype)
            new_s[k] = s
        return new_p, AdagradState(step=state.step + 1, sum_sq=new_s)
