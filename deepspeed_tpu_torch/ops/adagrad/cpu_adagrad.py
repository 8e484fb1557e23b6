"""Adagrad (reference ``deepspeed/ops/adagrad/cpu_adagrad.py``).

Counterpart of ``deepspeed_tpu/ops/adagrad/cpu_adagrad.py``: the device
optimizer the engine builds for ``cpu_adagrad`` and ``adagrad``, a few
plain tensor ops per leaf on the fp32 master, term for term JAX's. The
host library of the same rule is ``ops/adam/cpu_adam_native.NativeCPUAdagrad``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import torch

from deepspeed_tpu_torch.ops.optimizer import DSOptimizer


class AdagradState(NamedTuple):
    step: Union[int, torch.Tensor]  # the engine keeps it as a device int32 scalar
    sum_sq: Dict[str, torch.Tensor]  # fp32


class DeepSpeedCPUAdagrad(DSOptimizer):
    capturable = True  # lr is a device scalar in the engine's step: no host read

    def __init__(self, params=None, lr: float = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0):  # noqa: ARG002
        super().__init__(lr=lr, weight_decay=weight_decay, eps=eps)

    def init_state(self, params: Dict[str, torch.Tensor]) -> AdagradState:
        return AdagradState(step=0, sum_sq={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                            for k, p in params.items()})

    def bias_corrections(self, step, device):  # noqa: ARG002 - Adagrad has none
        return None, None

    def leaf(self, g, p, s, bc1, bc2, lr):  # noqa: ARG002
        """One leaf's update: ``(new p in p's dtype, new sum of squares)``."""
        eps = self.defaults["eps"]
        wd = self.defaults["weight_decay"]
        g = g.float()
        p32 = p.float()
        if wd:
            g = g + wd * p32
        s = s + g * g
        return (p32 - lr * g / (torch.sqrt(s) + eps)).to(p.dtype), s

    def apply(self, grads, state: AdagradState, params, lr) -> Tuple[Dict[str, torch.Tensor], AdagradState]:
        dev = next(iter(params.values())).device if params else "cpu"
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        new_p, new_s = {}, {}
        for k, p in params.items():
            new_p[k], new_s[k] = self.leaf(grads[k], p, state.sum_sq[k], None, None, lr)
        return new_p, AdagradState(step=state.step + 1, sum_sq=new_s)

    def moments(self, state: AdagradState) -> Tuple[Dict[str, torch.Tensor], ...]:
        return (state.sum_sq,)
