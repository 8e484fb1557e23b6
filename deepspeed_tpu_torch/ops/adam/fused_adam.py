"""FusedAdam / Adam / AdamW.

Counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py``. The update is a
few plain tensor ops per leaf on fp32 state (JAX left it to XLA; there is
no Pallas kernel to port). It mirrors ``fused_adam.py:58-91`` term for
term, which ``torch.optim.AdamW`` does not: the bias corrections are
``1 - beta**step`` in fp32 at a float step, and the decoupled decay is
added to the Adam direction before the lr, ``p - lr * ((m / bc1) /
(sqrt(v / bc2) + eps) + wd * p)``, on every leaf (no parameter groups).
``adam_w_mode=False`` adds the decay to the gradient instead (coupled L2).

``apply`` returns new tensors; the engine copies them into its master.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.optimizer import DSOptimizer


class AdamState(NamedTuple):
    step: int
    exp_avg: Dict[str, torch.Tensor]  # fp32
    exp_avg_sq: Dict[str, torch.Tensor]  # fp32


class FusedAdam(DSOptimizer):
    def __init__(
        self,
        params=None,  # noqa: ARG002 - torch-API parity; the engine builds the state
        lr: float = 1e-3,
        bias_correction: bool = True,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        adam_w_mode: bool = True,
        weight_decay: float = 0.0,
        amsgrad: bool = False,
        set_grad_none: bool = True,  # noqa: ARG002
    ):
        if amsgrad:
            raise ValueError("FusedAdam does not support amsgrad (reference parity)")
        super().__init__(lr=lr, weight_decay=weight_decay, betas=betas, eps=eps)
        self.bias_correction = bias_correction
        self.adam_w_mode = adam_w_mode

    def init_state(self, params: Dict[str, torch.Tensor]) -> AdamState:
        zeros = lambda: {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
                         for k, p in params.items()}
        return AdamState(step=0, exp_avg=zeros(), exp_avg_sq=zeros())

    def apply(self, grads, state: AdamState, params, lr) -> Tuple[Dict[str, torch.Tensor], AdamState]:
        beta1, beta2 = self.defaults["betas"]
        eps = self.defaults["eps"]
        wd = self.defaults["weight_decay"]
        step = state.step + 1
        if self.bias_correction:  # fp32, as JAX's 1.0 - beta ** step.astype(float32)
            bc1 = float(np.float32(1.0) - np.float32(beta1) ** np.float32(step))
            bc2 = float(np.float32(1.0) - np.float32(beta2) ** np.float32(step))
        else:
            bc1 = bc2 = 1.0
        lr = float(np.float32(lr))
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float()
            p32 = p.float()
            if wd and not self.adam_w_mode:
                g = g + wd * p32
            m = beta1 * state.exp_avg[k] + (1.0 - beta1) * g
            v = beta2 * state.exp_avg_sq[k] + (1.0 - beta2) * (g * g)
            update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if wd and self.adam_w_mode:
                update = update + wd * p32
            new_p[k] = (p32 - lr * update).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, AdamState(step=step, exp_avg=new_m, exp_avg_sq=new_v)


class Adam(FusedAdam):
    """Plain Adam (coupled L2)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("adam_w_mode", False)
        super().__init__(*args, **kwargs)


class AdamW(FusedAdam):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("adam_w_mode", True)
        super().__init__(*args, **kwargs)
