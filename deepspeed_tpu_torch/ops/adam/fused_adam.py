"""FusedAdam / Adam / AdamW.

Counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py``. The update is a
few plain tensor ops per leaf on fp32 state (JAX left it to XLA; there is
no Pallas kernel to port). It mirrors ``fused_adam.py:58-91`` term for
term, which ``torch.optim.AdamW`` does not: the bias corrections are
``1 - beta**step`` in fp32 at a float step, and the decoupled decay is
added to the Adam direction before the lr, ``p - lr * ((m / bc1) /
(sqrt(v / bc2) + eps) + wd * p)``, on every leaf (no parameter groups).
``adam_w_mode=False`` adds the decay to the gradient instead (coupled L2).

``apply`` returns new tensors (the streamed offload path updates its
buckets with it); the engine's own step calls ``leaf`` on one leaf, or one
chunk of a leaf, at a time and writes the result into its state in place,
with the bias corrections from ``bias_corrections`` at the device step
count, so that a captured CUDA graph can replay it. Both run the same ops.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import torch

from deepspeed_tpu_torch.ops.optimizer import DSOptimizer


class AdamState(NamedTuple):
    step: Union[int, torch.Tensor]  # the engine keeps it as a device int32 scalar
    exp_avg: Dict[str, torch.Tensor]  # fp32
    exp_avg_sq: Dict[str, torch.Tensor]  # fp32


def _scalar(x, device) -> torch.Tensor:
    """``x`` (a host number or a 0-d tensor) as an fp32 0-d tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class FusedAdam(DSOptimizer):
    capturable = True  # the step count, lr and bias corrections are device scalars: no host read

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

    def bias_corrections(self, step, device):
        """The reciprocals of ``(1 - beta1**step, 1 - beta2**step)`` as fp32
        device scalars at a float step (JAX's ``1.0 - beta **
        step.astype(float32)``), or ``(1, 1)`` without bias correction;
        ``step`` a host int or a device scalar (the same ops either way).
        ``leaf`` multiplies by them: on the card a division by a broadcast
        device scalar rounds by the tensor's layout (a ZeRO slice and the
        whole leaf part), a product by a reciprocal does not, and it is what
        PyTorch computes for a host-scalar divisor."""
        if not self.bias_correction:
            one = torch.ones((), dtype=torch.float32, device=device)
            return one, one
        beta1, beta2 = self.defaults["betas"]
        t = _scalar(step, device)
        # a host base with a device exponent: no host-to-device copy, so a CUDA graph can capture it
        return 1.0 / (1.0 - beta1 ** t), 1.0 / (1.0 - beta2 ** t)

    def leaf(self, g, p, m, v, bc1, bc2, lr):
        """One leaf's update, term for term JAX's ``fused_adam.py:58-91``:
        ``(new p in p's dtype, new m, new v)`` from the fp32 gradient ``g``,
        the leaf ``p`` and its moments; ``bc1``, ``bc2`` (the bias
        corrections' reciprocals, ``bias_corrections``) and ``lr`` are fp32
        device scalars."""
        beta1, beta2 = self.defaults["betas"]
        eps = self.defaults["eps"]
        wd = self.defaults["weight_decay"]
        g = g.float()
        p32 = p.float()
        if wd and not self.adam_w_mode:
            g = g + wd * p32
        m = beta1 * m + (1.0 - beta1) * g
        v = beta2 * v + (1.0 - beta2) * (g * g)
        update = (m * bc1) / (torch.sqrt(v * bc2) + eps)
        if wd and self.adam_w_mode:
            update = update + wd * p32
        return (p32 - lr * update).to(p.dtype), m, v

    def apply(self, grads, state: AdamState, params, lr) -> Tuple[Dict[str, torch.Tensor], AdamState]:
        step = state.step + 1
        dev = next(iter(params.values())).device if params else "cpu"
        bc1, bc2 = self.bias_corrections(step, dev)
        lr = _scalar(lr, dev)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            new_p[k], new_m[k], new_v[k] = self.leaf(grads[k], p, state.exp_avg[k], state.exp_avg_sq[k], bc1, bc2, lr)
        return new_p, AdamState(step=step, exp_avg=new_m, exp_avg_sq=new_v)

    def moments(self, state: AdamState) -> Tuple[Dict[str, torch.Tensor], ...]:
        """The per-leaf state trees ``leaf`` reads and writes, in its order."""
        return state.exp_avg, state.exp_avg_sq


class Adam(FusedAdam):
    """Plain Adam (coupled L2)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("adam_w_mode", False)
        super().__init__(*args, **kwargs)


class AdamW(FusedAdam):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("adam_w_mode", True)
        super().__init__(*args, **kwargs)
