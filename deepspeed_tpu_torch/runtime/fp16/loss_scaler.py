"""Loss scaling.

Counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py`` (``:23-123``):
``LossScaler`` (static; scale 1 unless fp16 asks for a fixed scale),
``DynamicLossScaler`` (fp16: shrink on overflow after ``delayed_shift``
overflows, grow after ``scale_window`` good steps) and ``has_inf_or_nan``.
JAX keeps the scale state on the device and updates it with ``where``; the
port keeps it as host numbers, because the fp16 step reads the overflow
flag on the host anyway (as the JAX engine's bookkeeping does under fp16).
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch

INITIAL_LOSS_SCALE = "init_scale"
SCALE_WINDOW = "scale_window"
DELAYED_SHIFT = "delayed_shift"
MIN_LOSS_SCALE = "min_scale"


class LossScaleState(NamedTuple):
    scale: float
    good_steps: int
    hysteresis: int


class LossScalerBase:
    """Static (or no-op) scaling."""

    dynamic = False

    def __init__(self, scale: float = 1.0):
        self.init_scale = float(scale)

    def init_state(self) -> LossScaleState:
        return LossScaleState(scale=self.init_scale, good_steps=0, hysteresis=0)

    def update(self, state: LossScaleState, overflow: bool) -> LossScaleState:  # noqa: ARG002
        return state


class LossScaler(LossScalerBase):
    pass


class DynamicLossScaler(LossScalerBase):
    dynamic = True

    def __init__(
        self,
        init_scale: float = 2**32,
        scale_factor: float = 2.0,
        scale_window: int = 1000,
        min_scale: float = 1.0,
        delayed_shift: int = 1,
        consecutive_hysteresis: bool = False,
    ):
        super().__init__(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self.delayed_shift = int(delayed_shift)
        self.consecutive_hysteresis = consecutive_hysteresis

    def init_state(self) -> LossScaleState:
        return LossScaleState(scale=self.init_scale, good_steps=0, hysteresis=self.delayed_shift)

    def update(self, state: LossScaleState, overflow: bool) -> LossScaleState:
        """The JAX update (``loss_scaler.py:80-99``) on host numbers."""
        hysteresis = max(state.hysteresis - 1, 0) if overflow else state.hysteresis
        must_shrink = overflow and hysteresis <= 0
        window_full = state.good_steps + 1 >= self.scale_window
        if must_shrink:
            scale = max(state.scale / self.scale_factor, self.min_scale)
        elif overflow:
            scale = state.scale
        else:
            scale = state.scale * self.scale_factor if window_full else state.scale
        good = 0 if (overflow or window_full) else state.good_steps + 1
        if must_shrink or (not overflow and not self.consecutive_hysteresis):
            hysteresis = self.delayed_shift
        return LossScaleState(scale=scale, good_steps=good, hysteresis=hysteresis)


def CreateLossScaler(dtype, static_loss_scale, dynamic_scaling, dynamic_loss_args):
    """Factory mirroring the reference's selection logic (loss_scaler.py)."""
    if dtype == torch.float16 and dynamic_scaling:
        kwargs = dynamic_loss_args or {}
        return DynamicLossScaler(
            init_scale=kwargs.get(INITIAL_LOSS_SCALE, 2**16),
            scale_window=kwargs.get(SCALE_WINDOW, 1000),
            min_scale=kwargs.get(MIN_LOSS_SCALE, 1.0),
            delayed_shift=kwargs.get(DELAYED_SHIFT, 1),
            consecutive_hysteresis=kwargs.get("consecutive_hysteresis", False),
        )
    scale = static_loss_scale if (dtype == torch.float16 and static_loss_scale) else 1.0
    return LossScaler(scale=scale)


def has_inf_or_nan(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """One bool tensor: any non-finite value in any of ``tensors``
    (reference ``_has_inf_or_nan``, stage_1_and_2.py:1909)."""
    flags = [~torch.isfinite(t.float()).all() for t in tensors]
    return torch.stack(flags).any()
