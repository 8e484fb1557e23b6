"""Loss scaling.

Counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py`` (``:23-123``):
``LossScaler`` (static; scale 1 unless fp16 asks for a fixed scale),
``DynamicLossScaler`` (fp16: shrink on overflow after ``delayed_shift``
overflows, grow after ``scale_window`` good steps) and ``has_inf_or_nan``.
As in JAX the state is three device scalars (fp32 scale, int32 good-step
counter and hysteresis) and ``update`` walks them with ``where`` on a
device overflow flag: no host read, so the same update runs inside a
captured CUDA graph. ``update_`` writes the new state into the old state's
tensors in place (a graph replays into the same storage).
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Union

import torch

INITIAL_LOSS_SCALE = "init_scale"
SCALE_WINDOW = "scale_window"
DELAYED_SHIFT = "delayed_shift"
MIN_LOSS_SCALE = "min_scale"


class LossScaleState(NamedTuple):
    scale: torch.Tensor  # fp32 scalar
    good_steps: torch.Tensor  # int32 scalar
    hysteresis: torch.Tensor  # int32 scalar


def make_state(scale, good_steps, hysteresis, device) -> LossScaleState:
    return LossScaleState(scale=torch.tensor(float(scale), dtype=torch.float32, device=device),
                          good_steps=torch.tensor(int(good_steps), dtype=torch.int32, device=device),
                          hysteresis=torch.tensor(int(hysteresis), dtype=torch.int32, device=device))


def _flag(overflow: Union[bool, torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if isinstance(overflow, torch.Tensor):
        return overflow.to(device=like.device, dtype=torch.bool)
    return torch.tensor(bool(overflow), device=like.device)


class LossScalerBase:
    """Static (or no-op) scaling."""

    dynamic = False

    def __init__(self, scale: float = 1.0):
        self.init_scale = float(scale)

    def init_state(self, device="cpu") -> LossScaleState:
        return make_state(self.init_scale, 0, 0, device)

    def update(self, state: LossScaleState, overflow) -> LossScaleState:  # noqa: ARG002
        return state

    @torch.no_grad()
    def update_(self, state: LossScaleState, overflow) -> None:
        """``update`` written into ``state``'s own tensors."""
        new = self.update(state, overflow)
        for old, val in zip(state, new):
            if val is not old:
                old.copy_(val)


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

    def init_state(self, device="cpu") -> LossScaleState:
        return make_state(self.init_scale, 0, self.delayed_shift, device)

    def update(self, state: LossScaleState, overflow) -> LossScaleState:
        """The JAX update (``loss_scaler.py:80-99``) with ``torch.where`` on a
        bool overflow scalar (a device tensor, or a host bool)."""
        ovf = _flag(overflow, state.scale)
        hysteresis = torch.where(ovf, torch.clamp(state.hysteresis - 1, min=0), state.hysteresis)
        must_shrink = ovf & (hysteresis <= 0)
        shrink_scale = torch.clamp(state.scale / self.scale_factor, min=self.min_scale)
        window_full = (state.good_steps + 1) >= self.scale_window
        grow_scale = torch.where(window_full, state.scale * self.scale_factor, state.scale)
        new_scale = torch.where(must_shrink, shrink_scale, torch.where(ovf, state.scale, grow_scale))
        zero = torch.zeros_like(state.good_steps)
        new_good = torch.where(ovf | window_full, zero, state.good_steps + 1)
        shift = torch.full_like(state.hysteresis, self.delayed_shift)
        reset = must_shrink | (~ovf & (not self.consecutive_hysteresis))
        new_hyst = torch.where(reset, shift, hysteresis)
        return LossScaleState(scale=new_scale, good_steps=new_good, hysteresis=new_hyst)


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
