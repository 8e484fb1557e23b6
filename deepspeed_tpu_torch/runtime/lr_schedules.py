"""LR schedules: a copy of ``deepspeed_tpu/runtime/lr_schedules.py``
(pure Python). LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR,
WarmupCosineLR and the ``add_tuning_arguments`` CLI surface. Schedulers
mutate ``optimizer.param_groups[i]['lr']``; the training engine reads group
0's lr at every optimizer step.
"""

from __future__ import annotations

import argparse
import math
from typing import List, Optional

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]

WARMUP_MIN_LR = "warmup_min_lr"
WARMUP_MAX_LR = "warmup_max_lr"
WARMUP_NUM_STEPS = "warmup_num_steps"
WARMUP_TYPE = "warmup_type"
WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"
TOTAL_NUM_STEPS = "total_num_steps"


def add_tuning_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group("Convergence Tuning", "Convergence tuning configurations")
    group.add_argument("--lr_schedule", type=str, default=None, help="LR schedule for training.")
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001)
    group.add_argument("--lr_range_test_step_size", type=int, default=1000)
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0)
    group.add_argument("--lr_range_test_staircase", type=bool, default=False)
    group.add_argument("--cycle_first_step_size", type=int, default=1000)
    group.add_argument("--cycle_first_stair_count", type=int, default=1)
    group.add_argument("--cycle_second_step_size", type=int, default=None)
    group.add_argument("--cycle_second_stair_count", type=int, default=None)
    group.add_argument("--decay_step_size", type=int, default=1000)
    group.add_argument("--cycle_min_lr", type=float, default=0.01)
    group.add_argument("--cycle_max_lr", type=float, default=0.1)
    group.add_argument("--decay_lr_rate", type=float, default=0.0)
    group.add_argument("--cycle_min_mom", type=float, default=0.8)
    group.add_argument("--cycle_max_mom", type=float, default=0.9)
    group.add_argument("--decay_mom_rate", type=float, default=0.0)
    group.add_argument("--warmup_min_lr", type=float, default=0)
    group.add_argument("--warmup_max_lr", type=float, default=0.001)
    group.add_argument("--warmup_num_steps", type=int, default=1000)
    group.add_argument("--warmup_type", type=str, default=WARMUP_LOG_RATE)
    return parser


class _LRSchedulerBase:
    def __init__(self, optimizer, last_batch_iteration: int = -1):
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration

    def _update_lrs(self, lrs: List[float]) -> None:
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        self._last_lr = lrs

    def get_lr(self) -> List[float]:
        raise NotImplementedError

    def get_last_lr(self) -> List[float]:
        assert getattr(self, "_last_lr", None) is not None, "need to call step() first"
        return self._last_lr

    def step(self, last_batch_iteration: Optional[int] = None) -> None:
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._update_lrs(self.get_lr())

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]
        # re-apply the restored schedule to optimizer.param_groups: an
        # uninterrupted run's step() already wrote this lr after the last
        # pre-save step, so a resumed run must start from the same value —
        # without this the first post-resume update silently consumes the
        # fresh-engine init lr (exact-resume parity catches it as a loss
        # divergence on the SECOND resumed step)
        if self.last_batch_iteration >= 0:
            self._update_lrs(self.get_lr())


class LRRangeTest(_LRSchedulerBase):
    """Linearly/staircase-growing lr for range tests (Smith 2017)."""

    def __init__(
        self,
        optimizer,
        lr_range_test_min_lr: float = 1e-3,
        lr_range_test_step_size: int = 2000,
        lr_range_test_step_rate: float = 1.0,
        lr_range_test_staircase: bool = False,
        last_batch_iteration: int = -1,
    ):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        if last_batch_iteration == -1:
            self._update_lrs([self.min_lr] * len(optimizer.param_groups))

    def get_lr(self) -> List[float]:
        count = self.last_batch_iteration / self.step_size
        if self.staircase:
            count = math.floor(count)
        return [self.min_lr * (1 + count * self.step_rate)] * len(self.optimizer.param_groups)


class OneCycle(_LRSchedulerBase):
    """1-cycle lr (and momentum) policy."""

    def __init__(
        self,
        optimizer,
        cycle_min_lr: float,
        cycle_max_lr: float,
        decay_lr_rate: float = 0.0,
        cycle_first_step_size: int = 2000,
        cycle_second_step_size: Optional[int] = None,
        cycle_first_stair_count: int = 0,
        cycle_second_stair_count: Optional[int] = None,
        decay_step_size: int = 0,
        cycle_momentum: bool = True,
        cycle_min_mom: float = 0.8,
        cycle_max_mom: float = 0.9,
        decay_mom_rate: float = 0.0,
        last_batch_iteration: int = -1,
    ):
        super().__init__(optimizer, last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_size = cycle_first_step_size
        self.second_size = cycle_second_step_size or cycle_first_step_size
        self.decay_step_size = decay_step_size
        self.total_size = self.first_size + self.second_size
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate

    def get_lr(self) -> List[float]:
        it = max(self.last_batch_iteration, 0)
        if it <= self.total_size:
            if it <= self.first_size:
                scale = it / self.first_size
            else:
                scale = 1.0 - (it - self.first_size) / self.second_size
            lr = self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * scale
        else:
            decay_steps = (it - self.total_size) / max(self.decay_step_size, 1)
            lr = self.cycle_min_lr / (1.0 + self.decay_lr_rate * decay_steps)
        return [lr] * len(self.optimizer.param_groups)


class WarmupLR(_LRSchedulerBase):
    """Warmup from min to max lr, then hold (reference WarmupLR)."""

    def __init__(
        self,
        optimizer,
        warmup_min_lr: float = 0.0,
        warmup_max_lr: float = 0.001,
        warmup_num_steps: int = 1000,
        warmup_type: str = WARMUP_LOG_RATE,
        last_batch_iteration: int = -1,
    ):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lr = warmup_min_lr
        self.max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def _warmup_scale(self, it: int) -> float:
        if self.warmup_type == WARMUP_LOG_RATE:
            return self.inverse_log_warm_up * math.log(it + 1)
        return it / self.warmup_num_steps

    def get_lr(self) -> List[float]:
        it = max(self.last_batch_iteration, 0)
        if it < self.warmup_num_steps:
            scale = self._warmup_scale(it)
            lr = self.min_lr + (self.max_lr - self.min_lr) * scale
        else:
            lr = self._post_warmup_lr(it)
        return [lr] * len(self.optimizer.param_groups)

    def _post_warmup_lr(self, it: int) -> float:  # noqa: ARG002
        return self.max_lr


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to 0 over total_num_steps."""

    def __init__(
        self,
        optimizer,
        total_num_steps: int,
        warmup_min_lr: float = 0.0,
        warmup_max_lr: float = 0.001,
        warmup_num_steps: int = 1000,
        warmup_type: str = WARMUP_LOG_RATE,
        last_batch_iteration: int = -1,
    ):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type, last_batch_iteration)

    def _post_warmup_lr(self, it: int) -> float:
        frac = (self.total_num_steps - it) / max(self.total_num_steps - self.warmup_num_steps, 1)
        return self.max_lr * max(0.0, frac)


class WarmupCosineLR(WarmupLR):
    """Warmup then cosine decay to cos_min_ratio."""

    def __init__(
        self,
        optimizer,
        total_num_steps: int,
        warmup_min_ratio: float = 0.0,
        warmup_num_steps: int = 1000,
        cos_min_ratio: float = 1e-4,
        warmup_type: str = WARMUP_LINEAR_RATE,
        last_batch_iteration: int = -1,
    ):
        self.total_num_steps = total_num_steps
        self.cos_min_ratio = cos_min_ratio
        base_lr = optimizer.param_groups[0]["lr"]
        super().__init__(
            optimizer,
            warmup_min_lr=base_lr * warmup_min_ratio,
            warmup_max_lr=base_lr,
            warmup_num_steps=warmup_num_steps,
            warmup_type=warmup_type,
            last_batch_iteration=last_batch_iteration,
        )

    def _post_warmup_lr(self, it: int) -> float:
        progress = (it - self.warmup_num_steps) / max(self.total_num_steps - self.warmup_num_steps, 1)
        progress = min(max(progress, 0.0), 1.0)
        cosine = 0.5 * (1 + math.cos(math.pi * progress))
        return self.max_lr * (self.cos_min_ratio + (1 - self.cos_min_ratio) * cosine)


SCHEDULER_REGISTRY = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
    WARMUP_COSINE_LR: WarmupCosineLR,
}


def get_lr_scheduler(name: str, optimizer, **params):
    if name not in SCHEDULER_REGISTRY:
        raise ValueError(f"unknown lr schedule {name!r}; valid: {VALID_LR_SCHEDULES}")
    return SCHEDULER_REGISTRY[name](optimizer, **params)
