"""Curriculum-learning scheduler.

Counterpart of the reference's ``CurriculumScheduler``
(``deepspeed/runtime/data_pipeline/curriculum_scheduler.py``): maps the
global step to a difficulty value (typically sequence length) under the
``fixed_linear`` / ``fixed_root`` / ``fixed_discrete`` / ``custom``
schedules. The engine truncates each batch's sequence dim to the current
difficulty (the reference injects a ``curriculum_seqlen`` kwarg,
engine.py:1779-1782 — with functional batches, truncation is the cleaner
equivalent and keeps the number of step shapes small).

The port's own copy of
``deepspeed_tpu/runtime/data_pipeline/curriculum_scheduler.py``
(the port imports nothing of the JAX package): the same names and the
same numbers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

CURRICULUM_LEARNING_MIN_DIFFICULTY = "min_difficulty"
CURRICULUM_LEARNING_MAX_DIFFICULTY = "max_difficulty"
CURRICULUM_LEARNING_SCHEDULE_TYPE = "schedule_type"
CURRICULUM_LEARNING_SCHEDULE_CONFIG = "schedule_config"
CURRICULUM_LEARNING_SCHEDULE_FIXED_LINEAR = "fixed_linear"
CURRICULUM_LEARNING_SCHEDULE_FIXED_ROOT = "fixed_root"
CURRICULUM_LEARNING_SCHEDULE_FIXED_DISCRETE = "fixed_discrete"
CURRICULUM_LEARNING_SCHEDULE_CUSTOM = "custom"
CURRICULUM_LEARNING_SCHEDULE_TOTAL_STEP = "total_curriculum_step"
CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY_STEP = "difficulty_step"
CURRICULUM_LEARNING_SCHEDULE_ROOT_DEGREE = "root_degree"
CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY = "difficulty"
CURRICULUM_LEARNING_SCHEDULE_MAX_STEP = "max_step"


class CurriculumScheduler:
    def __init__(self, config: Dict[str, Any]):
        self.state: Dict[str, Any] = {}
        for key in (
            CURRICULUM_LEARNING_MIN_DIFFICULTY,
            CURRICULUM_LEARNING_MAX_DIFFICULTY,
            CURRICULUM_LEARNING_SCHEDULE_TYPE,
        ):
            assert key in config, f"curriculum learning config missing '{key}'"
        self.state[CURRICULUM_LEARNING_MIN_DIFFICULTY] = config[CURRICULUM_LEARNING_MIN_DIFFICULTY]
        self.state[CURRICULUM_LEARNING_MAX_DIFFICULTY] = config[CURRICULUM_LEARNING_MAX_DIFFICULTY]
        self.state[CURRICULUM_LEARNING_SCHEDULE_TYPE] = config[CURRICULUM_LEARNING_SCHEDULE_TYPE]
        self.state["current_difficulty"] = config[CURRICULUM_LEARNING_MIN_DIFFICULTY]
        schedule_type = config[CURRICULUM_LEARNING_SCHEDULE_TYPE]
        schedule_config = config.get(CURRICULUM_LEARNING_SCHEDULE_CONFIG, {})
        self.custom_get_difficulty: Optional[Callable[[int], int]] = None

        if schedule_type == CURRICULUM_LEARNING_SCHEDULE_FIXED_LINEAR:
            assert CURRICULUM_LEARNING_SCHEDULE_TOTAL_STEP in schedule_config
            assert CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY_STEP in schedule_config
        elif schedule_type == CURRICULUM_LEARNING_SCHEDULE_FIXED_ROOT:
            assert CURRICULUM_LEARNING_SCHEDULE_TOTAL_STEP in schedule_config
            assert CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY_STEP in schedule_config
            assert CURRICULUM_LEARNING_SCHEDULE_ROOT_DEGREE in schedule_config
        elif schedule_type == CURRICULUM_LEARNING_SCHEDULE_FIXED_DISCRETE:
            assert CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY in schedule_config
            assert CURRICULUM_LEARNING_SCHEDULE_MAX_STEP in schedule_config
            assert len(schedule_config[CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY]) > 0
            assert len(schedule_config[CURRICULUM_LEARNING_SCHEDULE_MAX_STEP]) == len(
                schedule_config[CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY]
            ) - 1
        elif schedule_type == CURRICULUM_LEARNING_SCHEDULE_CUSTOM:
            pass
        else:
            raise RuntimeError(f"Unsupported curriculum schedule type {schedule_type}")
        self.state[CURRICULUM_LEARNING_SCHEDULE_CONFIG] = schedule_config

    # --- reference surface ----------------------------------------------
    def get_current_difficulty(self) -> int:
        return self.state["current_difficulty"]

    def set_current_difficulty(self, difficulty: int) -> None:
        self.state["current_difficulty"] = difficulty

    def set_custom_get_difficulty(self, schedule_function: Callable[[int], int]) -> None:
        self.custom_get_difficulty = schedule_function

    def get_state(self) -> Dict[str, Any]:
        return self.state

    def set_state(self, state: Dict[str, Any]) -> None:
        self.state = state

    def _fixed_linear(self, global_steps: int) -> int:
        cfg = self.state[CURRICULUM_LEARNING_SCHEDULE_CONFIG]
        mind = self.state[CURRICULUM_LEARNING_MIN_DIFFICULTY]
        maxd = self.state[CURRICULUM_LEARNING_MAX_DIFFICULTY]
        total = cfg[CURRICULUM_LEARNING_SCHEDULE_TOTAL_STEP]
        stepd = cfg[CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY_STEP]
        next_difficulty = mind + (maxd - mind) * min(1.0, global_steps / total)
        next_difficulty = int(next_difficulty / stepd) * stepd
        return max(mind, min(maxd, next_difficulty))

    def _fixed_root(self, global_steps: int) -> int:
        cfg = self.state[CURRICULUM_LEARNING_SCHEDULE_CONFIG]
        mind = self.state[CURRICULUM_LEARNING_MIN_DIFFICULTY]
        maxd = self.state[CURRICULUM_LEARNING_MAX_DIFFICULTY]
        total = cfg[CURRICULUM_LEARNING_SCHEDULE_TOTAL_STEP]
        stepd = cfg[CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY_STEP]
        degree = cfg[CURRICULUM_LEARNING_SCHEDULE_ROOT_DEGREE]
        frac = min(1.0, global_steps / total) ** (1.0 / degree)
        next_difficulty = mind + (maxd - mind) * frac
        next_difficulty = int(next_difficulty / stepd) * stepd
        return max(mind, min(maxd, next_difficulty))

    def _fixed_discrete(self, global_steps: int) -> int:
        cfg = self.state[CURRICULUM_LEARNING_SCHEDULE_CONFIG]
        difficulties = cfg[CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY]
        max_steps = cfg[CURRICULUM_LEARNING_SCHEDULE_MAX_STEP]
        for d, s in zip(difficulties, max_steps):
            if global_steps <= s:
                return d
        return difficulties[-1]

    def update_difficulty(self, global_steps: int) -> int:
        t = self.state[CURRICULUM_LEARNING_SCHEDULE_TYPE]
        if t == CURRICULUM_LEARNING_SCHEDULE_FIXED_LINEAR:
            d = self._fixed_linear(global_steps)
        elif t == CURRICULUM_LEARNING_SCHEDULE_FIXED_ROOT:
            d = self._fixed_root(global_steps)
        elif t == CURRICULUM_LEARNING_SCHEDULE_FIXED_DISCRETE:
            d = self._fixed_discrete(global_steps)
        else:
            assert self.custom_get_difficulty is not None, "custom schedule needs a function"
            d = self.custom_get_difficulty(global_steps)
        self.state["current_difficulty"] = d
        return d
