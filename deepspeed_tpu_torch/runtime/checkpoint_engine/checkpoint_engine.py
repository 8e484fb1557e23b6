"""Checkpoint engine base class (reference
``deepspeed/runtime/checkpoint_engine/checkpoint_engine.py:9``; the port's
copy of ``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``)."""

from __future__ import annotations


class CheckpointEngine:
    def __init__(self, config_params=None):
        self.config_params = config_params

    def create(self, tag: str) -> None:
        """Log/prepare for a checkpoint under ``tag``."""

    def save(self, state_dict, path: str) -> None:
        raise NotImplementedError

    def load(self, path: str, map_location=None, target=None):
        raise NotImplementedError

    def commit(self, tag: str) -> bool:
        """Flush/finalize everything saved under ``tag``."""
        return True
