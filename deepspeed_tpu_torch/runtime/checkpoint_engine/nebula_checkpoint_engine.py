"""Async tiered checkpoint engine.

Counterpart of ``deepspeed_tpu/runtime/checkpoint_engine/
nebula_checkpoint_engine.py`` (the reference's ``NebulaCheckpointEngine``,
``runtime/checkpoint_engine/nebula_checkpoint_engine.py:20``): ``save``
returns once the state is snapshotted to host memory and persists it from a
background thread through the torch engine, so the train loop never waits
for the file system; ``commit`` fences the pending write first.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from deepspeed_tpu_torch.runtime.checkpoint_engine.async_snapshot import host_snapshot
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import CheckpointEngine
from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_checkpoint_engine import TorchCheckpointEngine
from deepspeed_tpu_torch.utils.logging import logger


class NebulaCheckpointEngine(CheckpointEngine):
    def __init__(self, config_params=None, enable_nebula_load: bool = True):
        super().__init__(config_params)
        self.inner = TorchCheckpointEngine(config_params)
        self.enable_nebula_load = enable_nebula_load
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def create(self, tag: str) -> None:
        self.inner.create(tag)

    def save(self, state_dict: Any, path: str) -> None:
        self._wait()
        host_state, _ = host_snapshot(state_dict)  # tier 1: host memory now, disk in the background

        def _persist():
            try:
                self.inner.save(host_state, path)
            except BaseException as e:  # re-raised at the next fence
                self._error = e

        self._pending = threading.Thread(target=_persist, daemon=True)
        self._pending.start()
        logger.info(f"nebula: async persisting checkpoint to {path}")

    def load(self, path: str, map_location=None) -> Any:
        self._wait()
        return self.inner.load(path, map_location)

    def commit(self, tag: str) -> bool:
        self._wait()
        return self.inner.commit(tag)

    def _wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"nebula background persist failed: {err}")
