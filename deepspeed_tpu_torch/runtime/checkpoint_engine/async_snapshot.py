"""Async atomic checkpointing: snapshot device→host, persist in background.

Counterpart of ``deepspeed_tpu/runtime/checkpoint_engine/async_snapshot.py``:

* ``host_snapshot`` enqueues **every tensor's device→host copy first**
  (``non_blocking`` into pinned buffers) and waits once, on an event
  recorded after the last copy. This is the only on-step cost (the engine's
  ``last_stall_ms``). It must finish before returning: the engine updates
  its master, compute weights and moments in place, so the next step would
  overwrite any snapshot that only held references. CPU tensors are
  cloned for the same reason; other leaves are deep-copied.
* ``PinnedPool`` keeps the pinned buffers of finished snapshots for the
  next one, so a save pays the copy, not the pinning of fresh host memory.
* the snapshot goes to a background writer thread that runs the staged
  atomic save (``torch_checkpoint_engine.py``), the commit rename and the
  ``latest`` marker. The writer touches no CUDA tensor.
* up to ``max_inflight`` snapshots may be queued; a save beyond that waits
  for the oldest write to drain (bounding host memory at ``max_inflight``
  state copies).

Crash semantics: the writer thread catches ``Exception`` (re-raised at the
next ``submit`` / ``wait``) but not ``BaseException``: a chaos
``ChaosKilled`` kills the thread mid-write as a real ``kill -9`` would,
leaving staged, uncommitted garbage that the atomic layout survives.
"""

from __future__ import annotations

import atexit
import copy
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.profiling.tracer import NULL_TRACER
from deepspeed_tpu_torch.runtime.checkpoint_engine.atomic import write_latest_marker
from deepspeed_tpu_torch.utils.logging import logger

# A clean interpreter exit must flush every queued snapshot. The drain is
# registered through threading._register_atexit (it runs before the
# non-daemon threads are joined), lazily at the first writer.
_LIVE_WRITERS: "weakref.WeakSet" = weakref.WeakSet()
_DRAIN_REGISTERED = False


def _drain_live_writers() -> None:
    for writer in list(_LIVE_WRITERS):
        try:
            writer.wait()
        except Exception as e:
            logger.error(f"checkpoint writer drain at exit failed: {e}")


def _register_exit_drain() -> None:
    global _DRAIN_REGISTERED
    if _DRAIN_REGISTERED:
        return
    _DRAIN_REGISTERED = True
    register = getattr(threading, "_register_atexit", None)
    if register is not None:  # CPython 3.9+
        register(_drain_live_writers)
    else:  # the non-daemon worker is the backstop
        atexit.register(_drain_live_writers)


class PinnedPool:
    """Pinned host buffers by ``(shape, dtype)``, reused across snapshots.
    ``take`` hands out a free buffer or pins a new one; ``give`` returns a
    snapshot's buffers once its write is done."""

    def __init__(self):
        self._free: Dict[Tuple[Tuple[int, ...], torch.dtype], List[torch.Tensor]] = {}
        self._lock = threading.Lock()

    def take(self, like: torch.Tensor) -> torch.Tensor:
        key = (tuple(like.shape), like.dtype)
        with self._lock:
            free = self._free.get(key)
            if free:
                return free.pop()
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def give(self, buffers) -> None:
        with self._lock:
            for b in buffers:
                self._free.setdefault((tuple(b.shape), b.dtype), []).append(b)

    def nbytes(self) -> int:
        with self._lock:
            return sum(b.numel() * b.element_size() for free in self._free.values() for b in free)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def host_snapshot(tree: Any, pool: Optional[PinnedPool] = None) -> Tuple[Any, List[torch.Tensor]]:
    """``(host_tree, pinned)``: the state tree on the host, safe to hand to
    another thread while the engine keeps updating its tensors in place,
    and the pinned buffers it uses (give them back to ``pool`` when the
    write is done). Every device→host copy is enqueued before any is
    awaited."""
    pinned: List[torch.Tensor] = []

    def snap(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type == "cpu":
                return x.clone(memory_format=torch.contiguous_format)
            dst = pool.take(x) if pool is not None else torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            dst.copy_(x, non_blocking=True)
            pinned.append(dst)
            return dst
        return copy.deepcopy(x)

    host = _map_tree(snap, tree)
    if pinned:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return host, pinned


@dataclass
class _Job:
    state: Any
    path: str
    tag: str
    save_dir: Optional[str]  # None = skip the latest-marker update
    release: Optional[Callable[[], None]] = None  # hands the snapshot's buffers back
    done: threading.Event = field(default_factory=threading.Event)


class AsyncCheckpointWriter:
    """Background persister over a (staged, atomic) checkpoint engine."""

    def __init__(self, inner, max_inflight: int = 2, tracer=None):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.inner = inner
        self.max_inflight = int(max_inflight)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._jobs: deque = deque()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.saves = 0
        self.last_save_s = 0.0
        _LIVE_WRITERS.add(self)
        _register_exit_drain()

    # --- public surface -------------------------------------------------
    def submit(self, host_state: Any, path: str, tag: str, save_dir: Optional[str],
               release: Optional[Callable[[], None]] = None) -> None:
        """Queue one snapshot for persistence. Blocks only while
        ``max_inflight`` older writes are still draining."""
        self._raise_pending_error()
        job = _Job(state=host_state, path=path, tag=tag, save_dir=save_dir, release=release)
        while True:
            with self._lock:
                self._reap_locked()
                if self._thread is not None and not self._thread.is_alive() and self._jobs:
                    # the writer died mid-queue (a chaos kill): drop what it
                    # will never drain, so the caller is not wedged
                    self._jobs.clear()
                if len(self._jobs) < self.max_inflight:
                    self._jobs.append(job)
                    self._ensure_worker_locked()
                    return
                oldest = self._jobs[0]
            oldest.done.wait(timeout=0.05)

    def wait(self) -> None:
        """Fence: block until every queued write has committed (or the
        writer died), then re-raise any persist error."""
        while True:
            with self._lock:
                self._reap_locked()
                if not self._jobs:
                    break
                job = self._jobs[0]
                dead = self._thread is None or not self._thread.is_alive()
            if dead:
                with self._lock:
                    self._jobs.clear()
                break
            job.done.wait(timeout=0.05)
        self._raise_pending_error()

    def pending(self) -> int:
        with self._lock:
            self._reap_locked()
            return len(self._jobs)

    # --- internals -------------------------------------------------------
    def _raise_pending_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint persist failed: {err}") from err

    def _reap_locked(self) -> None:
        while self._jobs and self._jobs[0].done.is_set():
            self._jobs.popleft()

    def _ensure_worker_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            # non-daemon and alive only while the queue is non-empty: the
            # interpreter's join waits out an in-flight write
            self._thread = threading.Thread(target=self._run, name="ckpt-writer", daemon=False)
            self._thread.start()

    @staticmethod
    def _finish(job: _Job) -> None:
        job.state = None
        if job.release is not None:
            job.release()
        job.done.set()

    def _run(self) -> None:
        while True:
            with self._lock:
                self._reap_locked()
                if not self._jobs:
                    self._thread = None
                    return
                job = self._jobs[0]
            try:
                t0 = time.perf_counter()
                with self.tracer.span("ckpt.stage", tag=job.tag):
                    self.inner.save(job.state, job.path)
                with self.tracer.span("ckpt.commit", tag=job.tag):
                    self.inner.commit(job.tag)
                    if job.save_dir is not None:
                        write_latest_marker(job.save_dir, job.tag)
                self.last_save_s = time.perf_counter() - t0
                self.saves += 1
            except Exception as e:  # re-raised at the next fence
                self._error = e
                logger.error(f"async checkpoint persist failed: {e}")
            except BaseException:
                # a kill mid-write: this write dies as the process would,
                # torn staging stays on disk, no error is recorded; a
                # replacement worker takes the later (independent) snapshots
                self._finish(job)
                with self._lock:
                    self._thread = None
                    self._reap_locked()
                    if self._jobs:
                        self._ensure_worker_locked()
                return
            self._finish(job)
