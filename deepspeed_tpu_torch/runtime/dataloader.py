"""Dataloader.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py`` (numpy, the same
cursor contract byte for byte): ``DeepSpeedDataLoader`` yields *global*
micro batches as numpy (the engine takes each rank's rows when it places a
batch), ``RepeatingLoader`` restarts it, and ``PrefetchingLoader`` keeps
batches pulled ahead, each placed on the card by the engine's ``place_fn``
(pinned host buffers and ``non_blocking`` copies on a side stream, ordered
by an event: ``runtime/engine.py:_place_ahead``) while the step before it
still runs. Its ``state_dict`` is the cursor of the first batch not yet
handed out, so a checkpoint cut while batches wait resumes on them.
"""

from __future__ import annotations

import copy
import math
from collections import deque
from typing import Callable, Optional

import numpy as np


def _default_collate(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: _default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_default_collate([it[i] for it in items]) for i in range(len(first)))
    return np.stack([np.asarray(it) for it in items])


class RepeatingLoader:
    """Wraps an iterator to restart on StopIteration (reference pipe utils).

    Carries a resumable cursor for exact-resume checkpointing: when the
    wrapped loader exposes ``state_dict``/``load_state_dict`` (as
    ``DeepSpeedDataLoader`` does) the inner cursor is delegated to;
    otherwise the served-batch count is recorded and replayed best-effort."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)
        self.batches_served = 0

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        self.batches_served += 1
        return batch

    def state_dict(self):
        sd = {"batches_served": self.batches_served}
        if hasattr(self.loader, "state_dict"):
            sd["loader"] = self.loader.state_dict()
        return sd

    def load_state_dict(self, sd) -> None:
        self.batches_served = int(sd.get("batches_served", 0))
        if "loader" in sd and hasattr(self.loader, "load_state_dict"):
            self.loader.load_state_dict(sd["loader"])
            self.data_iter = iter(self.loader)
            return
        # opaque inner iterable: replay from the start (deterministic
        # loaders land on the same cursor; anything else cannot be resumed
        # exactly and should expose state_dict itself). Replay restarts on
        # exhaustion exactly like __next__ — batches_served is cumulative
        # across wraparounds, so an unsized loader replays whole passes.
        self.data_iter = iter(self.loader)
        try:
            n = len(self.loader)
        except TypeError:
            n = 0
        for _ in range(self.batches_served % n if n else self.batches_served):
            try:
                next(self.data_iter)
            except StopIteration:
                self.data_iter = iter(self.loader)
                next(self.data_iter)


class PrefetchingLoader:
    """Double-buffered input pipeline.

    Wraps a batch source (an iterator, or an iterable like
    :class:`DeepSpeedDataLoader`) and keeps up to ``depth`` batches pulled
    ahead, applying ``place_fn`` — typically the engine's sharded
    host-to-device copy (``engine._place_ahead``) — at PULL time. The copy
    of batch i+1 is therefore enqueued while step/window i is still
    computing on device, taking the fetch and the copy off the step's
    critical path.

    Exact-resume contract (a mid-epoch resume must keep holding):
    pulling ahead advances the underlying loader's cursor past batches that
    have NOT been trained yet, so ``state_dict()`` here reports the cursor
    of the first *undelivered* batch — a snapshot of ``state_source``
    (default: the wrapped source, when it exposes ``state_dict``) taken
    immediately before each pull. A checkpoint cut mid-prefetch thus
    replays the buffered-but-untrained batches on resume instead of
    skipping them. ``load_state_dict`` drops the stale buffer, restores the
    source cursor, and re-iterates the source — it therefore requires a
    RE-ITERABLE source (wrap the loader itself); over a bare iterator it
    raises, because a running generator cannot rewind (rebuild the wrapper
    after restoring the loader's cursor instead, as the engine does).
    """

    def __init__(self, source, place_fn: Optional[Callable] = None, depth: int = 1, state_source=None):
        self._source = source
        self._iter = iter(source)
        self.place_fn = place_fn
        self.depth = max(int(depth), 0)
        if state_source is None and hasattr(source, "state_dict"):
            state_source = source
        self._state_source = state_source
        self._buf: deque = deque()  # (placed_batch, cursor_snapshot_before_pull)
        self._exhausted = False

    def _snap(self):
        if self._state_source is None:
            return None
        return copy.deepcopy(self._state_source.state_dict())

    def _pull(self) -> bool:
        """Stage one more batch (snapshot cursor, fetch, place). False once
        the source is exhausted — StopIteration is latched so a generator
        source is never advanced past its end twice."""
        if self._exhausted:
            return False
        snap = self._snap()
        try:
            batch = next(self._iter)
        except StopIteration:
            self._exhausted = True
            return False
        if self.place_fn is not None:
            batch = self.place_fn(batch)
        self._buf.append((batch, snap))
        return True

    def fill(self, n: Optional[int] = None) -> int:
        """Pull until ``n`` (default: ``depth``) batches are buffered or the
        source runs dry; returns the buffered count. The window former uses
        this to ask 'does a full window of data exist?' without consuming."""
        target = self.depth if n is None else int(n)
        while len(self._buf) < target and self._pull():
            pass
        return len(self._buf)

    def buffered(self) -> int:
        return len(self._buf)

    def __iter__(self):
        return self

    def __next__(self):
        if not self._buf and not self._pull():
            raise StopIteration
        batch, _ = self._buf.popleft()
        # top back up: this is the double buffer — the NEXT batch's
        # device_put is enqueued now, while the consumer's current
        # step/window still owns the device
        self.fill(self.depth)
        return batch

    def state_dict(self) -> Optional[dict]:
        """Cursor of the first undelivered batch (see class docstring)."""
        if self._buf:
            snap = self._buf[0][1]
            return copy.deepcopy(snap) if snap is not None else None
        return self._snap()

    def load_state_dict(self, sd) -> None:
        if iter(self._source) is self._source:
            # a running iterator/generator cannot rewind: "restoring" it
            # would silently skip every staged-but-untrained batch — the
            # exact sample loss this class exists to prevent. Only a
            # RE-ITERABLE source (the loader itself) can resume in place;
            # iterator-wrapped pipelines rebuild the wrapper after
            # restoring the loader's own cursor (what the engine does).
            raise ValueError(
                "PrefetchingLoader.load_state_dict requires a re-iterable "
                "source (wrap the loader, not iter(loader)): a bare "
                "iterator cannot rewind to the restored cursor; restore "
                "the loader's cursor and rebuild the wrapper instead"
            )
        self._buf.clear()
        self._exhausted = False
        if self._state_source is not None and sd is not None:
            self._state_source.load_state_dict(sd)
        self._iter = iter(self._source)


class DeepSpeedDataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Optional[Callable] = None,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        num_local_io_workers: Optional[int] = None,  # noqa: ARG002 - API parity
        data_sampler=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.post_process_func = None
        self.data_sampler = data_sampler
        self.epoch = 0
        # resumable data cursor (exact-resume checkpointing): batches
        # yielded in the current epoch, saved via state_dict and consumed
        # ONCE by the next __iter__ after load_state_dict
        self._cursor = 0
        self._resume_cursor = 0
        try:
            self._len = len(dataset)
        except TypeError:
            self._len = None

    def __len__(self) -> int:
        if self._len is None:
            raise TypeError("dataset has no length")
        if self.drop_last:
            return self._len // self.batch_size
        return math.ceil(self._len / self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Select the epoch; cursors reset only when it actually CHANGES.
        The canonical resumed loop calls ``set_epoch(current_epoch)`` right
        after ``load_checkpoint`` — that must not wipe the restored
        mid-epoch cursor, or the resumed run silently re-serves already
        trained batches."""
        if epoch != self.epoch:
            self._cursor = 0
            self._resume_cursor = 0
        self.epoch = epoch

    def state_dict(self) -> dict:
        """The data cursor: where in which epoch the loader stands. Saved
        into checkpoints so an ``auto_resume`` run replays the EXACT batch
        sequence an uninterrupted run would have seen."""
        return {"epoch": self.epoch, "cursor": self._cursor}

    def load_state_dict(self, sd: dict) -> None:
        self.epoch = int(sd.get("epoch", 0))
        self._cursor = int(sd.get("cursor", 0))
        self._resume_cursor = self._cursor

    def _indices(self):
        n = self._len
        order = np.arange(n)
        if self.data_sampler is not None:
            order = np.asarray(list(iter(self.data_sampler)))
        elif self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        return order

    def __iter__(self):
        start, self._resume_cursor = self._resume_cursor, 0
        if self._len is None:
            # iterable dataset: batch on the fly (resume = deterministic
            # replay past the already-consumed batches)
            for b, batch in enumerate(self._iter_stream()):
                if b < start:
                    continue
                self._cursor = b + 1
                yield self._post(batch)
            self.epoch += 1
            self._cursor = 0
            return
        order = self._indices()
        n_batches = len(self)
        for b in range(min(start, n_batches), n_batches):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            items = [self.dataset[int(i)] for i in idx]
            self._cursor = b + 1
            yield self._post(self.collate_fn(items))
        # a completed pass rolls the cursor into the next epoch, so a
        # RepeatingLoader's wraparound is captured in the saved state
        self.epoch += 1
        self._cursor = 0

    def _post(self, batch):
        """Data-efficiency hook (reference engine.set_data_post_process_func
        -> dataloader.post_process_func): applied to each emitted batch."""
        return self.post_process_func(batch) if self.post_process_func else batch

    def _iter_stream(self):
        buf = []
        for item in self.dataset:
            buf.append(item)
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.collate_fn(buf)
