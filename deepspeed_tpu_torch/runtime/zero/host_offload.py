"""ZeRO-Infinity streamed optimizer-state offload (host memory ⇄ card).

Counterpart of ``deepspeed_tpu/runtime/zero/host_offload.py``: the path of
``offload_optimizer.device=cpu`` with ``pipeline_read`` or
``pipeline_write`` on. The engine's own update stays the update engine;
this module only changes where the fp32 master and the Adam moments LIVE
between steps: host tensors (pinned under ``pin_memory`` on a card),
allocated once at engine build, streamed card-ward in whole-leaf buckets of
``bucket_size`` elements through a depth-2 double buffer, updated bucket by
bucket by the engine's ``optimizer.apply`` on the compute stream, and
streamed back into the same host tensors.

Bit-identity is the contract: the engine's per-bucket update replays its
on-card ``_update_from_grads`` op for op (unscale, global norm, clip,
``optimizer.apply``, recast), so the streamed losses, master and fp16 scale
trajectory equal the on-card engine's bit for bit. The streamer performs no
math: it is a buffer manager and a transfer schedule.

Stream discipline (on a card):

* ``h2d_bucket`` allocates the bucket's card tensors on a side stream and
  copies into them there (``non_blocking`` from the host tensors), then
  records an event; ``take_staged`` makes the compute stream wait on that
  event and marks the tensors used by the compute stream
  (``record_stream``), so the allocator frees them only after the update;
* ``d2h_bucket`` makes a second side stream wait for the update (an event
  on the compute stream), copies the new master and moments into the host
  tensors ``non_blocking`` and marks the card tensors used by that stream,
  so the caching allocator cannot hand their memory out while a copy still
  reads it;
* ``materialize_writes`` / ``drain_writes`` are the write fence: they wait
  on the copies' events before the host reads or rewrites the buffers (the
  next step's ``h2d_bucket`` of the same bucket, a checkpoint);
* without ``pipeline_read`` (``pipeline_write``) each upload (writeback)
  is waited on at once, and that wait is counted as exposed.

Byte and time accounting: ``stream_stats`` (bytes, and ``h2d_ms`` /
``d2h_ms`` from CUDA events around each bucket's copies, ``exposed_ms``
the host time spent waiting on them), ``stream_schedule`` (every transfer
and the compute it hides behind) and ``memory_report``.

Crash contract: the host buffers are never trusted across a crash. A kill
mid-stream (``train.mid_offload_stream``) leaves staged buckets live and
host buffers torn; resume rebuilds them from the last committed checkpoint
(``load_state_dict`` / ``set_master_leaves``), never from the buffers.

On the CPU (the tests) the "card" tensors are CPU copies and every copy is
synchronous.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import log_dist

STREAMED_FORMAT = "streamed"


def split_offload_buckets(leaf_sizes: Sequence[int], bucket_size: int) -> List[List[int]]:
    """Greedy whole-leaf grouping: consecutive leaves pack into one bucket
    while the bucket stays under ``bucket_size`` elements; a single leaf
    larger than the budget gets its own bucket (leaves never split)."""
    if bucket_size < 1:
        raise ValueError(f"bucket_size must be >= 1, got {bucket_size}")
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_elems = 0
    for i, n in enumerate(leaf_sizes):
        if cur and cur_elems + n > bucket_size:
            buckets.append(cur)
            cur, cur_elems = [], 0
        cur.append(i)
        cur_elems += n
    if cur:
        buckets.append(cur)
    return buckets


class HostOffloadStreamer:
    """Host-resident fp32 master and Adam moments, streamed per bucket.

    ``master`` is the engine's ``path -> fp32 tensor`` master (this rank's
    slices), in the leaf order the buckets and checkpoints follow (JAX's
    tree order: sorted paths)."""

    def __init__(self, master: Dict[str, torch.Tensor], offload_config, *, mixed_precision: bool,
                 device: torch.device, clock=time.perf_counter):
        cfg = offload_config
        if float(getattr(cfg, "ratio", 1.0)) != 1.0:
            raise ValueError("offload_optimizer.ratio < 1.0 is not supported on the streamed path (all "
                             "optimizer state offloads or none does)")
        if int(getattr(cfg, "buffer_count", 0)) < 2:
            raise ValueError("streamed optimizer offload runs a depth-2 double-buffered pipeline and needs "
                             f"offload_optimizer.buffer_count >= 2; got {cfg.buffer_count}")
        self.pin_memory = bool(getattr(cfg, "pin_memory", False))
        self.pipeline_read = bool(getattr(cfg, "pipeline_read", False))
        self.pipeline_write = bool(getattr(cfg, "pipeline_write", False))
        self.mixed_precision = bool(mixed_precision)
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._clock = clock

        self.names = list(master)
        self._shapes = [tuple(t.shape) for t in master.values()]
        sizes = [max(1, int(np.prod(s))) for s in self._shapes]
        self._buckets = split_offload_buckets(sizes, int(cfg.bucket_size))
        pin = self.pin_memory and self._cuda

        def host(t):
            return torch.empty(t.shape, dtype=torch.float32, pin_memory=pin)

        # allocated once; every writeback lands in place
        self._master = [host(t) for t in master.values()]
        self._exp_avg = [host(t).zero_() for t in master.values()]
        self._exp_avg_sq = [host(t).zero_() for t in master.values()]
        for h, t in zip(self._master, master.values()):
            h.copy_(t.detach(), non_blocking=True)
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()
            self._h2d_stream = torch.cuda.Stream(self.device)
            self._d2h_stream = torch.cuda.Stream(self.device)
        self.step_count = 0

        # in flight: staged uploads (bucket -> (masters, ms, vs, ready event)) and pending writebacks
        self._staged: Dict[int, Tuple[Optional[list], list, list, Any]] = {}
        self._pending: List[Tuple[int, Any, list]] = []
        self._timed: List[Tuple[str, Any, Any]] = []  # (h2d | d2h, start, end) events not yet read
        self._stats = {"h2d_ms": 0.0, "d2h_ms": 0.0, "exposed_ms": 0.0, "h2d_bytes": 0, "d2h_bytes": 0,
                       "steps": 0}
        log_dist(f"HostOffloadStreamer: {3 * sum(m.numel() * 4 for m in self._master) / 1024**2:.1f} MB host "
                 f"state in {len(self._buckets)} bucket(s) (pin_memory={self.pin_memory}, "
                 f"pipeline_read={self.pipeline_read}, pipeline_write={self.pipeline_write})", ranks=[0])

    # -- bucket geometry ------------------------------------------------
    @property
    def num_buckets(self) -> int:
        return len(self._buckets)

    def bucket_indices(self, bi: int) -> List[int]:
        return self._buckets[bi]

    def bucket_names(self, bi: int) -> List[str]:
        return [self.names[i] for i in self._buckets[bi]]

    def _bucket_elems(self, bi: int) -> int:
        return sum(max(1, int(np.prod(self._shapes[i]))) for i in self._buckets[bi])

    # -- the stream helpers ----------------------------------------------
    def _event(self, stream=None):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def h2d_bucket(self, bi: int) -> None:
        """Stage bucket ``bi`` card-ward: moments, and the fp32 master under
        mixed precision (fp32 training keeps the master on the card as the
        parameters). With ``pipeline_read`` the copies run on the side
        stream behind the compute; without it the call waits for them."""
        if bi in self._staged:
            return
        # a pending writeback of this bucket must land first (only reachable with one bucket: the
        # deferred last writeback of step N meets step N+1's first upload)
        if any(p[0] == bi for p in self._pending):
            self.materialize_writes(keep=0)
        idx = self._buckets[bi]
        nbytes = sum(self._exp_avg[i].numel() * 4 * 2 for i in idx)
        if self.mixed_precision:
            nbytes += sum(self._master[i].numel() * 4 for i in idx)
        t0 = self._clock()
        if self._cuda:
            with torch.cuda.stream(self._h2d_stream):
                start = self._event()
                up = lambda bufs: [bufs[i].to(self.device, non_blocking=True) for i in idx]  # noqa: E731
                masters = up(self._master) if self.mixed_precision else None
                ms, vs = up(self._exp_avg), up(self._exp_avg_sq)
                ready = self._event()
            self._timed.append(("h2d", start, ready))
            if not self.pipeline_read:
                ready.synchronize()
        else:
            copy = lambda bufs: [bufs[i].clone() for i in idx]  # noqa: E731
            masters = copy(self._master) if self.mixed_precision else None
            ms, vs, ready = copy(self._exp_avg), copy(self._exp_avg_sq), None
        if not self.pipeline_read:
            self._stats["exposed_ms"] += (self._clock() - t0) * 1e3
        self._stats["h2d_bytes"] += nbytes
        self._staged[bi] = (masters, ms, vs, ready)

    def take_staged(self, bi: int) -> Tuple[Optional[list], list, list]:
        """Bucket ``bi``'s staged card tensors, handed to the update on the
        compute stream (which waits for their upload first). Requires a
        prior ``h2d_bucket(bi)``."""
        masters, ms, vs, ready = self._staged.pop(bi)
        if ready is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(ready)
            for t in (masters or []) + ms + vs:
                t.record_stream(compute)
        return masters, ms, vs

    def discard_staged(self) -> None:
        """Drop every staged bucket (fp16 overflow: the step is skipped and
        the host state is already authoritative)."""
        if self._cuda and self._staged:
            compute = torch.cuda.current_stream(self.device)
            for masters, ms, vs, ready in self._staged.values():
                compute.wait_event(ready)  # the upload finishes before its memory is reused
                for t in (masters or []) + ms + vs:
                    t.record_stream(compute)
        self._staged.clear()

    def d2h_bucket(self, bi: int, new_master: list, new_m: list, new_v: list) -> None:
        """Copy bucket ``bi``'s updated master and moments host-ward into
        the same host tensors, on the side stream once the update is done.
        Without ``pipeline_write`` the writeback is waited on at once."""
        idx = self._buckets[bi]
        t0 = self._clock()
        if self._cuda:
            updated = self._event(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._d2h_stream):
                self._d2h_stream.wait_event(updated)
                start = self._event()
                for bufs, news in ((self._master, new_master), (self._exp_avg, new_m), (self._exp_avg_sq, new_v)):
                    for i, t in zip(idx, news):
                        bufs[i].copy_(t, non_blocking=True)
                        t.record_stream(self._d2h_stream)
                done = self._event()
            self._timed.append(("d2h", start, done))
            self._pending.append((bi, done, list(new_master) + list(new_m) + list(new_v)))
        else:
            for bufs, news in ((self._master, new_master), (self._exp_avg, new_m), (self._exp_avg_sq, new_v)):
                for i, t in zip(idx, news):
                    bufs[i].copy_(t)
            self._pending.append((bi, None, []))
        self._stats["d2h_bytes"] += self._bucket_elems(bi) * 12
        if not self.pipeline_write:
            self.materialize_writes(keep=0)
            self._stats["exposed_ms"] += (self._clock() - t0) * 1e3

    def leaf_tensor(self, name: str, field: str) -> torch.Tensor:
        """The host tensor of ``field`` (``master``, ``exp_avg`` or
        ``exp_avg_sq``) of leaf ``name``: this rank's slice, shaped."""
        bufs = {"master": self._master, "exp_avg": self._exp_avg, "exp_avg_sq": self._exp_avg_sq}[field]
        return bufs[self.names.index(name)]

    # -- windows (compile.multi_step) -------------------------------------------
    def gather_device_state(self):
        """Every bucket card-ward for a multi-step window, which scans the
        whole master and moments on the card (JAX ``host_offload.py:263``):
        ``(masters or None under fp32, exp_avg, exp_avg_sq)`` as lists of
        card tensors in ``names`` order, through ``h2d_bucket``."""
        for bi in range(self.num_buckets):
            self.h2d_bucket(bi)
        n = len(self._master)
        masters: List[Optional[torch.Tensor]] = [None] * n
        ms: List[Optional[torch.Tensor]] = [None] * n
        vs: List[Optional[torch.Tensor]] = [None] * n
        for bi in range(self.num_buckets):
            staged_m, staged_ea, staged_eas = self.take_staged(bi)
            for k, i in enumerate(self._buckets[bi]):
                if staged_m is not None:
                    masters[i] = staged_m[k]
                ms[i], vs[i] = staged_ea[k], staged_eas[k]
        return (masters if self.mixed_precision else None), ms, vs

    def scatter_device_state(self, master_leaves, m_leaves, v_leaves, steps_taken: int) -> None:
        """The window's updated master and moments host-ward, bucket by
        bucket through ``d2h_bucket`` (JAX ``host_offload.py:281``); the
        step count advances by the steps the window took (an overflow-
        skipped step does not count)."""
        for bi in range(self.num_buckets):
            idx = self._buckets[bi]
            self.d2h_bucket(bi, [master_leaves[i] for i in idx], [m_leaves[i] for i in idx],
                            [v_leaves[i] for i in idx])
            self.materialize_writes(keep=1)
        self.step_count += int(steps_taken)

    def materialize_writes(self, keep: int = 0) -> None:
        """Wait until the pending writebacks have landed in the host
        tensors, oldest first, leaving at most ``keep`` in flight (``keep=1``
        is the depth-2 pipeline's steady state)."""
        while len(self._pending) > keep:
            _, done, _tensors = self._pending.pop(0)
            if done is not None:
                t0 = self._clock()
                done.synchronize()
                if self.pipeline_write:
                    self._stats["exposed_ms"] += (self._clock() - t0) * 1e3

    def drain_writes(self) -> None:
        """The write fence: every pending writeback lands before the host
        tensors are read (a snapshot would otherwise mix two steps)."""
        self.materialize_writes(keep=0)

    def _read_timers(self) -> None:
        for kind, start, end in self._timed:
            end.synchronize()
            self._stats[f"{kind}_ms"] += start.elapsed_time(end)
        self._timed.clear()

    # -- declared transfer schedule ----------------------------------------
    def stream_schedule(self) -> Dict[str, Any]:
        """Every per-step transfer, its bytes and the compute it hides
        behind (None = exposed): buckets 0 and 1 upload behind the tail of
        backward, bucket i+2 while bucket i updates, bucket i writes back
        while bucket i+1 updates, and the last writeback lands under the
        next step's forward and backward (JAX ``stream_schedule``)."""
        n = self.num_buckets
        per_elem_h2d = 12 if self.mixed_precision else 8  # fp32: moments only
        transfers = []
        for bi in range(n):
            hide = "fwd_bwd" if bi < 2 else f"offload_bucket_update_b{bi - 2}"
            transfers.append({"name": f"h2d_b{bi}", "direction": "h2d", "bytes": self._bucket_elems(bi) * per_elem_h2d,
                              "hide_behind": hide if self.pipeline_read else None})
        for bi in range(n):
            hide = f"offload_bucket_update_b{bi + 1}" if bi < n - 1 else "fwd_bwd"
            transfers.append({"name": f"d2h_b{bi}", "direction": "d2h", "bytes": self._bucket_elems(bi) * 12,
                              "hide_behind": hide if self.pipeline_write else None})
        return {"anchor": "offload_stats", "compute_programs": ["fwd_bwd"] + [f"offload_bucket_update_b{bi}"
                                                                                for bi in range(n)],
                "transfers": transfers}

    def stream_stats(self) -> Dict[str, Any]:
        """Cumulative bytes each way, the copies' card time (``h2d_ms`` /
        ``d2h_ms``, CUDA events; 0 on the CPU), ``exposed_ms`` (host time
        waiting on copies), steps, buckets and writebacks in flight."""
        if self._cuda:
            self._read_timers()
        out = dict(self._stats)
        out["buckets"] = self.num_buckets
        out["pending_writes"] = len(self._pending)
        return out

    def memory_report(self) -> Dict[str, Any]:
        """Residency: master and moments in host memory; the card holds at
        most the staged upload of the bucket about to update and the
        writeback of the one that just did (``device_residency_bound_bytes``:
        the two largest buckets at 12 bytes an element)."""
        per_elem_staged = 12 if self.mixed_precision else 8
        bucket_bytes = [self._bucket_elems(bi) * 12 for bi in range(self.num_buckets)]
        staged = sum(self._bucket_elems(bi) * per_elem_staged for bi in self._staged)
        pending = sum(self._bucket_elems(p[0]) * 12 for p in self._pending)
        return {"master_location": "host", "host_bytes": 3 * sum(m.numel() * 4 for m in self._master),
                "pinned": bool(self._master and self._master[0].is_pinned()), "buckets": self.num_buckets,
                "bucket_bytes": bucket_bytes, "max_bucket_bytes": max(bucket_bytes, default=0),
                "device_residency_bound_bytes": sum(sorted(bucket_bytes, reverse=True)[:2]),
                "staged_bytes": staged, "pending_bytes": pending, "device_bytes": staged + pending}

    def note_step(self) -> None:
        self._stats["steps"] += 1

    # -- host state --------------------------------------------------------
    def master_leaves(self) -> Dict[str, torch.Tensor]:
        """Copies of the fp32 master (current through the write fence)."""
        self.drain_writes()
        return {k: m.clone() for k, m in zip(self.names, self._master)}

    def state_dict(self) -> Dict[str, Any]:
        """The host state after the write fence, as copies: the live
        buffers keep training while a writer persists these (CPU tensors
        pass through ``host_snapshot`` with no card round trip)."""
        self.drain_writes()
        return {"format": STREAMED_FORMAT, "step": int(self.step_count),
                "leaves": [{"master": self._master[i].clone(), "exp_avg": self._exp_avg[i].clone(),
                            "exp_avg_sq": self._exp_avg_sq[i].clone()} for i in range(len(self._master))]}

    def _check_format(self, state: Dict[str, Any]) -> None:
        fmt = state.get("format") if isinstance(state, dict) else None
        if fmt != STREAMED_FORMAT:
            raise ValueError(
                "this checkpoint's host-offload state was saved by the legacy per-shard offload engine "
                f"(format={fmt!r}); the streamed engine cannot adopt it — load with "
                "offload_optimizer.pipeline_read/pipeline_write disabled, or pass load_optimizer_states=False "
                "to restart the moments")

    def _reset_flight(self) -> None:
        self.discard_staged()
        self.drain_writes()

    def load_state_dict(self, state: Dict[str, Any], slicer=None) -> None:
        """Rebuild the host tensors from a checkpoint's whole leaves (this
        rank's slices by ``slicer(name, whole)``): the only way to
        repopulate them after a crash."""
        self._check_format(state)
        self._reset_flight()
        self.step_count = int(state["step"])
        for i, (name, rec) in enumerate(zip(self.names, state["leaves"])):
            for bufs, key in ((self._master, "master"), (self._exp_avg, "exp_avg"), (self._exp_avg_sq, "exp_avg_sq")):
                bufs[i].copy_(_slice(_host32(rec[key]), name, slicer).reshape(bufs[i].shape))

    def load_master_only(self, state: Dict[str, Any], slicer=None) -> None:
        """Module-only load: the master from the checkpoint, fresh moments
        kept as they are."""
        self._check_format(state)
        self._reset_flight()
        for i, (name, rec) in enumerate(zip(self.names, state["leaves"])):
            self._master[i].copy_(_slice(_host32(rec["master"]), name, slicer).reshape(self._master[i].shape))

    def set_master_leaves(self, leaves: Dict[str, Any]) -> None:
        """Overwrite the host master (this rank's slices, by name)."""
        self._reset_flight()
        for i, name in enumerate(self.names):
            self._master[i].copy_(_host32(leaves[name]).reshape(self._master[i].shape))


def _host32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _slice(t: torch.Tensor, name: str, slicer) -> torch.Tensor:
    return t if slicer is None else slicer(name, t)
