"""Append-only request journal for serving crash recovery.

Counterpart of ``deepspeed_tpu/inference/journal.py`` (no JAX; the port
keeps its own copy, and takes ``fsync_dir`` from its ``atomic.py`` as JAX
does). The on-disk format is the JAX
package's byte for byte, so a journal written by either package replays in
the other.

Every admitted request and every emitted token is appended to an on-disk
log. On restart the server replays it: each unfinished request is
re-submitted with its journaled emissions pre-seeded, so its re-prefill
re-derives the exact greedy continuation and the stream resumes
byte-identically from its last emitted token (the recompute-preemption
machinery, driven from disk).

Layout: numbered segments under the journal directory.

* the active segment (``seg_<n>.open``) takes appends; records are buffered
  in the process and written (and ``fsync``-ed) once per scheduler step by
  ``sync()``;
* past ``segment_bytes`` the active segment is sealed: fsynced, then
  renamed to ``seg_<n>.jrnl``. Sealed segments are immutable;
* a record is one line, ``<crc32:08x> <compact sorted json>``, so a torn
  tail is detectable: replay drops torn records only at the tail of an
  unsealed segment (where a crash leaves them) and raises
  ``JournalCorruptError`` anywhere else.

Records: ``s`` submit (uid, prompt, budget, eos, tenant, and for recovery
re-submits the tokens already emitted), ``e`` emit, ``t`` first-token
stamp, ``f`` finish, ``m`` migrated out (the request now lives in another
replica's journal; the fleet writes it after a migration lands). A later ``s`` for a uid replaces its
state, which is how recovery compacts: the restarted server journals one
seeded submit a request into a fresh segment, then retires the older ones.
"""

from __future__ import annotations

import json
import os
import re
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.runtime.checkpoint_engine.atomic import fsync_dir
from deepspeed_tpu_torch.utils import chaos
from deepspeed_tpu_torch.utils.logging import logger

_SEG_SEALED = re.compile(r"^seg_(\d{6})\.jrnl$")
_SEG_OPEN = re.compile(r"^seg_(\d{6})\.open$")


class JournalCorruptError(RuntimeError):
    """The journal is damaged beyond what a crash can explain: a sealed
    segment fails its CRC, or valid records follow a broken one."""


@dataclass
class JournaledRequest:
    """One request's replayed state."""

    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_token_id: Optional[int]
    tenant: str
    generated: List[int] = field(default_factory=list)
    finished: bool = False
    # server-clock stamps, meaningful within one clock domain only; a fresh
    # process ignores them (its clock restarted)
    t_submit: Optional[float] = None
    t_first: Optional[float] = None

    @property
    def done(self) -> bool:
        """Finished explicitly, or implicitly (the crash ate the finish
        record but the journaled emissions already reached the budget or
        EOS)."""
        if self.finished:
            return True
        if len(self.generated) >= self.max_new_tokens:
            return True
        return self.eos_token_id is not None and bool(self.generated) and self.generated[-1] == self.eos_token_id


def _encode(rec: dict) -> bytes:
    payload = json.dumps(rec, separators=(",", ":"), sort_keys=True)
    crc = zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF
    return f"{crc:08x} {payload}\n".encode("utf-8")


def _decode(line: bytes) -> Optional[dict]:
    """The record, or None when the line is torn or corrupt."""
    try:
        text = line.decode("utf-8")
        crc_hex, payload = text.split(" ", 1)
        payload = payload.rstrip("\n")
        if len(crc_hex) != 8:
            return None
        if int(crc_hex, 16) != (zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF):
            return None
        return json.loads(payload)
    except (ValueError, UnicodeDecodeError):
        return None


class RequestJournal:
    """The writer. One per live server; ``replay()`` (static) reads a
    directory without touching it."""

    def __init__(self, directory: str, segment_bytes: int = 1 << 20, fsync: bool = True):
        self.dir = os.path.abspath(directory)
        self.segment_bytes = int(segment_bytes)
        self.fsync = bool(fsync)
        os.makedirs(self.dir, exist_ok=True)
        self._seg_index = self._next_segment_index()
        # retirement boundary: segments below the index this writer started
        # at predate this server (a compaction may seal segments at or above
        # it, and those survive retirement)
        self._first_seg_index = self._seg_index
        self._fh = None
        self._buffer: List[bytes] = []
        self.segments_sealed = 0
        self.records_written = 0

    # --- writing ---------------------------------------------------------
    def append_submit(self, uid: int, prompt: np.ndarray, max_new_tokens: int, eos_token_id: Optional[int],
                      tenant: str, generated: Optional[List[int]] = None, t_submit: Optional[float] = None,
                      t_first: Optional[float] = None) -> None:
        rec = {
            "t": "s",
            "uid": int(uid),
            "prompt": np.asarray(prompt, np.int32).tolist(),
            "max": int(max_new_tokens),
            "eos": None if eos_token_id is None else int(eos_token_id),
            "tenant": str(tenant),
        }
        if generated:
            rec["gen"] = [int(t) for t in generated]
        if t_submit is not None:
            rec["ts"] = float(t_submit)
        if t_first is not None:
            rec["tf"] = float(t_first)
        self._buffer.append(_encode(rec))

    def append_emit(self, uid: int, token: int) -> None:
        self._buffer.append(_encode({"t": "e", "uid": int(uid), "tok": int(token)}))

    def append_first_token(self, uid: int, t_first: float) -> None:
        """The request's first emission, stamped once (one record a request)."""
        self._buffer.append(_encode({"t": "t", "uid": int(uid), "tf": float(t_first)}))

    def append_finish(self, uid: int) -> None:
        self._buffer.append(_encode({"t": "f", "uid": int(uid)}))

    def append_migrate(self, uid: int) -> None:
        """The request migrated to another replica, whose journal holds its
        state (seeded there before this record is written): replaying this
        journal must no longer produce it. A crash between the two journals
        double-claims the uid, and the fleet's adoption dedupes."""
        self._buffer.append(_encode({"t": "m", "uid": int(uid)}))

    def sync(self) -> None:
        """Write the buffered records to the active segment and make them
        durable (once per scheduler step); seal the segment past
        ``segment_bytes``."""
        if not self._buffer:
            return
        fh = self._ensure_open()
        data = b"".join(self._buffer)
        self.records_written += len(self._buffer)
        self._buffer.clear()
        fh.write(data)
        fh.flush()
        if self.fsync:
            os.fsync(fh.fileno())
        chaos.point("journal.append", path=fh.name)
        if fh.tell() >= self.segment_bytes:
            self._seal()

    def close(self) -> None:
        """Make the buffered records durable and seal the active segment."""
        self.sync()
        if self._fh is not None:
            self._seal()

    def begin_compaction(self) -> None:
        """Seal the active segment and move the retirement boundary past
        every segment written so far. The caller then journals the server's
        full state and ``sync()``s (the fresh segment alone replays to the
        same state), after which ``retire_older_segments()`` drops the rest."""
        self.sync()
        if self._fh is not None:
            self._seal()
        self._first_seg_index = self._seg_index

    def retire_older_segments(self) -> int:
        """Delete every segment from before this writer's boundary. Call
        only after a full compaction went through ``sync()`` (recovery
        journals every live request and every finished result), so the
        older segments are superseded. Returns the number removed."""
        removed = 0
        for path in self.segments(self.dir):
            name = os.path.basename(path)
            m = _SEG_SEALED.match(name) or _SEG_OPEN.match(name)
            if m and int(m.group(1)) < self._first_seg_index:
                os.remove(path)
                removed += 1
        if removed:
            fsync_dir(self.dir)
        return removed

    # --- internals -------------------------------------------------------
    def _open_path(self) -> str:
        return os.path.join(self.dir, f"seg_{self._seg_index:06d}.open")

    def _ensure_open(self):
        if self._fh is None:
            self._fh = open(self._open_path(), "ab")
        return self._fh

    def _seal(self) -> None:
        """Promote the active segment to a sealed one. Its data is fsynced
        here whatever ``fsync`` says (one fsync a segment): replay holds a
        sealed segment to full validity, so its bytes must be on disk
        before the rename claims it."""
        fh, self._fh = self._fh, None
        path = fh.name
        try:
            os.fsync(fh.fileno())
        except OSError:
            pass
        fh.close()
        sealed = os.path.join(self.dir, f"seg_{self._seg_index:06d}.jrnl")
        os.replace(path, sealed)
        fsync_dir(self.dir)
        self._seg_index += 1
        self.segments_sealed += 1

    def _next_segment_index(self) -> int:
        idx = -1
        for name in os.listdir(self.dir):
            m = _SEG_SEALED.match(name) or _SEG_OPEN.match(name)
            if m:
                idx = max(idx, int(m.group(1)))
        return idx + 1

    # --- replay ----------------------------------------------------------
    @staticmethod
    def segments(directory: str) -> List[str]:
        """All segment paths in append order. An index both sealed and open
        cannot come from a crash (``os.replace`` is atomic) and raises."""
        directory = os.path.abspath(directory)
        if not os.path.isdir(directory):
            return []
        by_index: Dict[int, str] = {}
        for name in sorted(os.listdir(directory)):
            m = _SEG_SEALED.match(name) or _SEG_OPEN.match(name)
            if not m:
                continue
            idx = int(m.group(1))
            if idx in by_index:
                raise JournalCorruptError(
                    f"journal {directory}: segment {idx} exists both sealed and open ({by_index[idx]} vs {name})"
                )
            by_index[idx] = os.path.join(directory, name)
        return [by_index[i] for i in sorted(by_index)]

    @staticmethod
    def replay(directory: str) -> Tuple[Dict[int, JournaledRequest], int]:
        """Rebuild request state from the journal: ``(states, next_uid)``.

        Tolerates exactly the damage a crash can cause, torn tails of
        unsealed segments (dropped with a log line; repeated crashes leave
        one each). Anything else raises ``JournalCorruptError``."""
        states: Dict[int, JournaledRequest] = {}
        next_uid = 0
        for path in RequestJournal.segments(directory):
            sealed = path.endswith(".jrnl")
            with open(path, "rb") as f:
                lines = f.readlines()
            bad_at = None
            records = []
            for li, line in enumerate(lines):
                rec = _decode(line)
                if rec is None:
                    bad_at = li
                    break
                records.append(rec)
            if bad_at is not None:
                torn_tail = not sealed and all(_decode(l) is None for l in lines[bad_at:])
                if not torn_tail:
                    raise JournalCorruptError(
                        f"journal segment {path}: record {bad_at} fails its CRC"
                        + (" inside a sealed segment" if sealed else " with valid records after it")
                        + " — this is corruption, not a torn crash tail"
                    )
                logger.warning(f"journal {path}: dropping {len(lines) - bad_at} torn tail record(s) (crash mid-append)")
            for rec in records:
                uid = int(rec["uid"])
                next_uid = max(next_uid, uid + 1)
                kind = rec["t"]
                if kind == "s":
                    states[uid] = JournaledRequest(
                        uid=uid,
                        prompt=np.asarray(rec["prompt"], np.int32),
                        max_new_tokens=int(rec["max"]),
                        eos_token_id=rec.get("eos"),
                        tenant=rec.get("tenant", "default"),
                        generated=[int(t) for t in rec.get("gen", [])],
                        t_submit=rec.get("ts"),
                        t_first=rec.get("tf"),
                    )
                elif kind == "e":
                    if uid in states:
                        states[uid].generated.append(int(rec["tok"]))
                elif kind == "t":
                    if uid in states:
                        states[uid].t_first = rec.get("tf")
                elif kind == "f":
                    if uid in states:
                        states[uid].finished = True
                elif kind == "m":
                    # migrated out: another replica's journal owns the request
                    states.pop(uid, None)
        return states, next_uid

    @staticmethod
    def has_records(directory: str) -> bool:
        try:
            return bool(RequestJournal.segments(directory))
        except JournalCorruptError:
            return True
