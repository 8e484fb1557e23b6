"""Atomic persistence primitives for checkpoints and markers.

Counterpart of ``deepspeed_tpu/runtime/checkpoint_engine/atomic.py`` (the
port keeps its own copy; the names on disk are the same, so each package's
discovery functions read the other's save directories).

The failure model is ``kill -9`` at ANY instant (a preempted host). The only
durable commit primitive POSIX gives us is ``rename`` within a filesystem,
so every checkpoint artifact follows the same discipline:

* **files** — write to a ``.tmp-<pid>`` sibling, flush + ``fsync``, rename
  over the final name, ``fsync`` the parent directory (the rename itself is
  not durable until the directory entry is);
* **checkpoint directories** — the engine stages the WHOLE checkpoint under
  ``<final>.staging-<pid>``, writes a ``_COMPLETE`` sentinel last, and
  ``commit`` renames the directory into place. A crash before the rename
  leaves only staging garbage (ignored, reclaimed on the next save of the
  same tag); a crash after it leaves a fully valid checkpoint;
* **the ``latest`` marker** — updated atomically AND only after commit, so
  it can never name a torn checkpoint. A crash between commit and the
  marker update leaves ``latest`` on the previous checkpoint, which is why
  ``find_latest_valid`` (the ``auto_resume`` discovery path) scans and
  validates rather than trusting the marker blindly.

Chaos injection points (``utils/chaos.py``): ``ckpt.pre_commit`` right
before the commit rename, ``ckpt.post_commit`` right after it.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import List, Optional, Tuple

from deepspeed_tpu_torch.utils import chaos

COMPLETE_MARKER = "_COMPLETE"
LATEST_NAME = "latest"

_STEP_TAG = re.compile(r"(\d+)\s*$")
_TRASH_NAME = re.compile(r"^(.+)\.trash-\d+$")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory is torn or unreadable (missing metadata,
    missing array payload, undecodable pickle). Raised instead of letting a
    ``FileNotFoundError``/``UnpicklingError`` surface from deep inside the
    storage layer; ``auto_resume`` treats it as 'skip this tag'."""


class CheckpointLoadError(RuntimeError):
    """A readable checkpoint does not fit the current run: a module leaf's
    shape/dtype disagrees with the live state, the trees differ, or the
    mesh topology changed. Raised with the offending leaf and both shapes
    named — instead of the cryptic tree-unflatten/reshape failure the raw
    adoption would hit later."""


def fsync_dir(path: str) -> None:
    """Durably record directory-entry changes (renames/creates) under
    ``path``. Best-effort on filesystems without dir fsync."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(
    path: str, data: bytes, do_fsync: bool = True, reclaim_stale: bool = False
) -> None:
    """Write-to-temp -> fsync -> rename: ``path`` either holds its previous
    content or all of ``data``, never a prefix. The temp name is
    pid+thread-unique — the async checkpoint writer and the main thread
    share a pid and may both touch e.g. the ``latest`` marker.

    ``reclaim_stale`` sweeps temps a killed writer left for THIS target —
    enable it ONLY at single-writer call sites (the rank-0-gated ``latest``
    marker): on a shared filesystem a collective save has every rank
    writing the same staged file, and a sweep there would delete a peer's
    live temp mid-write (staged-dir temp leaks are reclaimed wholesale by
    ``clear_stale_staging`` instead)."""
    path = os.path.abspath(path)
    if reclaim_stale:
        parent, base = os.path.split(path)
        try:
            for name in os.listdir(parent or "."):
                if name.startswith(base + ".tmp-"):
                    try:
                        os.remove(os.path.join(parent, name))
                    except OSError:
                        pass
        except OSError:
            pass
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if do_fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if do_fsync:
        fsync_dir(os.path.dirname(path))


def atomic_write_text(
    path: str, text: str, do_fsync: bool = True, reclaim_stale: bool = False
) -> None:
    atomic_write_bytes(
        path, text.encode("utf-8"), do_fsync=do_fsync, reclaim_stale=reclaim_stale
    )


def staging_dir(final_path: str) -> str:
    """The staging sibling for a checkpoint directory. DETERMINISTIC (no
    pid): a multi-process save is a collective — every rank must hand the
    storage layer the SAME path or each writes its shards into a private
    dir. Stale staging from a killed save is reclaimed by
    ``clear_stale_staging`` before the next save of the tag; concurrent
    same-tag saves within one process are serialized by the engine (sync
    saves fence the async writer; the writer itself is single-threaded)."""
    final_path = os.path.abspath(final_path)
    return f"{final_path}.staging"


def restore_orphaned_trash(save_dir: str) -> int:
    """Undo a kill inside ``commit_staged``'s re-save window: between the
    move-aside of the existing checkpoint and the staging rename, the
    previous checkpoint exists only as ``<tag>.trash-<pid>``. If the tag
    itself is missing, the trash IS the newest valid state — rename it
    back. Returns how many tags were restored."""
    if not os.path.isdir(save_dir):
        return 0
    restored = 0
    for name in os.listdir(save_dir):
        m = _TRASH_NAME.match(name)
        if not m:
            continue
        final = os.path.join(save_dir, m.group(1))
        trash = os.path.join(save_dir, name)
        if os.path.exists(final):
            continue
        if os.path.isfile(os.path.join(trash, "meta.pkl")):
            os.rename(trash, final)
            fsync_dir(save_dir)
            restored += 1
    return restored


def clear_stale_staging(final_path: str) -> None:
    """Reclaim staging/trash garbage left by killed saves of this
    checkpoint — after first restoring a trash dir whose final is missing
    (the commit-window kill: deleting it would destroy the only copy)."""
    final_path = os.path.abspath(final_path)
    parent, base = os.path.split(final_path)
    if not os.path.isdir(parent):
        return
    restore_orphaned_trash(parent)
    for name in os.listdir(parent):
        if name.startswith(base + ".staging") or name.startswith(base + ".trash-"):
            shutil.rmtree(os.path.join(parent, name), ignore_errors=True)


def commit_staged(staging: str, final_path: str, do_fsync: bool = True) -> None:
    """The commit: one atomic directory rename. An existing checkpoint under
    ``final_path`` (a re-save of the same tag) is moved aside first and
    deleted after — the window where neither exists is covered by the OTHER
    valid checkpoints ``find_latest_valid`` scans."""
    final_path = os.path.abspath(final_path)
    if not os.path.isdir(staging):
        raise CheckpointCorruptError(f"no staged checkpoint at {staging}")
    chaos.point("ckpt.pre_commit", path=staging)
    trash = None
    if os.path.exists(final_path):
        trash = f"{final_path}.trash-{os.getpid()}"
        os.rename(final_path, trash)
        # the one instant a re-saved tag has NO directory under its name:
        # between the two renames. A kill here leaves the previous
        # checkpoint as <tag>.trash-<pid>, which restore_orphaned_trash
        # (run by the next save AND by list_valid_tags/auto_resume)
        # renames back — the window is recoverable, and this injection
        # point proves it in the crash matrix.
        chaos.point("ckpt.mid_commit", path=trash)
    os.rename(staging, final_path)
    if do_fsync:
        fsync_dir(os.path.dirname(final_path))
    if trash is not None:
        shutil.rmtree(trash, ignore_errors=True)
    chaos.point("ckpt.post_commit", path=final_path)


def is_complete_checkpoint(path: str) -> bool:
    """A committed, non-torn checkpoint directory: the metadata exists and —
    for checkpoints written by the staged engine — the ``_COMPLETE``
    sentinel does too. Directories still carrying a staging/trash suffix
    are never checkpoints."""
    base = os.path.basename(os.path.abspath(path))
    if ".staging" in base or ".trash-" in base or base.endswith(".tmp"):
        return False
    if not os.path.isdir(path):
        return False
    if not os.path.isfile(os.path.join(path, "meta.pkl")):
        return False
    marker = os.path.join(path, COMPLETE_MARKER)
    # pre-atomic-era checkpoints have no sentinel; meta.pkl alone suffices
    # for them, but a sentinel file that exists must not be empty garbage
    return True if not os.path.exists(marker) else os.path.isfile(marker)


def tag_sort_key(save_dir: str, tag: str) -> Tuple[int, float]:
    """Newest-checkpoint ordering: the trailing integer of the tag
    (``global_step120`` -> 120) wins; tags without one fall back to the
    directory mtime."""
    m = _STEP_TAG.search(tag)
    step = int(m.group(1)) if m else -1
    try:
        mtime = os.path.getmtime(os.path.join(save_dir, tag))
    except OSError:
        mtime = 0.0
    return (step, mtime)


def list_valid_tags(save_dir: str) -> List[str]:
    """Every committed checkpoint tag under ``save_dir``, oldest first.
    Repairs the commit-window kill first (an orphaned ``.trash-`` dir is
    the newest valid state for its tag)."""
    if not os.path.isdir(save_dir):
        return []
    restore_orphaned_trash(save_dir)
    tags = [
        name
        for name in os.listdir(save_dir)
        if is_complete_checkpoint(os.path.join(save_dir, name))
    ]
    tags.sort(key=lambda t: tag_sort_key(save_dir, t))
    return tags


def find_latest_valid(save_dir: str) -> Optional[str]:
    """The newest VALID checkpoint tag — the ``auto_resume`` discovery path.

    The ``latest`` marker is only a hint: a kill between commit and the
    marker update leaves a newer valid checkpoint the marker does not name,
    and a corrupted tree could leave a marker naming a torn one. Scanning +
    validating covers both: no kill instant can make this return a torn
    checkpoint, and the newest committed one always wins."""
    tags = list_valid_tags(save_dir)
    return tags[-1] if tags else None


def write_latest_marker(save_dir: str, tag: str, do_fsync: bool = True) -> None:
    """Atomically point ``latest`` at ``tag``. Call only after commit, and
    only from one writer at a time (the engine rank-0-gates it) — which is
    what makes reclaiming a killed writer's stale temps safe here."""
    os.makedirs(save_dir, exist_ok=True)
    atomic_write_text(
        os.path.join(save_dir, LATEST_NAME), tag, do_fsync=do_fsync,
        reclaim_stale=True,
    )


def read_latest_marker(save_dir: str) -> Optional[str]:
    path = os.path.join(save_dir, LATEST_NAME)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return f.read().strip() or None
