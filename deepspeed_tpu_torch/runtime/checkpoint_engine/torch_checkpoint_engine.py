"""The torch checkpoint engine.

Counterpart of ``deepspeed_tpu/runtime/checkpoint_engine/
orbax_checkpoint_engine.py`` and the name of the reference's
``TorchCheckpointEngine``. A state tree is split as JAX splits it:

* ``meta.pkl`` holds ``{"skeleton", "meta"}``, a plain pickle. The
  skeleton mirrors the tree; each tensor is an ``{"__array_ref__": path}``
  node, each other leaf (counters, the lr schedule, the config) an
  ``{"__meta_ref__": path}`` node whose value sits in ``meta``, each list
  or tuple a ``{"__seq__", "items"}`` node, at the same ``root/...`` paths
  JAX writes;
* ``arrays.pt`` replaces orbax's ``arrays/`` directory: one ``torch.save``
  of the CPU tensors keyed by those paths, read back with
  ``weights_only=True`` (so the payload holds tensors only).

Atomicity (``atomic.py``): ``save`` stages the whole checkpoint under the
``<path>.staging`` sibling (the tensors, then ``meta.pkl``, then the
``_COMPLETE`` sentinel) and ``commit`` renames it into place in one
directory rename. A kill at any instant leaves the previous committed
checkpoint or the new one, never a mix; staging garbage is reclaimed by the
next save of the tag. ``load`` raises ``CheckpointCorruptError`` naming the
cause on any torn layout (no ``meta.pkl``, an undecodable pickle, a
skeleton that refers to a payload that is missing, unreadable or short of
a tensor), and names the JAX package when the directory holds orbax's
``arrays/`` instead of ``arrays.pt``.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Dict, Tuple

import torch

from deepspeed_tpu_torch.runtime.checkpoint_engine.atomic import (
    COMPLETE_MARKER,
    CheckpointCorruptError,
    atomic_write_bytes,
    clear_stale_staging,
    commit_staged,
    fsync_dir,
    staging_dir,
)
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import CheckpointEngine
from deepspeed_tpu_torch.utils import chaos
from deepspeed_tpu_torch.utils.logging import logger

ARRAYS_FILE = "arrays.pt"
META_FILE = "meta.pkl"


def split_state(state: Any) -> Tuple[Any, Dict[str, torch.Tensor], Dict[str, Any]]:
    """``(skeleton, tensors, meta)`` of a state tree, JAX's ``split``
    (``orbax_checkpoint_engine.py:73-88``) with torch tensors as the array
    leaves."""
    tensors: Dict[str, torch.Tensor] = {}
    meta: Dict[str, Any] = {}

    def split(prefix: str, obj):
        if isinstance(obj, torch.Tensor):
            tensors[prefix] = obj
            return {"__array_ref__": prefix}
        if isinstance(obj, dict) or hasattr(obj, "items"):
            return {k: split(f"{prefix}/{k}", v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            items = [split(f"{prefix}/{i}", v) for i, v in enumerate(obj)]
            return {"__seq__": "tuple" if isinstance(obj, tuple) else "list", "items": items}
        meta[prefix] = obj
        return {"__meta_ref__": prefix}

    return split("root", state), tensors, meta


def join_state(skeleton: Any, tensors: Dict[str, torch.Tensor], meta: Dict[str, Any]) -> Any:
    """The inverse of ``split_state``."""
    def join(obj):
        if isinstance(obj, dict) and "__array_ref__" in obj:
            return tensors[obj["__array_ref__"]]
        if isinstance(obj, dict) and "__meta_ref__" in obj:
            return meta[obj["__meta_ref__"]]
        if isinstance(obj, dict) and "__seq__" in obj:
            seq = [join(v) for v in obj["items"]]
            return tuple(seq) if obj["__seq__"] == "tuple" else seq
        if isinstance(obj, dict):
            return {k: join(v) for k, v in obj.items()}
        return obj

    return join(skeleton)


def array_refs(skeleton: Any) -> list:
    """Every ``__array_ref__`` path in a skeleton."""
    out = []

    def walk(obj):
        if isinstance(obj, dict):
            if "__array_ref__" in obj:
                out.append(obj["__array_ref__"])
                return
            for v in (obj["items"] if "__seq__" in obj else obj.values()):
                walk(v)

    walk(skeleton)
    return out


def _host(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor that owns exactly its elements (``torch.save`` writes a
    view's whole storage)."""
    t = t.detach()
    if t.device.type != "cpu":
        return t.cpu()
    if t.untyped_storage().nbytes() != t.numel() * t.element_size() or not t.is_contiguous():
        return t.clone(memory_format=torch.contiguous_format)
    return t


class TorchCheckpointEngine(CheckpointEngine):
    """Saves a state tree: tensors through ``torch.save``, the rest through
    pickle, staged and committed atomically."""

    def __init__(self, config_params=None):
        super().__init__(config_params)
        # basename -> (staging_dir, final_path), staged by save(), renamed by
        # commit(). Locked: the async writer thread and a synchronous save on
        # the main thread may share one engine.
        self._staged: Dict[str, Tuple[str, str]] = {}
        self._staged_lock = threading.Lock()

    def create(self, tag: str) -> None:
        logger.info(f"[TorchCheckpointEngine] Saving checkpoint under tag {tag}")

    def save(self, state_dict: Any, path: str) -> None:
        path = os.path.abspath(path)
        skeleton, tensors, meta = split_state(state_dict)
        clear_stale_staging(path)
        staging = staging_dir(path)
        os.makedirs(staging, exist_ok=True)
        if tensors:
            arrays = os.path.join(staging, ARRAYS_FILE)
            with open(arrays, "wb") as f:
                torch.save({k: _host(t) for k, t in tensors.items()}, f)
                f.flush()
                os.fsync(f.fileno())
            fsync_dir(staging)
        chaos.point("ckpt.mid_array_write", path=staging)
        atomic_write_bytes(os.path.join(staging, META_FILE), pickle.dumps({"skeleton": skeleton, "meta": meta}))
        # the sentinel is LAST: a staging dir without it is a torn snapshot
        atomic_write_bytes(os.path.join(staging, COMPLETE_MARKER), b"ok")
        with self._staged_lock:
            self._staged[os.path.basename(path)] = (staging, path)

    def load(self, path: str, map_location=None, target=None):  # noqa: ARG002
        path = os.path.abspath(path)
        if not os.path.isdir(path):
            raise CheckpointCorruptError(f"no checkpoint directory at {path}")
        meta_path = os.path.join(path, META_FILE)
        if not os.path.isfile(meta_path):
            raise CheckpointCorruptError(
                f"torn checkpoint at {path}: meta.pkl is missing (the save was killed before commit, "
                "or the directory was truncated)")
        try:
            with open(meta_path, "rb") as f:
                blob = pickle.load(f)
            skeleton, meta = blob["skeleton"], blob["meta"]
        except Exception as e:
            raise CheckpointCorruptError(
                f"torn checkpoint at {path}: meta.pkl is unreadable ({type(e).__name__}: {e})") from e
        refs = array_refs(skeleton)
        tensors: Dict[str, torch.Tensor] = {}
        if refs:
            arrays_path = os.path.join(path, ARRAYS_FILE)
            if not os.path.exists(arrays_path):
                if os.path.isdir(os.path.join(path, "arrays")):
                    raise CheckpointCorruptError(
                        f"{path} holds an orbax arrays/ directory: it was written by the JAX package "
                        "(deepspeed_tpu), whose engine checkpoints this package cannot read; export it "
                        "with save_reference_checkpoint or convert_to_universal instead")
                raise CheckpointCorruptError(
                    f"torn checkpoint at {path}: meta.pkl references a tensor payload but {ARRAYS_FILE} "
                    "is missing")
            try:
                tensors = torch.load(arrays_path, map_location=map_location or "cpu", weights_only=True)
            except Exception as e:
                raise CheckpointCorruptError(
                    f"torn checkpoint at {path}: tensor payload unreadable ({type(e).__name__}: {e})") from e
            missing = [r for r in refs if r not in tensors]
            if missing:
                raise CheckpointCorruptError(
                    f"torn checkpoint at {path}: {ARRAYS_FILE} lacks {len(missing)} tensor(s) meta.pkl "
                    f"refers to, e.g. {missing[:3]}")
        return join_state(skeleton, tensors, meta)

    def commit(self, tag: str) -> bool:
        """Rename the checkpoint staged under ``tag`` into place: the atomic
        commit point. With no entry of its own under ``tag`` every pending
        entry is committed instead of leaked. Entries are popped under the
        lock, so each staged checkpoint is committed exactly once."""
        with self._staged_lock:
            if tag in self._staged:
                pending = {tag: self._staged.pop(tag)}
            else:
                pending, self._staged = self._staged, {}
        for staging, final in pending.values():
            commit_staged(staging, final)
        logger.info(f"[TorchCheckpointEngine] Checkpoint {tag} is ready")
        return True

    def discard_staged(self, tag: str) -> None:
        """Forget a staged entry without touching disk."""
        with self._staged_lock:
            self._staged.pop(tag, None)
