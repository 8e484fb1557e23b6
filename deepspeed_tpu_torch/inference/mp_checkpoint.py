"""Pre-sharded (model-parallel) inference checkpoints.

Counterpart of ``deepspeed_tpu/inference/mp_checkpoint.py`` (the
reference's ``save_mp_checkpoint_path`` flow, ``deepspeed/inference/
engine.py:406``), in the same on-disk layout, so each package reads the
other's checkpoints:

* ``{tag}_non-tp.npz``: every replicated leaf;
* ``{tag}_tp_{rank:02d}.npz``: rank's slice of every sharded leaf, split
  into ``tp_size`` equal pieces along the dim its rule names (a leaf whose
  dim does not divide stays whole in the non-tp file);
* ``ds_inference_config.json``: ``tp_size``, the file list, ``shard_dims``
  (path -> concat dim) and ``dtypes`` (path -> the leaf's dtype name).

Leaves are keyed by ``a|b|c`` paths (``/`` escaped) in ``jax.tree_util``
order (``utils/tensor_fragment._flatten_with_paths``). Floating leaves are
written as float32 (an exact widening of bf16 and fp16) with their dtype
recorded. JAX's rules are ``PartitionSpec``s naming the ``model`` axis;
the port's are the dim itself (``TransformerLM.tp_partition_rules``,
``module_inject/auto_tp.py``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.checkpoint_engine.atomic import atomic_write_text
from deepspeed_tpu_torch.utils.tensor_fragment import _flatten_with_paths

MANIFEST_NAME = "ds_inference_config.json"

# numpy carries these dtypes itself; bfloat16 leaves load as their exact float32 widening
_NUMPY_DTYPES = {"float16", "float32", "float64", "int8", "int16", "int32", "int64", "uint8", "bool"}


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host array; floating leaves (but float64) widened to
    float32, as JAX's writer does."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return (leaf.float() if leaf.is_floating_point() and leaf.dtype != torch.float64 else leaf).cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "iub" and arr.dtype != np.float64:
        return arr.astype(np.float32)
    return arr


def _check_dict_tree(t, where="params"):
    if isinstance(t, dict):
        for v in t.values():
            _check_dict_tree(v, where)
    elif isinstance(t, (list, tuple)):
        # _unflatten rebuilds every level as a dict: sequences would not round-trip
        raise ValueError(
            f"save_mp_checkpoint requires a nested-dict {where} tree; "
            "lists/tuples of weights do not round-trip through the "
            "path-keyed npz layout"
        )


def save_mp_checkpoint(
    params: Dict[str, Any],
    specs: Optional[Dict[str, Any]],
    save_path: str,
    tag: str = "ds-inference",
    tp_size: int = 1,
    version: str = "0.1.0",
) -> str:
    """Write the sharded layout and its manifest; returns the manifest path.

    ``params`` is a nested dict of tensors or arrays; ``specs`` a tree of the
    same structure whose leaves are the dim to split (None: replicated), or
    None for all replicated."""
    os.makedirs(save_path, exist_ok=True)
    _check_dict_tree(params)
    flat_orig = _flatten_with_paths(params)
    dtypes = {p: _dtype_name(v) for p, v in flat_orig.items()}
    flat_p = {p: _to_host(v) for p, v in flat_orig.items()}
    flat_s = _flatten_with_paths(specs) if specs is not None else {}

    non_tp: Dict[str, np.ndarray] = {}
    tp_files = [dict() for _ in range(tp_size)]
    shard_dims: Dict[str, int] = {}
    for path, leaf in flat_p.items():
        dim = flat_s.get(path)
        if dim is None or tp_size <= 1 or leaf.shape[dim] % tp_size != 0:
            non_tp[path] = leaf
            continue
        shard_dims[path] = int(dim)
        for rank, piece in enumerate(np.split(leaf, tp_size, axis=dim)):
            tp_files[rank][path] = piece

    def k(path):
        return path.replace("/", "|")  # '/' is not legal in every loader's npz member names

    non_tp_name = f"{tag}_non-tp.npz"
    np.savez(os.path.join(save_path, non_tp_name), **{k(p): v for p, v in non_tp.items()})
    tp_names = []
    for rank in range(tp_size):
        name = f"{tag}_tp_{rank:02d}.npz"
        np.savez(os.path.join(save_path, name), **{k(p): v for p, v in tp_files[rank].items()})
        tp_names.append(name)

    manifest = {
        "type": "ds_model",
        "version": version,
        "parallelization": "tp",
        "tp_size": tp_size,
        "base_dir": ".",
        "non_tp": non_tp_name,
        "tp": tp_names,
        "shard_dims": shard_dims,
        "dtypes": dtypes,
    }
    mpath = os.path.join(save_path, MANIFEST_NAME)
    atomic_write_text(mpath, json.dumps(manifest, indent=2))
    return mpath


def is_mp_checkpoint(path: str) -> bool:
    """True only for this layout's manifest (a readable json with the
    ``ds_model`` / ``non_tp`` markers), given as the file or its directory."""
    if os.path.isfile(path) and path.endswith(".json"):
        mpath = path
    elif os.path.isdir(path) and os.path.isfile(os.path.join(path, MANIFEST_NAME)):
        mpath = os.path.join(path, MANIFEST_NAME)
    else:
        return False
    try:
        with open(mpath) as f:
            m = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    return isinstance(m, dict) and m.get("type") == "ds_model" and "non_tp" in m


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return tree


def load_mp_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The whole tree reassembled from the sharded layout, as numpy, and
    the manifest. ``path`` is the manifest file or its directory. Leaves
    come back in their recorded dtype where numpy has it; a bfloat16 leaf
    stays its float32 widening (the same values; the engine casts it)."""
    mpath = path if os.path.isfile(path) else os.path.join(path, MANIFEST_NAME)
    with open(mpath) as f:
        manifest = json.load(f)
    base = os.path.join(os.path.dirname(mpath), manifest.get("base_dir", "."))

    def load_npz(name):
        with np.load(os.path.join(base, name)) as z:
            return {key.replace("|", "/"): z[key] for key in z.files}

    flat = load_npz(manifest["non_tp"])
    tp_flats = [load_npz(name) for name in manifest["tp"]]
    for path_key, dim in manifest["shard_dims"].items():
        flat[path_key] = np.concatenate([tf[path_key] for tf in tp_flats], axis=dim)
    for path_key, name in manifest.get("dtypes", {}).items():
        if path_key in flat and name in _NUMPY_DTYPES and str(flat[path_key].dtype) != name:
            flat[path_key] = flat[path_key].astype(np.dtype(name))
    return _unflatten(flat), manifest
