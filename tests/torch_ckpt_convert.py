"""Move an engine checkpoint tag between the two packages' containers.

The JAX engine writes its state tree through orbax (``arrays/``), the port
through one ``arrays.pt``; the trees inside (``meta.pkl``'s skeleton, the
offload records) are the same. ``jax_tag_to_port`` reads a JAX tag with
JAX's own checkpoint engine and writes the same tree with the port's;
``port_tag_to_jax`` the reverse. Arrays change container only (bf16 as its
raw 2-byte values); ``mesh`` becomes the loading engine's (``mesh``), and
the port's dropout-generator state, which JAX cannot read, is dropped.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _to_torch(x):
    if isinstance(x, (np.ndarray, np.generic)) or type(x).__module__.startswith("jax"):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return x


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            import ml_dtypes

            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return x


def _latest(dst_dir: str, tag: str) -> str:
    with open(os.path.join(dst_dir, "latest"), "w") as f:
        f.write(tag)
    return os.path.join(dst_dir, tag)


def jax_tag_to_port(src_dir: str, tag: str, dst_dir: str, mesh=None) -> str:
    from deepspeed_tpu.runtime.checkpoint_engine.orbax_checkpoint_engine import OrbaxCheckpointEngine
    from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_checkpoint_engine import TorchCheckpointEngine

    state = _map(_to_torch, OrbaxCheckpointEngine().load(os.path.join(src_dir, tag)))
    if mesh is not None:
        state["mesh"] = dict(mesh)
    state["rng"] = None
    eng = TorchCheckpointEngine()
    eng.save(state, os.path.join(dst_dir, tag))
    eng.commit(tag)
    return _latest(dst_dir, tag)


def port_tag_to_jax(src_dir: str, tag: str, dst_dir: str, mesh=None) -> str:
    from deepspeed_tpu.runtime.checkpoint_engine.orbax_checkpoint_engine import OrbaxCheckpointEngine
    from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_checkpoint_engine import TorchCheckpointEngine

    state = _map(_to_numpy, TorchCheckpointEngine().load(os.path.join(src_dir, tag)))
    if mesh is not None:
        state["mesh"] = dict(mesh)
    state["rng"] = None
    eng = OrbaxCheckpointEngine()
    eng.save(state, os.path.join(dst_dir, tag))
    eng.commit(tag)
    return _latest(dst_dir, tag)
