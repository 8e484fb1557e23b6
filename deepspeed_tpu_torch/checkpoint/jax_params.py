"""Move the JAX package's parameter tree into the port and back.

The only place where a layout could change. The JAX tree arrives as numpy
arrays, either nested (``{"embed": {"tokens": ...}, "layers": {...}, ...}``)
or flat under the path convention of
``deepspeed_tpu/checkpoint/reference_export.py:19-22`` (``embed/tokens``,
``layers/wq``, ..., ``final_norm_scale``, ``lm_head``). The port keeps the
JAX layout (stacked ``[L, ...]`` layers, ``[in, out]`` weights), so every
leaf is copied as it is.

``jax_tree_to_tensors`` checks a tree (numpy leaves, or tensors such as a
training checkpoint's module) against the config and gives a flat
``path -> tensor`` dict on a device in a dtype (the training engine's
master and compute leaves); ``tensors_to_jax_tree`` is its inverse, the
nested numpy tree ``get_params`` / ``get_master_params`` return.
``load_jax_params`` installs a tree into a ``TransformerLM`` for serving
(under an expert axis, each rank's slice of the expert leaves).

Each leaf is stored in the engine dtype once. JAX keeps fp32 weights and
casts them at every matmul (``compression/int8.py:97``); one cast up front
gives the same bits at half the memory traffic in bf16.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models.transformer import TransformerLM, param_shapes


def flatten_tree(params: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested JAX tree (or an already flat ``path -> array`` dict) to flat
    ``path -> array``."""
    flat: Dict[str, Any] = {}
    for key, value in params.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, prefix=path + "/"))
        else:
            flat[path] = value
    return flat


def unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat ``path -> leaf`` to the nested JAX tree."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        *heads, name = path.split("/")
        for head in heads:
            node = node.setdefault(head, {})
        node[name] = leaf
    return tree


def _checked_flat(cfg, params: Mapping[str, Any]) -> Dict[str, Any]:
    """The tree as flat paths, after checking that its paths are exactly
    the config's and every shape matches."""
    flat = flatten_tree(params)
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"JAX tree does not match the config: missing {missing}, unexpected {extra}")
    for path, shape in want.items():
        got = tuple(np.shape(flat[path]))
        if got != tuple(shape):
            raise ValueError(f"{path}: JAX leaf has shape {got}, the config wants {tuple(shape)}")
    return {path: flat[path] for path in want}


@torch.no_grad()
def jax_tree_to_tensors(cfg, params: Mapping[str, Any], device=None,
                        dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The JAX tree (nested or flat, numpy) as a flat ``path -> tensor``
    dict on ``device`` (``cuda`` by default; raises without a card) in
    ``dtype``, in ``param_shapes`` order. Paths and shapes must match the
    config exactly; anything else raises before any leaf is moved."""
    device = resolve_device(device)
    out = {}
    for path, leaf in _checked_flat(cfg, params).items():
        if isinstance(leaf, torch.Tensor):  # e.g. a checkpoint's bf16 module, which numpy cannot hold
            out[path] = leaf.detach().to(device=device, dtype=dtype, copy=True)
            continue
        arr = np.array(leaf, dtype=np.float32, order="C")  # a copy: training must not write the caller's tree
        out[path] = torch.from_numpy(arr).to(device=device, dtype=dtype)
    return out


@torch.no_grad()
def tensors_to_jax_tree(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``jax_tree_to_tensors``: the nested JAX tree as numpy.
    fp32 and fp16 leaves keep their dtype; bf16 leaves come back widened to
    fp32, exactly (numpy has no bf16)."""
    def host(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    return unflatten_tree({path: host(t) for path, t in flat.items()})


def is_expert_leaf(path: str) -> bool:
    """A stacked expert leaf ``[L, E, ...]`` of an MoE tree (``layers/moe/
    experts/...`` or ``moe_layers/experts/...``): JAX places its dim 1 on
    the ``expert`` axis (``P(None, 'expert', ...)``,
    ``moe_transformer.py:139-147``)."""
    return "/experts/" in path and path.split("/", 1)[0] in ("layers", "moe_layers")


def expert_slice(path: str, leaf, expert_shard: Optional[Tuple[int, int]]):
    """Shard ``r`` of ``e`` (``expert_shard = (r, e)``) of an expert leaf:
    experts ``[r·E/e, (r+1)·E/e)``, the slice JAX's sharding puts on expert
    coordinate ``r``; any other leaf, or no ``expert_shard``, as it is."""
    if expert_shard is None or not is_expert_leaf(path):
        return leaf
    r, e = expert_shard
    n = leaf.shape[1] // e
    return leaf[:, r * n:(r + 1) * n]


@torch.no_grad()
def load_jax_params(model: TransformerLM, params: Mapping[str, Any], device=None,
                    dtype: torch.dtype = torch.float32,
                    expert_shard: Optional[Tuple[int, int]] = None) -> TransformerLM:
    """Install the JAX tree ``params`` into ``model`` on ``device``
    (``cuda`` by default; raises without a card) in ``dtype``. The set of
    paths and every shape must match the model's config exactly; anything
    else raises before any leaf is replaced. With ``expert_shard = (r,
    e)`` the whole tree comes in and each expert leaf keeps its shard
    ``r`` of ``e`` (``expert_slice``), cut before it reaches the device."""
    device = resolve_device(device)
    for path, leaf in _checked_flat(model.config, params).items():
        leaf = expert_slice(path, leaf, expert_shard)
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to(device=device, dtype=dtype, copy=True)
        else:
            t = torch.from_numpy(np.array(leaf, dtype=np.float32, order="C")).to(device=device, dtype=dtype)
        model.set_leaf(path, t.contiguous())
    return model
