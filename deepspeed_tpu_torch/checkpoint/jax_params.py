"""Load the JAX package's parameter tree into the port's ``TransformerLM``.

The only place where a layout could change. The JAX tree arrives as numpy
arrays, either nested (``{"embed": {"tokens": ...}, "layers": {...}, ...}``)
or flat under the path convention of
``deepspeed_tpu/checkpoint/reference_export.py:19-22`` (``embed/tokens``,
``layers/wq``, ..., ``final_norm_scale``, ``lm_head``). The port keeps the
JAX layout (stacked ``[L, ...]`` layers, ``[in, out]`` weights), so every
leaf is copied as it is.

Each leaf is stored in the engine dtype once. JAX keeps fp32 weights and
casts them at every matmul (``compression/int8.py:97``); one cast up front
gives the same bits at half the memory traffic in bf16.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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


@torch.no_grad()
def load_jax_params(model: TransformerLM, params: Mapping[str, Any], device=None,
                    dtype: torch.dtype = torch.float32) -> TransformerLM:
    """Install the JAX tree ``params`` into ``model`` on ``device``
    (``cuda`` by default; raises without a card) in ``dtype``. The set of
    paths and every shape must match the model's config exactly; anything
    else raises before any leaf is replaced."""
    device = resolve_device(device)
    flat = flatten_tree(params)
    want = param_shapes(model.config)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"JAX tree does not match the config: missing {missing}, unexpected {extra}")
    for path, shape in want.items():
        got = tuple(np.shape(flat[path]))
        if got != tuple(shape):
            raise ValueError(f"{path}: JAX leaf has shape {got}, the config wants {tuple(shape)}")
    for path in want:
        arr = np.ascontiguousarray(np.asarray(flat[path], dtype=np.float32))
        if not arr.flags.writeable:  # e.g. a view of a JAX array: torch wants writable memory
            arr = arr.copy()
        model.set_leaf(path, torch.from_numpy(arr).to(device=device, dtype=dtype))
    return model
