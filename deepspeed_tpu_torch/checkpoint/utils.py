"""Checkpoint path helpers (reference ``deepspeed/checkpoint/utils.py``; the
port's copy of ``deepspeed_tpu/checkpoint/utils.py``)."""

from __future__ import annotations

import os

import numpy as np

from deepspeed_tpu_torch.checkpoint.constants import (
    MODEL_FILE_PREFIX,
    MODEL_FILE_SUFFIX,
    OPTIM_FILE_SUFFIX,
    ZERO_FILE_PREFIX,
)


def get_model_ckpt_name_for_rank(base_folder: str, mp_rank_str: str) -> str:
    return os.path.join(base_folder, MODEL_FILE_PREFIX + mp_rank_str + MODEL_FILE_SUFFIX)


def get_zero_ckpt_name_for_rank(base_folder: str, dp_rank: int, mp_rank: int) -> str:
    return os.path.join(
        base_folder,
        f"{ZERO_FILE_PREFIX}{dp_rank}_{MODEL_FILE_PREFIX}{mp_rank:02d}{OPTIM_FILE_SUFFIX}",
    )


def get_layer_ckpt_name_for_rank(base_folder: str, layer_id: str, tp_rank: int) -> str:
    return os.path.join(base_folder, f"{layer_id}-model_{tp_rank:02d}{MODEL_FILE_SUFFIX}")


def clone_tensors_for_torch_save(item, device=None):
    """(reference utils.py:42) Clone every tensor so ``torch.save`` does
    not serialize whole flat-buffer storages (a view saves its base's
    storage); numpy arrays become compact copies too."""
    if hasattr(item, "detach"):  # torch tensor passing through
        out = item.detach().clone()
        return out.to(device) if device is not None else out
    if isinstance(item, (list, tuple)):
        return type(item)(clone_tensors_for_torch_save(v, device) for v in item)
    if isinstance(item, dict):
        return type(item)({k: clone_tensors_for_torch_save(v, device) for k, v in item.items()})
    if hasattr(item, "__array__"):
        return np.array(item)  # compact host copy (np.array always copies)
    return item
