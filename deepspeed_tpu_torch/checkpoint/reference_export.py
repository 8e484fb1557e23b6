"""Export training state in the reference's checkpoint layout.

Counterpart of ``deepspeed_tpu/checkpoint/reference_export.py``, with the
same files, keys, flat order, padding and ``latest``. It writes the
torch-pickle file family the reference emits for a ZeRO stage-1/2 run
(``deepspeed/runtime/engine.py:2588`` ``_save_checkpoint`` and ``:2961``
``_save_zero_checkpoint``), which the reference's ``zero_to_fp32.py``
consolidates:

* ``{tag}/mp_rank_00_model_states.pt``: the ``module`` weights (compute
  dtype) with ``param_shapes`` (per group, name → ``torch.Size``),
  ``buffer_names``, ``shared_params``, ``ds_version`` and ``iteration``;
* ``{tag}/zero_pp_rank_{dp}_mp_rank_00_optim_states.pt``: each dp rank's
  slice of the flat fp32 master under ``optimizer_state_dict`` with
  ``zero_stage``, ``partition_count`` and
  ``single_partition_of_fp32_groups``;
* ``latest``: the tag.

Tensor names are the JAX tree's flat paths (stacked ``layers/...`` leaves
stay stacked), in that tree's sorted path order.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional

import torch

from deepspeed_tpu_torch.checkpoint.utils import get_model_ckpt_name_for_rank, get_zero_ckpt_name_for_rank
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime.checkpoint_engine.atomic import write_latest_marker
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.tensor_fragment import _flatten_with_paths

DS_VERSION = "0.10.2+tpu"  # the version string the JAX package's export writes


def export_reference_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                                dp_shards: Optional[int] = None) -> str:
    """Write ``engine``'s weights and fp32 masters in the reference layout.

    ``dp_shards`` is how many ``zero_pp_rank_*`` files the flat fp32 master
    is split across (default: the engine's data-parallel world size); the
    flat vector is zero-padded to a multiple of it. At dp > 1 every rank
    calls it (the slices are gathered) and rank 0 writes. Returns the tag
    directory."""
    if tag is None:
        tag = f"global_step{engine.global_steps}"
    if dp_shards is None:
        dp_shards = max(int(engine.data_parallel_world_size()), 1)
    masters = {name: torch.from_numpy(leaf).float()
               for name, leaf in _flatten_with_paths(engine.get_master_params()).items()}
    module_sd = engine.consolidated_16bit_state_dict()
    path = os.path.join(save_dir, tag)
    if getattr(engine, "dp_rank", 0) != 0:
        comm.barrier()
        return path

    os.makedirs(path, exist_ok=True)
    names = list(masters.keys())
    param_shapes = OrderedDict((name, torch.Size(masters[name].shape)) for name in names)
    flat = torch.cat([masters[n].reshape(-1) for n in names]) if names else torch.zeros(0)
    pad = (-flat.numel()) % dp_shards
    flat = torch.nn.functional.pad(flat, (0, pad))  # dp-divisibility padding; consolidation ignores the tail
    partitions = flat.chunk(dp_shards)

    zero_stage = min(int(engine.zero_optimization_stage()), 2)
    model_state = {
        "module": {k: v.contiguous() for k, v in module_sd.items()},
        "buffer_names": [],
        "shared_params": {},
        "param_shapes": [param_shapes],
        "dp_world_size": dp_shards,
        "mp_world_size": 1,
        "iteration": int(engine.global_steps),
        "global_steps": int(engine.global_steps),
        "ds_version": DS_VERSION,
    }
    torch.save(model_state, get_model_ckpt_name_for_rank(path, "00"))
    for dp, part in enumerate(partitions):
        optim_state = {
            "optimizer_state_dict": {
                "zero_stage": zero_stage,
                "partition_count": dp_shards,
                "single_partition_of_fp32_groups": [part.clone()],
                "ds_version": DS_VERSION,
            }
        }
        torch.save(optim_state, get_zero_ckpt_name_for_rank(path, dp, 0))
    write_latest_marker(save_dir, tag)
    comm.barrier()
    log_dist(f"exported reference-layout checkpoint: {path} ({len(names)} tensors, dp_shards={dp_shards})",
             ranks=[0])
    return path
