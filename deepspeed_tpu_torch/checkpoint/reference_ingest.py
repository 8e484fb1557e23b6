"""Read reference-layout (DeepSpeed torch) checkpoints.

Counterpart of ``deepspeed_tpu/checkpoint/reference_ingest.py``, the parts
that need no architecture policy. The reference saves per-rank torch
pickles (``deepspeed/runtime/engine.py:2582-2588``):

* ``{tag}/mp_rank_{mp:02d}_model_states.pt``: module weights, one file per
  model-parallel rank (TP-sharded tensors), replicated across dp;
* ``{tag}/zero_pp_rank_{dp}_mp_rank_{mp:02d}_optim_states.pt``: the ZeRO
  stage-1/2 optimizer partitions, each dp rank's slice of the flat fp32
  master per param group (``single_partition_of_fp32_groups``), with
  per-param shapes recorded in the model file (``param_shapes``).

``merge_reference_model_states`` and ``merge_reference_zero_fp32`` rebuild
full tensors from that layout (TP shards merged along per-name axes, the
dp-flat fp32 partitions concatenated and re-split by the recorded shapes:
the ``ds_to_universal.py`` algorithm); ``read_universal_dir`` reads a
universal checkpoint directory. Converting a merged state dict onto the
model (``ingest_reference_checkpoint``, ``ingest_universal_checkpoint``)
needs the module_inject container policies, which are not ported yet.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.checkpoint.reshape_utils import merge_tp_slices

# torch [out, in] Linear convention: "column"-parallel shards the OUT dim
# (axis 0), "row"-parallel the IN dim (axis 1)
_MEGATRON_TP_AXES = [
    (r"query_key_value\.(weight|bias)$", 0),
    (r"dense_h_to_4h\.(weight|bias)$", 0),
    (r"attention\.dense\.weight$", 1),
    (r"dense_4h_to_h\.weight$", 1),
    (r"word_embeddings\.weight$", 0),
]

_HF_LLAMA_TP_AXES = [
    (r"(q|k|v)_proj\.weight$", 0),
    (r"(gate|up)_proj\.weight$", 0),
    (r"(o|down)_proj\.weight$", 1),
    (r"embed_tokens\.weight$", 0),
    (r"lm_head\.weight$", 0),
]


def tp_merge_axis(name: str, model_type: str) -> Optional[int]:
    """Concat axis for one param's TP shards; None = replicated (take rank 0).
    The reference records no sharding metadata in the files — the axis is a
    property of the architecture (module_inject policy knowledge)."""
    table = (
        _HF_LLAMA_TP_AXES
        if model_type in ("llama", "mistral")
        else _MEGATRON_TP_AXES
    )
    for pattern, axis in table:
        if re.search(pattern, name):
            return axis
    return None


def _torch_load(path: str):
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


def _to_numpy(t) -> np.ndarray:
    """Torch tensor → numpy, promoted to fp32 (lossless for bf16; the merge
    paths want one dtype)."""
    if hasattr(t, "detach"):
        return t.detach().cpu().float().numpy()
    return np.asarray(t)


def _resolve_tag_dir(ckpt_dir: str, tag: Optional[str]) -> str:
    if tag is None:
        latest = os.path.join(ckpt_dir, "latest")
        if os.path.isfile(latest):
            with open(latest) as f:
                tag = f.read().strip()
    path = os.path.join(ckpt_dir, tag) if tag else ckpt_dir
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint dir at {path}")
    return path


def _model_state_files(path: str) -> List[str]:
    if glob.glob(os.path.join(path, "layer_*-model_*-model_states.pt")):
        raise NotImplementedError(
            "pipeline-partitioned reference checkpoints (per-layer "
            "layer_XX-model_YY files) are not ingestable yet; consolidate "
            "with the reference's ds_to_universal first"
        )
    files = sorted(glob.glob(os.path.join(path, "mp_rank_*_model_states.pt")))
    if not files:
        # stage-3 reference checkpoints scatter module states across dp ranks
        # (zero_pp_rank_{dp}_mp_rank_{mp}_model_states.pt) — name the layout
        # instead of a bare FileNotFoundError
        if glob.glob(os.path.join(path, "*zero_pp_rank_*_model_states.pt")):
            raise NotImplementedError(
                "ZeRO stage-3 reference checkpoints (per-dp-rank "
                "zero_pp_rank_*_model_states.pt module files) are not "
                "ingestable; consolidate with the reference's "
                "zero_to_fp32.py or ds_to_universal first"
            )
        raise FileNotFoundError(f"no mp_rank_*_model_states.pt under {path}")
    return files


def merge_reference_model_states(
    ckpt_dir: str, model_type: str, tag: Optional[str] = None
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Full (TP-merged) torch state dict + meta from a reference checkpoint."""
    path = _resolve_tag_dir(ckpt_dir, tag)
    files = _model_state_files(path)
    states = [_torch_load(f) for f in files]
    modules = [s.get("module", s) for s in states]
    tp = len(files)
    merged: Dict[str, np.ndarray] = {}
    for name in modules[0]:
        shards = [_to_numpy(m[name]) for m in modules]
        axis = tp_merge_axis(name, model_type) if tp > 1 else None
        if axis is None:
            merged[name] = shards[0]
        else:
            merged[name] = merge_tp_slices(shards, axis=axis)
    meta = {
        "tp_degree": tp,
        "iteration": int(states[0].get("global_steps") or states[0].get("iteration") or 0),
        "param_shapes": states[0].get("param_shapes"),
        "dp_world_size": states[0].get("dp_world_size"),
    }
    return merged, meta


def merge_reference_zero_fp32(
    ckpt_dir: str, model_type: str, tag: Optional[str] = None
) -> Dict[str, np.ndarray]:
    """fp32 masters from the ZeRO stage-1/2 optimizer shards, keyed by the
    torch param names (the ``ds_to_universal.py`` reconstruction): for each
    mp rank, concatenate every dp rank's flat partition per group and
    re-split by the ``param_shapes`` recorded in the model file; then
    TP-merge across mp ranks."""
    path = _resolve_tag_dir(ckpt_dir, tag)
    model_files = _model_state_files(path)
    per_mp: List[Dict[str, np.ndarray]] = []
    for mp, mf in enumerate(model_files):
        shapes_groups = _torch_load(mf).get("param_shapes")
        if shapes_groups is None:
            raise ValueError(
                f"{mf} records no param_shapes; cannot reconstruct fp32 "
                "masters from flat ZeRO partitions"
            )
        # bf16 runs prefix the shards (engine _get_zero_ckpt_prefix):
        # bf16_zero_pp_rank_{dp}_mp_rank_{mp}_optim_states.pt
        zfiles = sorted(
            glob.glob(os.path.join(path, f"zero_pp_rank_*_mp_rank_{mp:02d}_optim_states.pt"))
            or glob.glob(os.path.join(path, f"bf16_zero_pp_rank_*_mp_rank_{mp:02d}_optim_states.pt")),
            key=lambda p: int(re.search(r"zero_pp_rank_(\d+)_", p).group(1)),
        )
        if not zfiles:
            raise FileNotFoundError(
                f"no (bf16_)zero_pp_rank_*_mp_rank_{mp:02d} files under {path}"
            )
        zstates = [_torch_load(f)["optimizer_state_dict"] for f in zfiles]
        n_groups = len(shapes_groups)
        out: Dict[str, np.ndarray] = {}
        for g in range(n_groups):
            flat = np.concatenate(
                [_to_numpy(z["single_partition_of_fp32_groups"][g]).ravel() for z in zstates]
            )
            offset = 0
            for name, shape in shapes_groups[g].items():
                n = int(np.prod(shape))
                out[name] = flat[offset : offset + n].reshape(tuple(shape))
                offset += n
            # anything past offset is the dp-divisibility padding
        per_mp.append(out)
    if len(per_mp) == 1:
        return per_mp[0]
    merged: Dict[str, np.ndarray] = {}
    for name in per_mp[0]:
        axis = tp_merge_axis(name, model_type)
        shards = [m[name] for m in per_mp]
        merged[name] = shards[0] if axis is None else merge_tp_slices(shards, axis=axis)
    return merged


_CONTAINERS = ("needs the module_inject container policies (module_inject/containers.py, "
               "replace_module.py), which are not ported yet (ROADMAP P1, module_inject containers)")


def ingest_reference_checkpoint(ckpt_dir: str, model_config: Any, model_type: Optional[str] = None,  # noqa: ARG001
                                tag: Optional[str] = None, use_zero_fp32: bool = True,  # noqa: ARG001
                                dtype: Optional[str] = None):  # noqa: ARG001
    """A reference checkpoint → model and param tree (JAX
    ``reference_ingest.py:205``). The merge is ported
    (``merge_reference_model_states``, ``merge_reference_zero_fp32``); the
    conversion onto the model is not."""
    raise NotImplementedError("ingest_reference_checkpoint " + _CONTAINERS)


def read_universal_dir(universal_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a reference *universal* checkpoint directory (the layout
    ``ds_to_universal.py`` writes and ``universal_checkpoint.py:12``
    ``load_hp_checkpoint_state`` reads): one folder per parameter holding
    ``fp32.pt`` plus optimizer-state files (``exp_avg.pt``,
    ``exp_avg_sq.pt``), each a torch file with the full (TP-merged,
    padding-stripped) tensor under the ``param`` key (raw-tensor files are
    tolerated). Returns ``{key: {param_name: ndarray}}`` for every key
    found, e.g. ``{"fp32": {...}, "exp_avg": {...}}``."""
    root = universal_dir
    zero = os.path.join(root, "zero")
    if os.path.isdir(zero):
        root = zero
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"{universal_dir} is not a universal checkpoint directory "
            "(expected <dir>/zero/<param>/fp32.pt folders)"
        )
    out: Dict[str, Dict[str, np.ndarray]] = {}
    found_any = False
    for name in sorted(os.listdir(root)):
        folder = os.path.join(root, name)
        if not os.path.isdir(folder):
            continue
        for fn in sorted(os.listdir(folder)):
            if not fn.endswith(".pt"):
                continue
            key = fn[:-3]
            blob = _torch_load(os.path.join(folder, fn))
            tensor = blob.get("param") if isinstance(blob, dict) else blob
            if tensor is None:
                continue
            out.setdefault(key, {})[name] = _to_numpy(tensor)
            found_any = True
    if not found_any:
        raise FileNotFoundError(
            f"no <param>/<key>.pt files under {universal_dir} — not a "
            "universal checkpoint"
        )
    return out


def ingest_universal_checkpoint(universal_dir: str, model_config: Any,  # noqa: ARG001
                                model_type: Optional[str] = None, load_optimizer: bool = True,  # noqa: ARG001
                                dtype: Optional[str] = None):  # noqa: ARG001
    """A reference universal checkpoint → model, params and moments (JAX
    ``reference_ingest.py:293``). ``read_universal_dir`` is ported; the
    conversion onto the model is not."""
    raise NotImplementedError("ingest_universal_checkpoint " + _CONTAINERS)
