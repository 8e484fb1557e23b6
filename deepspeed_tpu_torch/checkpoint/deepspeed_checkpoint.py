"""Universal checkpoint.

Counterpart of ``deepspeed_tpu/checkpoint/deepspeed_checkpoint.py`` (the
reference's ``DeepSpeedCheckpoint``, per-param hp fragments
``universal_checkpoint.py:95``): a topology-free file, one record per
parameter holding the full fp32 master and the full optimizer-state
tensors. ``convert_to_universal`` writes the same ``zero_universal.npz``
(``<path>::fp32``, ``::exp_avg``, ``::exp_avg_sq`` keys) and
``universal_meta.json`` as the JAX package, from the port's engine
checkpoints, so each package's ``load_hp_checkpoint_state`` reads the
other's."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

ZERO_FILE = "zero_universal.npz"
META_FILE = "universal_meta.json"
PARAM_SHAPE_KEY = "param_shapes"


class DeepSpeedCheckpoint:
    """Inspect a deepspeed_tpu checkpoint dir (reference
    ``DeepSpeedCheckpoint`` surface: degree accessors + state access)."""

    def __init__(self, ckpt_dir: str, tp_degree: Optional[int] = None, pp_degree: Optional[int] = None):
        self.ckpt_dir = ckpt_dir
        tag = None
        latest = os.path.join(ckpt_dir, "latest")
        if os.path.isfile(latest):
            with open(latest) as f:
                tag = f.read().strip()
        self.tag = tag
        self.path = os.path.join(ckpt_dir, tag) if tag else ckpt_dir
        from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_checkpoint_engine import TorchCheckpointEngine

        self.state = TorchCheckpointEngine().load(self.path)
        # the target degrees are recorded for the reference's tools
        self.tp_degree = tp_degree or 1
        self.pp_degree = pp_degree or 1

    def get_iteration(self) -> int:
        return int(self.state.get("global_steps", 0))

    def get_module(self) -> Dict[str, Any]:
        return self.state["module"]

    def get_zero_checkpoint_state(self) -> Optional[Dict[str, Any]]:
        return self.state.get("optimizer")

    def show_tp_degree(self) -> int:
        return self.tp_degree

    def show_pp_degree(self) -> int:
        return self.pp_degree


def _flat(tree, prefix="") -> Dict[str, np.ndarray]:
    from deepspeed_tpu_torch.utils.tensor_fragment import _flatten_with_paths

    return {k: _numpy(v) for k, v in _flatten_with_paths(tree).items() if v is not None}


def _numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu()
        return v.float().numpy() if str(v.dtype) == "torch.bfloat16" else v.numpy()
    return np.asarray(v)


def convert_to_universal(ckpt_dir: str, out_dir: str, tag: Optional[str] = None) -> str:
    """Produce the universal format (reference ``ds_to_universal.py``):
    fp32 master + exp_avg/exp_avg_sq per param, topology-free."""
    from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

    os.makedirs(out_dir, exist_ok=True)
    ckpt = DeepSpeedCheckpoint(ckpt_dir)
    fp32 = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir, tag)

    records: Dict[str, np.ndarray] = {}
    for name, w in fp32.items():
        records[f"{name}::fp32"] = w
    opt = ckpt.get_zero_checkpoint_state()
    if isinstance(opt, dict) and "host_offload" in opt:
        from deepspeed_tpu_torch.runtime.zero.offload_states import assemble_records

        for name, per in zip(list(fp32.keys()), opt["host_offload"]["leaves"]):
            for key in ("exp_avg", "exp_avg_sq"):
                if isinstance(per, dict):  # a streamed record: the whole leaf
                    x = per[key]
                    x = x.detach().cpu().float().numpy() if hasattr(x, "detach") else np.asarray(x, np.float32)
                    records[f"{name}::{key}"] = x.reshape(fp32[name].shape)
                else:
                    records[f"{name}::{key}"] = assemble_records(per, key, fp32[name].shape)
    elif isinstance(opt, dict):
        for key in ("exp_avg", "exp_avg_sq"):
            if key in opt and opt[key] is not None:
                for name, v in _flat(opt[key]).items():
                    records[f"{name}::{key}"] = np.asarray(v, np.float32)

    out_file = os.path.join(out_dir, ZERO_FILE)
    np.savez(out_file, **records)
    meta = {
        "iteration": ckpt.get_iteration(),
        PARAM_SHAPE_KEY: {k: list(v.shape) for k, v in fp32.items()},
        "source": os.path.abspath(ckpt_dir),
    }
    from deepspeed_tpu_torch.runtime.checkpoint_engine.atomic import atomic_write_text

    atomic_write_text(os.path.join(out_dir, META_FILE), json.dumps(meta, indent=2))
    return out_file


def load_hp_checkpoint_state(universal_dir: str, name: str) -> Dict[str, np.ndarray]:
    """Per-param hp fragment load (reference universal_checkpoint.py:95):
    returns {fp32, exp_avg, exp_avg_sq} for one parameter path."""
    data = np.load(os.path.join(universal_dir, ZERO_FILE))
    out = {}
    for key in ("fp32", "exp_avg", "exp_avg_sq"):
        k = f"{name}::{key}"
        if k in data:
            out[key] = data[k]
    if not out:
        raise KeyError(f"no universal records for parameter {name!r}")
    return out


def universal_param_names(universal_dir: str) -> List[str]:
    data = np.load(os.path.join(universal_dir, ZERO_FILE))
    return sorted({k.split("::")[0] for k in data.files})
