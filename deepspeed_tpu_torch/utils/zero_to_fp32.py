"""Offline consolidation of an engine checkpoint into one fp32 file.

Counterpart of ``deepspeed_tpu/utils/zero_to_fp32.py`` (the reference's
``deepspeed/utils/zero_to_fp32.py``, ``_get_fp32_state_dict_from_zero_checkpoint``
:194), reading the port's engine checkpoints: a flat ``path -> fp32 numpy``
dict, saved as ``.npz``, loadable without the engine.

CLI (the reference's usage)::

    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <checkpoint_dir> <output_file> [--tag TAG]
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import numpy as np

from deepspeed_tpu_torch.utils.tensor_fragment import _flatten_with_paths


def _flatten(tree) -> Dict[str, np.ndarray]:
    """Path → fp32 leaf, in the tree's sorted path order (JAX's
    ``tree_flatten`` order)."""
    return {
        k: v.detach().cpu().float().numpy() if hasattr(v, "detach") else np.asarray(v, dtype=np.float32)
        for k, v in _flatten_with_paths(tree).items()
        if v is not None
    }


def get_fp32_state_dict_from_zero_checkpoint(
    checkpoint_dir: str, tag: Optional[str] = None
) -> Dict[str, np.ndarray]:
    """Full fp32 weights from an engine checkpoint (reference :194). Prefers
    the fp32 master (exact optimizer view); falls back to the module
    weights upcast to fp32 (fp32 training keeps no separate master)."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_checkpoint_engine import TorchCheckpointEngine

    if tag is None:
        latest = os.path.join(checkpoint_dir, "latest")
        if os.path.isfile(latest):
            with open(latest) as f:
                tag = f.read().strip()
    path = os.path.join(checkpoint_dir, tag) if tag else checkpoint_dir
    state = TorchCheckpointEngine().load(path)

    master = state.get("master")
    if master is None:
        opt = state.get("optimizer")
        if isinstance(opt, dict) and "host_offload" in opt:
            # offload checkpoints keep the master inside the host-offload records; each leaf is
            # reassembled from its slice records (streamed records are whole leaves)
            from deepspeed_tpu_torch.runtime.zero.offload_states import assemble_records

            module_flat = _flatten(state["module"])
            out: Dict[str, np.ndarray] = {}
            for name, per in zip(module_flat, opt["host_offload"]["leaves"]):
                if isinstance(per, dict):
                    out[name] = _flatten({"m": per["master"]})["m"].reshape(module_flat[name].shape)
                else:
                    out[name] = assemble_records(per, "master", module_flat[name].shape)
            return out
        master = state.get("module")
    return _flatten(master)


def convert_zero_checkpoint_to_fp32_state_dict(
    checkpoint_dir: str, output_file: str, tag: Optional[str] = None
) -> None:
    """(reference ``convert_zero_checkpoint_to_fp32_state_dict``)"""
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    np.savez(output_file, **sd)
    total = sum(v.size for v in sd.values())
    print(f"saved {len(sd)} tensors ({total:,} fp32 params) to {output_file}")


def load_state_dict_from_zero_checkpoint(model_params: Any, checkpoint_dir: str, tag=None):
    """Overwrite a param pytree's leaves with consolidated fp32 weights
    (reference ``load_state_dict_from_zero_checkpoint``)."""
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            vals = [rebuild(v, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree)]
            return type(tree)(vals)
        return sd.get(prefix, tree)

    return rebuild(model_params)


def main():
    parser = argparse.ArgumentParser(description="consolidate a ZeRO checkpoint to fp32")
    parser.add_argument("checkpoint_dir")
    parser.add_argument("output_file")
    parser.add_argument("--tag", default=None)
    args = parser.parse_args()
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir, args.output_file, args.tag)


if __name__ == "__main__":
    main()
