#!/usr/bin/env python3
"""Streamed-offload training in multi-step windows against the sequential
streamed engine, on one card, for one checkout.

    python3 tools/torch_offload_window.py [--repo DIR] [--windows N] [--label NAME]

Imports ``deepspeed_tpu_torch`` from ``--repo`` (default: this checkout),
so two trees can be measured in one call. Config 1's model
(``gpt2_config("125m", max_seq_len=1024, remat=False)``), bf16, micro 8,
ZeRO-1 with the optimizer state streamed from pinned host memory
(``pipeline_read``/``pipeline_write``), FusedAdam with weight decay 0.01,
clip 1.0. The sequential engine and then the windowed one (horizon 4) each
train ``4 * --windows`` steps on the same batches. For each: every step's
host wall (a window's first call carries the whole window; the card is
synchronised after each call), the peak allocated bytes of the run, and
the allocated bytes after its last step once the caching allocator has
processed its deferred frees and cuBLAS's per-stream workspaces (a process
cache) are cleared. The first tree run in a call builds the kernels in its
first steps. Prints the card's name and power limit, then one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

H = 4


def _run(dst, TransformerLM, cfg, tree, data, horizon, dev):
    config = {"train_micro_batch_size_per_gpu": 8, "bf16": {"enabled": True}, "gradient_clipping": 1.0,
              "optimizer": {"type": "adam", "params": {"lr": 1e-4, "weight_decay": 0.01}},
              "zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu", "pipeline_read": True,
                                                                      "pipeline_write": True}},
              "compile": {"multi_step": {"enable": horizon > 0, "horizon": max(horizon, 2)}}}
    engine = dst.initialize(model=TransformerLM(cfg), config=config, model_parameters=tree)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    it = iter(data)
    walls, losses = [], []
    for _ in range(len(data)):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(data_iter=it)))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    stats = engine.window_stats() if hasattr(engine, "window_stats") else {}
    del engine, it
    torch.cuda.empty_cache()
    return {"step_walls_ms": walls, "allocated_after": held, "peak_allocated": peak, "losses": losses,
            "graphs": stats.get("graphs"), "window_steps": stats.get("window_steps")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--windows", type=int, default=4)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_offload_window: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo))
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.jax_params import unflatten_tree
    from deepspeed_tpu_torch.models import TransformerLM, gpt2_config
    from deepspeed_tpu_torch.models.transformer import init_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    cfg = gpt2_config("125m", max_seq_len=1024, remat=False)
    tree = unflatten_tree(init_params(cfg, 0))
    rs = np.random.RandomState(2)
    data = []
    for _ in range(H * args.windows):
        toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (8, 1025)).astype(np.int64)).to(dev)
        data.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    out = {"label": args.label, "package": os.path.dirname(dst.__file__), "card": smi, "horizon": H}
    out["sequential"] = _run(dst, TransformerLM, cfg, tree, data, 0, dev)
    out["windowed"] = _run(dst, TransformerLM, cfg, tree, data, H, dev)
    out["same_losses"] = out["sequential"]["losses"] == out["windowed"]["losses"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
