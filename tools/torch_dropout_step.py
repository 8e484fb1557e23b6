#!/usr/bin/env python3
"""The eager training step with dropout on one card, for one checkout.

    python3 tools/torch_dropout_step.py [--repo DIR] [--steps N] [--label NAME]

Imports ``deepspeed_tpu_torch`` from ``--repo`` (default: this checkout),
so two trees can be timed in one call on the same card. The model is
config 1's (``gpt2_config("125m", max_seq_len=1024, remat=False)``) with
``attn_dropout`` and ``hidden_dropout`` 0.1, which sends attention past the
flash kernels to the plain einsum path; bf16, micro 8 x T 1024, gas 4,
FusedAdam with weight decay 0.01, clip 1.0, driven eagerly through
``train_batch``. One warm-up step, then ``--steps`` steps timed on the host
clock with the card synchronised after each; then the same without
dropout; then the tree's ``_dropout`` alone on the attention probabilities
of one layer (fp32 [8, 12, 1024, 1024]) by CUDA events. Prints the card's
name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def _step_ms(dst, TransformerLM, cfg, tree, steps, dev):
    config = {"train_micro_batch_size_per_gpu": 8, "gradient_accumulation_steps": 4, "bf16": {"enabled": True},
              "gradient_clipping": 1.0, "optimizer": {"type": "adam", "params": {"lr": 1e-4, "weight_decay": 0.01}}}
    engine = dst.initialize(model=TransformerLM(cfg), config=config, model_parameters=tree)[0]
    rs = np.random.RandomState(1)
    data = []
    for _ in range(4 * (steps + 1)):
        toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (8, 1025)).astype(np.int64)).to(dev)
        data.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    it = iter(data)
    losses = [float(engine.train_batch(data_iter=it))]
    walls = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(data_iter=it)))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    del engine
    torch.cuda.empty_cache()
    return walls, losses


def _dropout_call_ms(transformer, dev, iters=20):
    x = torch.rand(8, 12, 1024, 1024, device=dev)
    if "gen" in inspect.signature(transformer._dropout).parameters:
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        fn = lambda: transformer._dropout(x, 0.1, gen)  # noqa: E731
    else:
        seed = torch.tensor(7, dtype=torch.int64, device=dev)
        fn = lambda: transformer._dropout(x, 0.1, seed, transformer._ATTN_SALT)  # noqa: E731
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dropout_step: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo))
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.jax_params import unflatten_tree
    from deepspeed_tpu_torch.models import TransformerLM, gpt2_config
    from deepspeed_tpu_torch.models import transformer
    from deepspeed_tpu_torch.models.transformer import init_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    base = gpt2_config("125m", max_seq_len=1024, remat=False)
    tree = unflatten_tree(init_params(base, 0))
    out = {"label": args.label, "package": os.path.dirname(dst.__file__), "card": smi}
    for name, cfg in (("dropout", gpt2_config("125m", max_seq_len=1024, remat=False, attn_dropout=0.1,
                                               hidden_dropout=0.1)), ("no_dropout", base)):
        walls, losses = _step_ms(dst, TransformerLM, cfg, tree, args.steps, dev)
        out[name] = {"step_ms_median": statistics.median(walls), "step_walls_ms": walls, "losses": losses}
    out["dropout_call_ms"] = _dropout_call_ms(transformer, dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
