"""Where the time of a training step goes, on one card.

    python -m deepspeed_tpu_torch.profiling.train_profile [--seed N] [--steps N] [--trace PATH]

Builds the training main path of ``chip_smoke.py`` (GPT-2 125M at full
width, ``max_seq_len=1024``, ``remat=False``, bench.py config 1: bf16,
ZeRO-1, Adam with weight decay 0.01, clipping 1.0, micro batch 8) from
seeded random weights and one batch placed on the card, runs 3 warm-up
steps, then:

* ``steps``: ``--steps`` steps without the profiler, each timed on the host
  clock between two ``torch.cuda.synchronize()`` calls: ms per step, their
  median and spread, tokens/s;
* ``profile``: ``--steps`` more steps under ``torch.profiler`` (CPU and
  CUDA activities): device time per step (the sum of kernel and copy
  time), the device's idle share against the unprofiled step time
  (1 - device / step), device ops and the flash kernels' launches per
  step, device time by kernel (the flash kernels K1-K3 and their
  tensor-core variants by name, the rest
  grouped), and the top host ops by self time.

Each part prints one JSON line beside the card's ``nvidia-smi`` name and
power limit. ``--trace`` also writes the Chrome trace of the profiled
window. The profiler's own host cost inflates host time under it; the
idle share is taken against the unprofiled step.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import TransformerLM, gpt2_config
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

CONFIG = {  # bench.py:507-517, config 1
    "train_micro_batch_size_per_gpu": 8,
    "optimizer": {"type": "adam", "params": {"lr": 3e-4, "weight_decay": 0.01}},
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 1},
    "gradient_clipping": 1.0,
    "steps_per_print": 10_000,
}
# the FMA kernels and the tensor-core variants, each by its own name
FLASH_KERNELS = ("flash_fwd_kernel", "flash_fwd_tc_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                 "flash_dkv_tc_kernel")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _group(name: str) -> str:
    """Kernel families: the flash kernels (and their tensor-core variants)
    by name, GEMMs, the rest by their leading word."""
    for k in FLASH_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if any(t in low for t in ("gemm", "nvjet", "cutlass", "sm90_xmma", "ampere_", "cublas")):
        return "gemm"
    if "memcpy" in low or "memset" in low:
        return "copy/memset"
    return name.replace("(anonymous namespace)::", "").split("<")[0].split("(")[0][:60]


def _step(engine, batch):
    loss = engine(batch)
    engine.backward(loss)
    engine.step()
    return loss


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trace", default=None, help="write the profiled window's Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_profile: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = gpt2_config("125m", max_seq_len=1024, remat=False)
    engine, _, _, _ = dst.initialize(model=TransformerLM(cfg), config=dict(CONFIG),
                                     model_parameters=init_params(cfg, args.seed))
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, cfg.max_seq_len + 1)).astype(np.int32)
    dev = engine.device
    batch = {"input_ids": torch.from_numpy(toks[:, :-1]).to(dev), "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
    for _ in range(3):
        _step(engine, batch)
    torch.cuda.synchronize()

    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        _step(engine, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = np.array(times)
    step_ms = float(np.median(ms))
    print(json.dumps(dict(card=smi, part="steps", steps=args.steps, ms_per_step=times, median_ms=step_ms,
                          q1_ms=float(np.percentile(ms, 25)), q3_ms=float(np.percentile(ms, 75)),
                          tokens_per_s=8 * cfg.max_seq_len / (step_ms / 1e3))), flush=True)

    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            _step(engine, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    flash_launches = [b - a for a, b in zip(before, (fa.launches_fwd, fa.launches_dq, fa.launches_dkv))]
    if args.trace:
        prof.export_chrome_trace(args.trace)
    groups, host = {}, []
    device_us, ops = 0.0, 0
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = _device_us(evt)
            g = groups.setdefault(_group(evt.key), [0.0, 0])
            g[0] += us
            g[1] += evt.count
            device_us += us
            ops += evt.count
        else:
            host.append((evt.key, float(evt.self_cpu_time_total), evt.count))
    host.sort(key=lambda e: -e[1])
    n = args.steps
    device_ms = device_us / 1e3 / n
    print(json.dumps(dict(
        card=smi, part="profile", steps=n, profiled_wall_ms_per_step=wall * 1e3 / n,
        device_ms_per_step=device_ms, unprofiled_step_ms=step_ms,
        device_idle_share=1.0 - device_ms / step_ms, device_ops_per_step=ops / n,
        flash_launches_per_step=dict(zip(("flash_fwd", "flash_dq", "flash_dkv"), (x / n for x in flash_launches))),
        by_kernel=sorted(({"kernel": k, "ms_per_step": us / 1e3 / n, "share": us / device_us if device_us else 0.0,
                           "calls_per_step": c / n} for k, (us, c) in groups.items()),
                         key=lambda e: -e["ms_per_step"])[:16],
        top_host=[dict(name=k[:60], ms_per_step=us / 1e3 / n, calls_per_step=c / n) for k, us, c in host[:10]],
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
