#!/usr/bin/env python3
"""Where the time of a deepspeed_tpu_torch serving step goes, on one card.

    python3 tools/torch_serve_profile.py [--seed N] [--repeats N] [--horizon H]

Builds the chip_smoke.py serving engine (llama-1B at full width, bf16,
page_size 16, max_slots 8, seeded random weights; with ``--horizon H``
multi-step windows of H rounds, ``paged_kv.multi_step``) and serves the
smoke request mix once to warm up (a window server captures its CUDA graph
there). Then:

* ``spread``: the same mix served ``--repeats`` more times (warm prefix
  cache, no profiler), one JSON line with each run's tokens/s and TPOT /
  TTFT medians and their medians and quartiles over the runs;
* two windows profiled with ``torch.profiler`` (CPU + CUDA activities):

  ``mixed``, the first 8 steps after 8 new requests arrive (prefill
  chunks riding with decode rows, width 32), and ``decode``, 24 steps once
  every row decodes (width 1); with ``--horizon H``, 24 // H steps, each
  one window (one graph replay of H rounds).

For each profiled window it prints one JSON line: host wall time per step, device
time per step (the sum of kernel and copy time on the card), the device's
idle share (1 - device / wall), launches per step, the top device kernels
and the top host ops by self time. The profiler's own host cost inflates
the wall time per step; read host timing from chip_smoke.py's unprofiled
serve and take the device time and launch counts from here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import deepspeed_tpu_torch as dst  # noqa: E402
from deepspeed_tpu_torch.models import TransformerLM, llama_config  # noqa: E402


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _window(server, steps: int, name: str) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            server.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            device.append((evt.key, _device_us(evt), evt.count))
        else:
            host.append((evt.key, float(evt.self_cpu_time_total), evt.count))
    device.sort(key=lambda e: -e[1])
    host.sort(key=lambda e: -e[1])
    device_us = sum(e[1] for e in device)
    launches = sum(e[2] for e in device)
    return dict(
        window=name, steps=steps, wall_ms_per_step=wall * 1e3 / steps,
        device_ms_per_step=device_us / 1e3 / steps,
        device_idle_share=1.0 - device_us / 1e6 / wall if wall else None,
        device_ops_per_step=launches / steps,
        top_device=[dict(name=k[:80], ms_per_step=us / 1e3 / steps, share=us / device_us if device_us else 0.0,
                         calls_per_step=c / steps) for k, us, c in device[:12]],
        top_host=[dict(name=k[:60], ms_per_step=us / 1e3 / steps, calls_per_step=c / steps)
                  for k, us, c in host[:12]],
    )


def _spread(engine, prompts, budgets, repeats: int) -> dict:
    stats = engine._paged_server._tenant_stats["default"]
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        engine.serve(prompts, max_new_tokens=budgets)
        wall = time.perf_counter() - t0
        n = len(prompts)
        runs.append(dict(tokens_per_s=sum(budgets) / wall,
                         tpot_ms_p50=float(np.median(list(stats["tpot_ms"])[-n:])),
                         ttft_ms_p50=float(np.median(list(stats["ttft_ms"])[-n:]))))
    summary = {}
    for key in runs[0]:
        vals = np.array([r[key] for r in runs])
        summary[key] = dict(median=float(np.median(vals)), q1=float(np.percentile(vals, 25)),
                            q3=float(np.percentile(vals, 75)), min=float(vals.min()), max=float(vals.max()))
    return dict(window="spread", repeats=repeats, runs=runs, summary=summary)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--horizon", type=int, default=0, help="multi-step window rounds (0: single steps)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA card", file=sys.stderr)
        return 2
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    cfg = llama_config("1b")
    tree = chip_smoke._weights(cfg, args.seed)
    paged = {"page_size": 16, "max_slots": 8}
    if args.horizon:
        paged["multi_step"] = {"enable": True, "horizon": args.horizon}
    engine = dst.init_inference(TransformerLM(cfg), dtype="bf16", paged_kv=paged)
    engine.load_jax_params(tree)
    prompts, budgets = chip_smoke._requests(args.seed, cfg.vocab_size)
    engine.serve(prompts, max_new_tokens=budgets)  # warm-up: kernel build, allocator, caches
    print(json.dumps(dict(card=smi, **_spread(engine, prompts, budgets, args.repeats))), flush=True)
    server = engine._paged_server
    rs = np.random.default_rng(args.seed + 7)
    for n in np.linspace(96, 480, 8).astype(int):
        server.submit(rs.integers(0, cfg.vocab_size, int(n), dtype=np.int32), max_new_tokens=200)
    print(json.dumps(dict(card=smi, **_window(server, 8, "mixed"))), flush=True)
    while server.prefilling():
        server.step()
    steps = 24 // args.horizon if args.horizon else 24
    print(json.dumps(dict(card=smi, horizon=args.horizon, **_window(server, steps, "decode"))), flush=True)
    server.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
