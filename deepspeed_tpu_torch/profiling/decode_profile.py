"""Where the time of a decode step goes, on one card: the dense ``generate``
loop (K6) and the bucketed server's decode round (K5).

    python -m deepspeed_tpu_torch.profiling.decode_profile [--seed N] [--trace-dir DIR]

Builds ``init_inference(TransformerLM(llama_config("1b")), dtype="bf16")``
at full width and depth with seeded random weights (the JAX init's
distributions), then prints one JSON line per part, each beside the card's
``nvidia-smi`` name and power limit:

* ``generate``: ``engine.generate`` on 16 prompts of 128 tokens with 128 new
  tokens (cache length 256: every decode step runs K6), warm. Unprofiled
  wall time and tokens/s; then the prompt's prefill alone and the whole
  call, each under ``torch.profiler`` (CPU and CUDA activities). Per
  generate step = (whole call - prefill) / 128: device ms, device ops,
  ``cudaLaunchKernel`` calls, K6's launches and its share of the device
  time, and the device's idle share against the unprofiled step time
  (1 - device / step);
* ``bucketed``: ``paged_kv={"page_size": 16, "max_slots": 8, "ragged":
  False}``; 8 requests (prompts of 128..512 tokens, 512 new tokens each)
  run until every row decodes, then ``ROUNDS`` scheduler steps, each one
  decode round of bucket 8, timed unprofiled and then profiled: the same
  figures per round, with K5's launches and share.

``--trace-dir`` also writes each profiled window's Chrome trace there. The
profiler's own host cost inflates host time under it; idle shares are taken
against the unprofiled times.
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
from torch.profiler import ProfilerActivity, profile

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.inference import decode
from deepspeed_tpu_torch.models import TransformerLM, llama_config
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.ops.transformer import decode_attention as da

ROUNDS = 24  # profiled decode rounds of the bucketed part
# each kernel's device functions; K5 and K6 share decode_combine_kernel, and a profiled window runs one of them
KERNELS = {"K6": ("dense_decode_split_kernel", "decode_combine_kernel"),
           "K5": ("paged_decode_split_kernel", "decode_combine_kernel"),
           "K4": ("ragged_split_kernel", "ragged_combine_kernel")}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profiled(fn, trace=None):
    """Run ``fn`` under the profiler, draining the card; returns the window's
    device microseconds, device ops, ``cudaLaunch*`` calls, microseconds
    per kernel family of ``KERNELS``, and the top device kernels."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    if trace:
        prof.export_chrome_trace(trace)
    device_us, ops, launch_calls = 0.0, 0, 0
    by_kernel = {k: 0.0 for k in KERNELS}
    top = {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = _device_us(evt)
            device_us += us
            ops += evt.count
            top[evt.key[:80]] = top.get(evt.key[:80], 0.0) + us
            for k, names in KERNELS.items():
                if any(name in evt.key for name in names):
                    by_kernel[k] += us
        elif evt.key.startswith("cudaLaunch"):
            launch_calls += evt.count
    return dict(device_us=device_us, ops=ops, launch_calls=launch_calls, by_kernel=by_kernel,
                top=sorted(top.items(), key=lambda kv: -kv[1])[:10])


def _per(window, n, step_ms, kernel, launches):
    device_ms = window["device_us"] / 1e3 / n
    return dict(
        device_ms=device_ms, device_ops=window["ops"] / n, cuda_launch_calls=window["launch_calls"] / n,
        device_idle_share=1.0 - device_ms / step_ms, unprofiled_ms=step_ms,
        kernel=kernel, kernel_launches=launches / n,
        kernel_share_of_device=window["by_kernel"][kernel] / window["device_us"] if window["device_us"] else 0.0,
        kernel_ms=window["by_kernel"][kernel] / 1e3 / n,
    )


def _trace(args, name):
    return os.path.join(args.trace_dir, f"{name}.json") if args.trace_dir else None


def part_generate(engine, cfg, args, smi):
    rs = np.random.default_rng(args.seed)
    prompts = rs.integers(0, cfg.vocab_size, (16, 128), dtype=np.int32)
    new = 128
    engine.generate(prompts, max_new_tokens=new)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if tuple(out.shape) != (16, 256):
        raise AssertionError(f"generate returned {tuple(out.shape)}")
    params = engine.module.param_tree()
    prefill, _ = decode.build_decoder(cfg)
    tokens = torch.from_numpy(prompts).to(engine.device)

    def run_prefill():
        prefill(params, tokens, decode.init_cache(cfg, 16, 256, device=engine.device))

    run_prefill()
    t0 = time.perf_counter()
    run_prefill()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    w_prefill = _profiled(run_prefill, _trace(args, "prefill"))
    before = da.launches_decode
    w_all = _profiled(lambda: engine.generate(prompts, max_new_tokens=new), _trace(args, "generate"))
    launches = da.launches_decode - before
    steps = {k: w_all[k] - w_prefill[k] for k in ("device_us", "ops", "launch_calls")}
    steps["by_kernel"] = {k: w_all["by_kernel"][k] - w_prefill["by_kernel"][k] for k in KERNELS}
    step_ms = (wall * 1e3 - prefill_ms) / new
    print(json.dumps(dict(
        card=smi, part="generate", batch=16, prompt=128, new_tokens=new, wall_s=wall,
        tokens_per_s=16 * new / wall, ms_per_token=wall * 1e3 / new, prefill_ms=prefill_ms,
        per_step=_per(steps, new, step_ms, "K6", launches),
        prefill_device_ms=w_prefill["device_us"] / 1e3, prefill_device_ops=w_prefill["ops"],
        top_device_whole_call=[dict(name=k, ms=us / 1e3) for k, us in w_all["top"]],
    )), flush=True)


def part_bucketed(cfg, tree, args, smi):
    engine = dst.init_inference(TransformerLM(cfg), dtype="bf16",
                                paged_kv={"page_size": 16, "max_slots": 8, "ragged": False})
    engine.load_jax_params(tree)
    rs = np.random.default_rng(args.seed + 1)
    prompts = [rs.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in np.linspace(128, 512, 8).astype(int)]
    engine.serve([p[:64] for p in prompts], max_new_tokens=4)  # builds the server, warms the allocator
    server = engine._paged_server
    for p in prompts:
        server.submit(p, max_new_tokens=512)
    while any(r.pending is None for r in server._active) or len(server._active) < 8:
        server.step()

    def rounds():
        for _ in range(ROUNDS):
            server.step()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rounds()
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3 / ROUNDS
    s0 = dict(server.stats)
    before = da.launches_paged
    window = _profiled(rounds, _trace(args, "bucketed"))
    launches = da.launches_paged - before
    s1 = server.stats
    if s1["decode_steps"] - s0["decode_steps"] != ROUNDS or s1["prefill_chunks"] != s0["prefill_chunks"]:
        raise AssertionError("the profiled window was not pure decode rounds")
    print(json.dumps(dict(
        card=smi, part="bucketed", bucket=8, rounds=ROUNDS, tokens_per_s=8 / (round_ms / 1e3),
        per_round=_per(window, ROUNDS, round_ms, "K5", launches),
        top_device=[dict(name=k, ms_per_round=us / 1e3 / ROUNDS) for k, us in window["top"]],
    )), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default=None, help="write each profiled window's Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_profile: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    cfg = llama_config("1b")
    tree = init_params(cfg, args.seed)
    engine = dst.init_inference(TransformerLM(cfg), dtype="bf16")
    engine.load_jax_params(tree)
    part_generate(engine, cfg, args, smi)
    del engine
    torch.cuda.empty_cache()
    part_bucketed(cfg, tree, args, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
