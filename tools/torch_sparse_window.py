"""Where the time of chip_smoke's sparse-step window goes, on one card.

    python tools/torch_sparse_window.py [--repeats N] [--seed N] [--trace PATH]

chip_smoke's phase 14 times 10 sparse training steps (BertSparseSelfAttention
at BERT-large width, FixedDefault(16), bf16 [2, 4096, 1024]) as one window
from a synchronize to a synchronize. This script runs that phase ``--repeats``
times alone, then chip_smoke's phase 13 (the block-sparse kernel checks and
timings), then ``--repeats`` times again, then once with the garbage
collector off, once with the window under ``torch.profiler`` and once under
the allocator's history. Each run prints one JSON line: the window's ms per
step, its steps' host enqueue times and stream intervals, the garbage
collections and allocator calls inside it, and the live Python objects and
the allocator's reserved bytes before it. The profiled run adds the device
time and the top host ops of the window (``--trace`` writes its Chrome
trace); the history run adds the allocated and reserved bytes after each
step and each new segment the window asks the driver for, with its size and
the innermost frames of the port that asked.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="write the profiled window's Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sparse_window: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    windows, timed = [], cs._timed_window
    cs.emit = lambda **rec: windows.append(rec["window"]) if rec.get("phase") == "sparse_train" else None

    def run(label, window_fn=timed):
        objects, reserved = len(gc.get_objects()), torch.cuda.memory_reserved()
        cs._timed_window = window_fn
        t0 = time.perf_counter()
        try:
            cs.phase_sparse_train(args.seed, dev)
        finally:
            cs._timed_window = timed
        w = windows[-1]
        print(json.dumps(dict(
            card=smi, run=label, ms_per_step=w["ms_per_step"], host_ms_sum=sum(w["host_ms"]),
            host_ms=w["host_ms"], stream_ms_sum=sum(w["stream_ms"]), stream_ms=w["stream_ms"],
            gc=w["gc"], allocator=w["allocator"], live_objects=objects, reserved_bytes=reserved,
            phase_s=time.perf_counter() - t0, **w.get("profile", {}), **w.get("history", {}))), flush=True)

    def without_gc(step, n):
        gc.disable()
        try:
            return timed(step, n)
        finally:
            gc.enable()

    def profiled(step, n):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w = timed(step, n)
        if args.trace:
            prof.export_chrome_trace(args.trace)
        device_us, host = 0.0, []
        for evt in prof.key_averages():
            if str(getattr(evt, "device_type", "")).endswith("CUDA"):
                device_us += float(getattr(evt, "self_device_time_total", 0.0) or evt.self_cuda_time_total)
            else:
                host.append((evt.key, float(evt.self_cpu_time_total), evt.count))
        host.sort(key=lambda e: -e[1])
        w["profile"] = dict(device_ms_per_step=device_us / 1e3 / n,
                            top_host=[dict(name=k[:60], ms_per_step=us / 1e3 / n, calls_per_step=c / n)
                                      for k, us, c in host[:12]])
        return w

    def with_history(step, n):
        allocated, reserved = [], []

        def stepped():
            step()
            allocated.append(torch.cuda.memory_allocated())
            reserved.append(torch.cuda.memory_reserved())

        torch.cuda.memory._record_memory_history(stacks="python", max_entries=200_000)
        try:
            w = timed(stepped, n)
            snap = torch.cuda.memory._snapshot()
        finally:
            torch.cuda.memory._record_memory_history(enabled=None)
        segments = []
        for ev in snap["device_traces"][0]:
            if ev["action"] == "segment_alloc":
                frames = [f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}" for f in ev.get("frames", [])
                          if "deepspeed_tpu_torch" in f["filename"] or "chip_smoke" in f["filename"]]
                segments.append(dict(bytes=ev["size"], frames=frames[:4]))
        w["history"] = dict(allocated_after_step=allocated, reserved_after_step=reserved, new_segments=segments)
        return w

    for i in range(args.repeats):
        run(f"alone {i + 1}")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    cs.phase_sparse_kernels(dev, flush)
    print(json.dumps(dict(run="phase 13", seconds=time.perf_counter() - t0)), flush=True)
    del flush
    for i in range(args.repeats):
        run(f"after phase 13, {i + 1}")
    run("after phase 13, gc off", without_gc)
    run("after phase 13, profiled", profiled)
    run("after phase 13, allocator history", with_history)
    return 0


if __name__ == "__main__":
    sys.exit(main())
