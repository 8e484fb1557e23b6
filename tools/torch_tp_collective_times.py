#!/usr/bin/env python3
"""Latency of the tensor-parallel serving step's collectives on one card.

    python3 tools/torch_tp_collective_times.py [--iters N]

Two ranks share ``cuda:0`` over gloo (``deepspeed_tpu_torch.comm``), as
chip_smoke's phase 9h runs them, and time on the host clock, after a
warm-up, each collective a ragged step of llama-1B at tp = 2 makes: the
row all-reduce of one output chunk (bf16 ``[8, W, 1024]`` at a decode
step, W = 1, and a prefill step, W = 32), a pair of them issued
asynchronously (``TPServing.row_matmul``'s two chunks) and the argmax
gather of a decode step (fp32 ``[1, 2, 8]``). Prints one JSON line per
case from rank 0 with the median and mean ms. Not a TP speed: the two
ranks time-slice one card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import statistics
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rank(rank, store, iters):
    from deepspeed_tpu_torch import comm

    comm.init_distributed("gloo", init_method=f"file://{store}", rank=rank, world_size=2, timeout=120)
    dev = torch.device("cuda", 0)
    cases = {
        "all_reduce decode chunk bf16 [8, 1, 1024]": lambda: comm.all_reduce(
            torch.ones(8, 1, 1024, dtype=torch.bfloat16, device=dev)),
        "all_reduce prefill chunk bf16 [8, 32, 1024]": lambda: comm.all_reduce(
            torch.ones(8, 32, 1024, dtype=torch.bfloat16, device=dev)),
        "two async all_reduces, decode chunks": lambda: [w.wait() for w in [
            comm.all_reduce(torch.ones(8, 1, 1024, dtype=torch.bfloat16, device=dev), async_op=True)
            for _ in range(2)]],
        "argmax all_gather_into_tensor fp32 [1, 2, 8]": lambda: comm.all_gather_into_tensor(
            torch.empty(2, 2, 8, device=dev), torch.ones(1, 2, 8, device=dev)),
    }
    for name, fn in cases.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            comm.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if rank == 0:
            print(json.dumps(dict(case=name, iters=iters, median_ms=statistics.median(times),
                                  mean_ms=statistics.fmean(times))), flush=True)
    comm.barrier()
    comm.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(r, os.path.join(tmp, "store"), args.iters)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return max(p.exitcode != 0 for p in procs)


if __name__ == "__main__":
    sys.exit(main())
