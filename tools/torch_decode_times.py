"""K6's device time at chip_smoke's decode shapes, from one checkout, on one card.

    python tools/torch_decode_times.py [--root DIR] [--iters N] [--repeats N]

Imports ``chip_smoke`` and ``deepspeed_tpu_torch`` from ``--root`` (default:
this checkout), builds K6 from that checkout's sources, and times
``decode_attention_kernel`` at chip_smoke's ``DECODE_SHAPES`` (the llama-1B
generate shape and MHA 12/12) in fp32 and bf16 with chip_smoke's
``_time_ms`` (CUDA events, an L2 flush before each launch) on the same
seeded inputs as chip_smoke's phase 5, ``--repeats`` times each (the
median and every reading). Prints one JSON line beside the card's
``nvidia-smi`` name and power limit. To compare two versions of the
kernel, unpack one into a directory and run the script for each in turn in
one session on the card (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from deepspeed_tpu_torch.ops.transformer import decode_attention

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    rs = np.random.default_rng(2345)
    times = {}
    for label, (B, S, nh, nkv, d) in cs.DECODE_SHAPES.items():
        lens = np.linspace(0, S, B).astype(np.int32)
        q, k, v, lens_d = cs._decode_inputs(rs, B, S, nh, nkv, d, lens, dev)
        scale = 1.0 / np.sqrt(d)
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
            ref = decode_attention.decode_attention_plain(qd.float(), kd.float(), vd.float(), lens_d, scale)
            out = decode_attention.decode_attention_kernel(qd, kd, vd, lens_d, scale)
            err = (out.float() - ref).abs().max().item()
            ms = [cs._time_ms(lambda: decode_attention.decode_attention_kernel(qd, kd, vd, lens_d, scale),
                              args.iters, flush) for _ in range(args.repeats)]
            times[f"{label} {str(dtype).replace('torch.', '')}"] = {"ms_median": float(np.median(ms)), "ms": ms,
                                                                    "max_abs_err": err}
    print(json.dumps({"card": smi, "root": root, "k6": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
