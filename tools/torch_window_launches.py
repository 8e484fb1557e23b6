#!/usr/bin/env python3
"""How reliably ``torch.profiler`` counts K4's kernels inside window replays.

    python3 tools/torch_window_launches.py [--seed N] [--passes N] [--pad-s S]

Builds chip_smoke.py's window engine (llama-1B at full width, bf16,
page_size 16, max_slots 8, ragged, multi-step windows of 8 rounds, seeded
random weights), serves the smoke request mix twice (the second pass finds
the window graph captured), then serves it ``--passes`` more times under
``torch.profiler`` (CUDA activity), alternating two ways of framing the
profiled region:

* ``bare``: the serve call and a synchronize, and nothing else, inside the
  profiler (as chip_smoke.py's phase 9b once profiled a whole serve pass;
  it now profiles two window steps);
* ``padded``: ``--pad-s`` seconds of host sleep before the serve call and
  after the synchronize, so no kernel runs near either edge of the
  profiler's capture window.

Each pass prints one JSON line: the device counts of K4's split and combine
kernels against 22 x (single steps + 8 x windows), the device event count,
the first and last device event's offset from the trace start and its end
(microseconds), and how many device events ran before the first K4 split
kernel and after the last K4 combine kernel. A pass that lost kernels at an
edge of the capture window shows a short edge gap and a count below the
expected one; a pass that lost them in the middle shows neither.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import deepspeed_tpu_torch as dst  # noqa: E402
from deepspeed_tpu_torch.models import TransformerLM, llama_config  # noqa: E402

SPLIT, COMBINE = chip_smoke.K4_KERNELS


def _pass(engine, prompts, budgets, pad_s: float) -> dict:
    before = engine.serve_stats()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        engine.serve(prompts, max_new_tokens=budgets)
        torch.cuda.synchronize()
        time.sleep(pad_s)
    after = engine.serve_stats()
    L = engine.module.config.num_layers
    want = L * (after["ragged_steps"] - before["ragged_steps"]
                + chip_smoke.HORIZON * (after["window_steps"] - before["window_steps"]))
    dev = sorted((e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")),
                 key=lambda e: e.time_range.start)
    names = [e.name for e in dev]
    splits = [i for i, n in enumerate(names) if SPLIT in n]
    combines = [i for i, n in enumerate(names) if COMBINE in n]
    end_us = max(e.time_range.end for e in dev) if dev else 0.0
    return dict(
        framing="padded" if pad_s else "bare", pad_s=pad_s, want=want,
        split=len(splits), combine=len(combines), device_events=len(dev),
        first_event_us=dev[0].time_range.start if dev else None, last_event_end_us=end_us,
        events_before_first_split=splits[0] if splits else None,
        events_after_last_combine=len(dev) - 1 - combines[-1] if combines else None,
        windows=after["window_steps"] - before["window_steps"],
        ragged_steps=after["ragged_steps"] - before["ragged_steps"],
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--pad-s", type=float, default=0.1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_window_launches: needs a CUDA card", file=sys.stderr)
        return 2
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    cfg = llama_config("1b")
    engine = dst.init_inference(TransformerLM(cfg), dtype="bf16", paged_kv=chip_smoke.WINDOWS)
    engine.load_jax_params(chip_smoke._weights(cfg, args.seed))
    prompts, budgets = chip_smoke._requests(args.seed, cfg.vocab_size)
    for _ in range(2):  # kernel build, capture, warm prefix cache
        engine.serve(prompts, max_new_tokens=budgets)
    rows = []
    for i in range(args.passes):
        rows.append(_pass(engine, prompts, budgets, args.pad_s if i % 2 else 0.0))
        print(json.dumps(dict(card=smi, **rows[-1])), flush=True)
    for framing in ("bare", "padded"):
        mine = [r for r in rows if r["framing"] == framing]
        print(json.dumps(dict(card=smi, framing=framing, passes=len(mine),
                              exact=sum(r["split"] == r["want"] == r["combine"] for r in mine))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
