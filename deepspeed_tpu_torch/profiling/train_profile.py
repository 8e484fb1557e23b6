"""Where the time of a training step goes, on one card.

    python -m deepspeed_tpu_torch.profiling.train_profile [--mode train|sparse] [--seed N] [--steps N]
        [--trace PATH]

``--mode train`` (the default) builds the training main path of
``chip_smoke.py`` (GPT-2 125M at full width, ``max_seq_len=1024``,
``remat=False``, bench.py config 1: bf16, ZeRO-1, Adam with weight decay
0.01, clipping 1.0, micro batch 8) from seeded random weights and one batch
placed on the card. ``--mode sparse`` builds its sparse main path instead:
``BertSparseSelfAttention`` at BERT-large width (16 heads of 64, its
default ``FixedDefault(16)`` layout) on bf16 hidden states [2, 4096, 1024],
``wq``, ``wk`` and ``wv`` with fp32 masters updated by ``FusedAdam.apply``
and cast to bf16 for each forward, MSE against a seeded target. Either runs
3 warm-up steps, then:

* ``steps``: ``--steps`` steps without the profiler, each timed on the host
  clock between two ``torch.cuda.synchronize()`` calls: ms per step, their
  median and spread, tokens/s;
* ``profile``: ``--steps`` more steps under ``torch.profiler`` (CPU and
  CUDA activities): device time per step (the sum of kernel and copy
  time), the device's idle share against the unprofiled step time
  (1 - device / step), device ops and the attention kernels' launches
  per step, device time by kernel (the flash kernels K1-K3, the
  block-sparse kernels K7-K9 and their tensor-core variants and second
  passes by name, the rest grouped), and the top host ops by self time.

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
import types

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import TransformerLM, bert_config, gpt2_config
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.sparse_attention import BertSparseSelfAttention
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

CONFIG = {  # bench.py:507-517, config 1
    "train_micro_batch_size_per_gpu": 8,
    "optimizer": {"type": "adam", "params": {"lr": 3e-4, "weight_decay": 0.01}},
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 1},
    "gradient_clipping": 1.0,
    "steps_per_print": 10_000,
}
# the FMA kernels, the tensor-core variants and their second passes, each by its own name
NAMED_KERNELS = ("flash_fwd_tc_kernel", "flash_dq_tc_kernel", "flash_dkv_tc_kernel", "flash_fwd_kernel",
                 "flash_dq_kernel", "flash_dkv_kernel", "sparse_fwd_tc_kernel", "sparse_fwd_merge_kernel",
                 "sparse_dq_tc_kernel", "sparse_dq_reduce_kernel", "sparse_dkv_tc_kernel", "sparse_dkv_reduce_kernel",
                 "sparse_fwd_kernel", "sparse_dq_kernel", "sparse_dkv_kernel")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _group(name: str) -> str:
    """Kernel families: the attention kernels (and their tensor-core
    variants) by name, GEMMs, the rest by their leading word."""
    for k in NAMED_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if any(t in low for t in ("gemm", "nvjet", "cutlass", "sm90_xmma", "ampere_", "cublas")):
        return "gemm"
    if "memcpy" in low or "memset" in low:
        return "copy/memset"
    return name.replace("(anonymous namespace)::", "").split("<")[0].split("(")[0][:60]


def _train(seed):
    """The GPT-2 training step: (step function, tokens a step, launch
    counters of K1-K3 and K2's tensor-core variant)."""
    cfg = gpt2_config("125m", max_seq_len=1024, remat=False)
    engine, _, _, _ = dst.initialize(model=TransformerLM(cfg), config=dict(CONFIG),
                                     model_parameters=init_params(cfg, seed))
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, cfg.max_seq_len + 1)).astype(np.int32)
    dev = engine.device
    batch = {"input_ids": torch.from_numpy(toks[:, :-1]).to(dev), "labels": torch.from_numpy(toks[:, 1:]).to(dev)}

    def step():
        loss = engine(batch)
        engine.backward(loss)
        engine.step()

    counters = lambda: dict(flash_fwd=fa.launches_fwd, flash_dq=fa.launches_dq, flash_dq_tc=fa.launches_dq_tc,  # noqa: E731
                            flash_dkv=fa.launches_dkv)
    return step, 8 * cfg.max_seq_len, counters


def _sparse(seed):
    """The block-sparse step of chip_smoke's phase 14: (step function,
    tokens a step, launch counters of K7-K9 and their tensor-core
    variants)."""
    cfg = bert_config("large")
    H, B, T = cfg.hidden_size, 2, 4096
    dev = torch.device("cuda", 0)
    rs = np.random.default_rng(seed + 4)
    hidden = torch.from_numpy(rs.standard_normal((B, T, H), dtype=np.float32)).to(dev).to(torch.bfloat16)
    target = torch.from_numpy(rs.standard_normal((B, T, H), dtype=np.float32)).to(dev)
    masters = {name: torch.from_numpy((0.02 * rs.standard_normal((H, H))).astype(np.float32)).to(dev)
               for name in ("wq", "wk", "wv")}
    attn = BertSparseSelfAttention(types.SimpleNamespace(num_attention_heads=cfg.num_heads, hidden_size=H))
    opt = FusedAdam(lr=1e-3)
    state = {"opt": opt.init_state(masters), "masters": masters}

    def step():
        ws = [m.to(torch.bfloat16).requires_grad_(True) for m in state["masters"].values()]
        loss = F.mse_loss(attn(hidden, *ws).float(), target)
        loss.backward()
        state["masters"], state["opt"] = opt.apply(dict(zip(state["masters"], [w.grad for w in ws])), state["opt"],
                                                   state["masters"], opt.defaults["lr"])

    counters = lambda: dict(block_sparse_fwd=bs.launches_fwd, block_sparse_fwd_tc=bs.launches_fwd_tc,  # noqa: E731
                            block_sparse_dq=bs.launches_dq, block_sparse_dq_tc=bs.launches_dq_tc,
                            block_sparse_dkv=bs.launches_dkv,
                            block_sparse_dkv_tc=bs.launches_dkv_tc)
    return step, B * T, counters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("train", "sparse"), default="train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trace", default=None, help="write the profiled window's Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_profile: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    step, tokens, counters = (_train if args.mode == "train" else _sparse)(args.seed)
    for _ in range(3):
        step()
    torch.cuda.synchronize()

    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = np.array(times)
    step_ms = float(np.median(ms))
    print(json.dumps(dict(card=smi, mode=args.mode, part="steps", steps=args.steps, ms_per_step=times,
                          median_ms=step_ms, q1_ms=float(np.percentile(ms, 25)), q3_ms=float(np.percentile(ms, 75)),
                          tokens_per_s=tokens / (step_ms / 1e3))), flush=True)

    before = counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in counters().items()}
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
        card=smi, mode=args.mode, part="profile", steps=n, profiled_wall_ms_per_step=wall * 1e3 / n,
        device_ms_per_step=device_ms, unprofiled_step_ms=step_ms,
        device_idle_share=1.0 - device_ms / step_ms, device_ops_per_step=ops / n,
        launches_per_step={k: v / n for k, v in launches.items()},
        by_kernel=sorted(({"kernel": k, "ms_per_step": us / 1e3 / n, "share": us / device_us if device_us else 0.0,
                           "calls_per_step": c / n} for k, (us, c) in groups.items()),
                         key=lambda e: -e["ms_per_step"])[:16],
        top_host=[dict(name=k[:60], ms_per_step=us / 1e3 / n, calls_per_step=c / n) for k, us, c in host[:10]],
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
