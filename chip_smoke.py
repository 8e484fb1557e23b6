#!/usr/bin/env python3
"""Smoke run of deepspeed_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the package's CUDA kernels from ``deepspeed_tpu_torch/csrc`` and
drives the serving (single-step and multi-step windows), the training and
the block-sparse attention main paths at full width. Phases,
each printing JSON lines; any failure raises, and the script then exits
non-zero without the final line:

1. device: the card (``nvidia-smi`` name and power limit) and the kernel
   builds, one ``nvcc`` per source, all started together (nvcc time,
   ptxas register/shared-memory report);
2. the ragged paged-attention kernel (K4) against its plain PyTorch version
   at the serving shapes of llama-1B (R=8, NH=32, NKV=4, D=64, P=16,
   MAXP=128, NP=1025): a W=1 decode batch and a W=32 mixed batch, fp32 with
   TF32 off (max abs error <= 1e-4) and bf16 (<= 2e-2 against the plain
   version in fp32 on the same bf16 inputs); dead rows and window slots past
   q_len must be exact zeros, every call must run the split-KV kernel and its
   combine (``launches_ragged_split``; each case prints its split count), and
   two calls on the same inputs must be bitwise equal. Then kv_len on a split
   boundary and one key past it, a row with a single key in its last split,
   and D=128 with a GQA group of 7 and pages of 64 (correctness only).
   Times the kernel, the plain version and a yardstick
   (``scaled_dot_product_attention`` over K/V pre-gathered into a
   contiguous cache: it omits the page walk, and the port never calls it),
   each with the L2 cache flushed before every launch;
3. the main path: ``init_inference(TransformerLM(llama_config("1b")),
   dtype="bf16", paged_kv={"page_size": 16, "max_slots": 8})`` with seeded
   random weights loaded through ``load_jax_params``, serving 16 requests
   twice (cold, then warm with cached prefixes); the kernel's launch count
   is zeroed just before and read just after, and must equal
   22 × ``ragged_steps``, every call on the split-KV path. Then
   ``engine(tokens)`` once on that engine ([2, 256] tokens, model profiling
   on): the logits' shape, dtype, finiteness, ``model_times()`` entry and
   the launches of that call;
4. greedy-stream identity in fp32 (TF32 off): 4 requests × 32 tokens with
   ``attn_impl="kernel"`` against ``"plain"``; where streams part, the plain
   run's top-2 logit gap at that position must be below 1e-4;
5. the dense decode kernel (K6, split-KV) against its plain version at the
   generate shape of llama-1B (B=16, S=256, NH=32, NKV=4, D=64, ragged
   lengths with 0 and 256; fp32, bf16 and fp16) and an MHA shape
   (NH=NKV=12; fp32, bf16), fp32 with TF32 off (<= 1e-4) and bf16/fp16
   (<= 2e-2 against the plain version in fp32 on the same cast inputs),
   rows of length 0 exact zeros; timed beside its bound and a yardstick
   (``scaled_dot_product_attention`` with a length mask over the same
   cache), L2 flushed before every launch. Then (correctness only) a GQA
   group of 7 at D=128, and S=100 with kv_len on a 64-key split boundary,
   one past it, S and past S. Every call must run the split kernel and its
   combine (``launches_decode_split``), two calls on the same inputs must
   be bitwise equal, and each case prints its split count;
6. the paged decode kernel (K5, split-KV) the same way at the bucketed
   decode shape (bucket 8, llama-1B heads, P=16, MAXP=128, NP=1025, a dead
   row and -1 sentinels) and at bucket 1 (bf16, one row of 1500 keys),
   yardstick SDPA over pre-gathered K/V as for K4; and at D=128 with a
   group of 7 (correctness only). Every call must run the split kernel and
   its combine (``launches_paged_split``), two calls on the same inputs
   must be bitwise equal, and each case prints its split count;
7. the dense ``engine.generate`` path in bf16 on llama-1B: 16 prompts of 128
   tokens with 128 new (cache length 256), cold and warm, with
   ``profile_model_time``; K6 must launch 22 × 128 times per call and K4,
   K5 never. Then beam search (4 beams, 2 prompts of 224 tokens, 32 new):
   K6 = 22 × 32. Every K6 call on the split path;
8. the bucketed server (``paged_kv.ragged=False``) in bf16 on phase 3's
   traffic, cold and warm: 32 of 32 finished, K5 = 22 × ``decode_steps``,
   every K5 call on the split path, K4 never;
9. fp32 (TF32 off) stream identity of the three decode kernels: 4 prompts
   of 224 tokens, 32 new tokens each, through the ragged server (K4), the
   bucketed server (K5) and ``generate`` (K6, cache length 256); where two
   streams part, the plain top-2 logit gap must be below 1e-4. Beam search
   there too: the 4-beam answer's joint log-probability (rescored by a full
   fp32 forward) must be at least the greedy answer's less 1e-3. And the
   ragged server with multi-step windows (horizon 8, CUDA graph replays):
   its streams must equal the single-step ragged server's exactly;
9b. multi-step serving windows: phase 3's engine with
   ``paged_kv={"page_size": 16, "max_slots": 8, "ragged": True,
   "multi_step": {"enable": True, "horizon": 8}}`` in bf16 on phase 3's 16
   requests, cold then warm: every stream equal to phase 3's, windows
   formed, one CUDA graph captured, and K4's counter equal to 22 x
   ``ragged_steps`` + 2 x 22 x 8 x captures (a capture passes the wrapper
   for the warm-up's launch and for the graph's record; a replay never
   passes it), every other kernel 0. Then steady traffic, 8 requests of
   128 tokens with 128 new, on fresh servers in turns (single-step,
   windows, windows, single-step): streams equal, TPOT p50, tokens/s,
   windows, captures and replays, each window's host wall beside its
   replay's device time (CUDA events at every replay, from
   ``serve_stats()["window_device_ms"]``) and the window's idle share,
   with the same counter accounting. Last, a fifth server on the steady
   traffic runs two steps after its capture under ``torch.profiler``,
   which counts K4's split and combine kernels on the device, those
   inside the replays included: each must equal 22 x (``ragged_steps`` +
   8 x ``window_steps``) of those steps and K4's counter 22 x
   ``ragged_steps``; the server then runs to its end with its streams
   equal to the single-step server's;
10. the flash attention kernels K1 (forward), K2 (dQ) and K3 (dK, dV)
   against their plain versions at the training shape (B=8, T=1024, N=12,
   D=64, causal), a ragged T=200, a non-causal T=256 and D=128 (B=1,
   T=2048, N=32): O, LSE, dQ, dK and dV, fp32 with TF32 off (O and LSE
   within 1e-4, each gradient within 1e-3 of the reference's largest
   magnitude) and bf16 against the plain versions in fp32 on the same bf16
   inputs (O within 2e-2, each gradient within 3e-2 of that magnitude),
   and fp16 at the training shape within bf16's bounds. K1, K2 and K3 must
   take their tensor-core variants in bf16 and fp16 and their FMA variants
   in fp32 (``launches_fwd_tc``, ``launches_dq_tc``, ``launches_dkv_tc``);
   two bf16 K2 calls on the same inputs must give a bitwise-equal dQ. At
   the training shape it times each kernel, its
   plain version and a yardstick (``scaled_dot_product_attention(
   is_causal=True)`` for K1, and its autograd backward for K2 and K3
   together; the port never calls either), L2 flushed before every launch,
   beside its bound, with the yardstick's share of the kernel's time;
11. the training main path: ``initialize(TransformerLM(gpt2_config("125m",
   max_seq_len=1024, remat=False)), config=<bench.py config 1>)`` (bf16,
   ZeRO-1, Adam with weight decay 0.01, clipping 1.0, micro batch 8) with
   seeded random weights in the JAX tree layout; one ``RandomState(0)``
   batch of ``[8, 1025]`` tokens placed once; 3 warm-up and 20 timed steps
   of ``engine(batch)``, ``backward``, ``step``. The flash launch counts
   are zeroed just before and each must equal 12 × 23 just after, every K1,
   K2 and K3 launch on the tensor-core variant; every loss must be finite and
   the last below the first. Prints tokens/s, ms per step, MFU by bench.py's
   formula and peak device memory;
12. the same model in fp32 (TF32 off) for 3 steps, once through the
   kernels (K1's, K2's and K3's FMA variants) and once with
   ``attn_impl="plain"``: step 1's loss and grad norm within 1e-5 relative
   and identical to the last bit;
13. the block-sparse kernels K7 (forward), K8 (dQ) and K9 (dK, dV)
   against their plain versions: the main case at BERT-large widths (B=2,
   16 heads of 64, T=4096, ``FixedSparsityConfig(num_heads=16, block=16)``,
   bidirectional, shared layout), the bench case of
   ``tests/perf/block_sparse_bench.py`` (B=1, NH=8, T=8192, D=64,
   ``BSLongformerSparsityConfig(block=64)``, causal), a per-head BigBird
   layout (one launch per head), a causal Fixed layout, the dead-rows
   layout of ``tests/unit/ops/test_pallas_block_sparse.py`` (exact zeros in
   O and dQ), blocks of 8 and 128, and a layout whose key block 3 has no
   live pair (exact zeros in its dK and dV); fp32 with TF32 off (O and LSE
   within 1e-4, each gradient within 1e-3 of the reference's largest
   magnitude) and bf16 against the plain versions in fp32 on the same bf16
   inputs (O within 2e-2, each gradient within 3e-2 of that magnitude). K7,
   K8 and K9 must take their tensor-core variants in bf16 and their FMA
   variants in fp32 (``launches_fwd_tc``, ``launches_dq_tc``,
   ``launches_dkv_tc``); K7 and K8 run in fp16 too (O and LSE within 2e-2,
   dQ within 3e-2 of its largest magnitude, dead rows exact zeros, every
   call on the tensor cores; timed at the main and bench shapes). At the
   main and bench shapes two bf16 K7 calls must give bitwise-equal O and
   LSE, two K8 calls a bitwise-equal dQ and two K9 calls bitwise-equal dK
   and dV. K8 must keep dS in fp32: on keys within 0.03 of one shared
   vector a head, where rounding dS to the operand dtype would move dQ some
   30 times the output rounding, dQ within 1.5e-2 (bf16) or 3e-3 (fp16) of
   its largest magnitude, a bound the plain version with dS rounded must
   exceed. It times each kernel, its plain
   version, its bound, a yardstick (``scaled_dot_product_attention`` with
   the layout expanded to an element mask, and its autograd backward for
   K8 and K9 together; the port never calls either, with its share of the
   kernel's time) and the port's dense K1-K3 at the same shape, L2 flushed
   before every launch; K7's, K8's and K9's lines carry their units, split
   q or key blocks and fp32 workspace bytes;
14. the sparse main path: ``BertSparseSelfAttention`` at BERT-large width
   (its default ``FixedDefault(16)`` layout) on bf16 hidden states [2,
   4096, 1024], ``wq``, ``wk`` and ``wv`` with fp32 masters updated by
   ``FusedAdam.apply`` and cast to bf16 for each forward, MSE against a
   seeded target, 3 warm-up and 10 timed steps enqueued back to back and
   timed as one window from a synchronize to a synchronize (ms per step and
   tokens/s over the whole window). Beside them, for a reading that
   strays: each step's host enqueue time, each step's interval on the
   card's stream (CUDA events between steps, no synchronize), the garbage
   collections and the allocator's cudaMalloc / cudaFree calls and retries
   inside the window.
   The counts are zeroed just
   before and each of K7-K9 must equal 13 just after, every other kernel 0,
   every K7, K8 and K9 call on the tensor-core variant; every loss finite and the last
   below the first. Then one fp32 step
   (TF32 off) through the kernels and through ``impl="plain"`` (loss within
   1e-5 relative, gradients within 1e-3 of their largest magnitude), and one
   call with a ``key_padding_mask``, which takes the emulation by JAX's rule
   with no K7 launch.

The line before the last is ``{"kernels": [...]}`` (K1-K3 and K7-K9 with
their ``variant`` by dtype and the main path's tensor-core launches, K1-K3,
K7 and K8 with their fp16 times; K4, K5 and K6 with their split counts and
split-KV launches, K4 with phase 9b's window numbers); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import gc
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
from deepspeed_tpu_torch.inference import decode
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.models import TransformerLM, bert_config, gpt2_config, llama_config
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.ops import native
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.sparse_attention import (
    BertSparseSelfAttention,
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    FixedSparsityConfig,
)
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse import build_block_tables
from deepspeed_tpu_torch.ops.transformer import decode_attention
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer.paged_attention import paged_decode_attention, ragged_paged_attention

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}  # tensor cores; fp32 without TF32
GARBAGE = 3.0e4  # finite in fp32 and bf16: pages past kv_len and page 0 hold it
R, NH, NKV, D, P, MAXP, NP = 8, 32, 4, 64, 16, 128, 1025


def emit(**obj):
    print(json.dumps(obj, default=lambda o: o.item() if hasattr(o, "item") else str(o)), flush=True)


# --- phase 2: the kernel against its plain version --------------------------
def _batch(rs, W, rows, dev, nh=NH, nkv=NKV, d=D, p=P, maxp=MAXP, np_=NP):
    """q [R, W, NH, D] and pools [NP, NKV, P, D] in fp32, every pool slot
    garbage except the live positions of each row's pages; tables of
    distinct random pages ending in -1 sentinels. ``rows`` is a list of
    (kv_len, q_len)."""
    kv_lens = np.array([r[0] for r in rows], np.int32)
    q_lens = np.array([r[1] for r in rows], np.int32)
    kp = np.full((np_, nkv, p, d), GARBAGE, np.float32)
    kp[1::2] = -GARBAGE
    vp = -kp
    pt = np.full((len(rows), maxp), -1, np.int32)
    free = rs.permutation(np.arange(1, np_))
    used = 0
    for r, (kv_len, _) in enumerate(rows):
        n = -(-kv_len // p)
        pt[r, :n] = free[used : used + n]
        used += n
        for i in range(n):
            live = min(p, kv_len - i * p)
            kp[pt[r, i], :, :live] = rs.standard_normal((nkv, live, d))
            vp[pt[r, i], :, :live] = rs.standard_normal((nkv, live, d))
    q = rs.standard_normal((len(rows), W, nh, d)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(q), t(kp), t(vp), t(pt), t(kv_lens), t(q_lens)


def _compare(label, args, scale, dtype, tol):
    """Run the kernel on ``args`` cast to ``dtype`` and hold it against the
    plain version in fp32 on the same (cast) inputs; raises past ``tol``,
    on a non-finite live slot, on a dead row or a slot past ``q_len`` that
    is not exact zeros, or when the call did not run the split-KV kernel
    and its combine. Returns (max abs error on live slots, the cast inputs,
    the split count)."""
    q, kp, vp, pt, kv_lens, q_lens = args
    qd, kd, vd = q.to(dtype), kp.to(dtype), vp.to(dtype)
    ref = ragged_paged_attention(qd.float(), kd.float(), vd.float(), pt, kv_lens, q_lens, scale=scale,
                                 impl="plain")
    before = decode_attention.launches_ragged_split
    out = ragged_paged_attention(qd, kd, vd, pt, kv_lens, q_lens, scale=scale, impl="kernel")
    torch.cuda.synchronize()
    live = torch.arange(q.shape[1], device=q.device)[None, :] < q_lens[:, None]  # [R, W]
    err = (out.float() - ref).abs()[live].max().item()
    dead_zero = bool((out[~live] == 0).all().item())
    finite = bool(torch.isfinite(out.float()[live]).all().item())
    split = decode_attention.launches_ragged_split - before
    if not (err <= tol and dead_zero and finite and split == 1):
        raise AssertionError(f"K4 {label} {dtype}: max_abs_err {err} (tol {tol}), dead rows and slots zero "
                             f"{dead_zero}, finite {finite}, split-KV calls {split}")
    return err, (qd, kd, vd, pt, kv_lens, q_lens), decode_attention.ragged_splits(pt.shape[1], kp.shape[2])


def _bitwise_repeat(label, cast, scale):
    """Two K4 calls on the same inputs: bitwise-equal outputs (the combine
    merges the partials in split order, without atomics)."""
    runs = [ragged_paged_attention(*cast, scale=scale, impl="kernel") for _ in range(2)]
    torch.cuda.synchronize()
    bits = torch.int32 if runs[0].dtype == torch.float32 else torch.int16
    equal = torch.equal(runs[0].view(bits), runs[1].view(bits))
    emit(phase="kernel_determinism", kernel="ragged_paged_attention", case=label, bitwise_equal=equal)
    if not equal:
        raise AssertionError(f"K4 {label}: two calls on the same inputs differ")
    return equal


def _bound(q, pt, kv_lens, q_lens, dtype):
    """Least time for this call: max(bytes / HBM rate, flops / peak). Bytes:
    q and the output once, the page-table row entries and lengths, and the
    K and V of every live page (whole pages, as the pool stores them).
    Flops: 4·D per (query head, visible key) for QK^T and P·V."""
    item = torch.tensor([], dtype=dtype).element_size()
    kv_lens = kv_lens.cpu().numpy().astype(np.int64)
    q_lens = q_lens.cpu().numpy().astype(np.int64)
    pages = -(-kv_lens // P)
    nbytes = 2 * q.numel() * item + 2 * int(pages.sum()) * NKV * P * D * item
    nbytes += 4 * (int(pages.sum()) + 2 * R)
    visible = 0
    for kv_len, q_len in zip(kv_lens, q_lens):
        start = kv_len - q_len
        visible += sum(min(start + w + 1, kv_len) for w in range(q_len))
    flops = 4 * D * NH * visible
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def _time_ms(fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` launches, each after an
    L2 flush (a layer's pages are cold when the serving step reaches them)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _sdpa_inputs(q, kp, vp, pt, kv_lens, q_lens):
    """q [R, NH, W, D], K/V gathered into a contiguous [R, NKV, S, D] cache,
    and the boolean mask of the same causal + length rule."""
    rows, W = q.shape[:2]
    idx = pt.long().clamp(0, NP - 1)
    kc = kp[idx].permute(0, 2, 1, 3, 4).reshape(rows, NKV, MAXP * P, D).contiguous()
    vc = vp[idx].permute(0, 2, 1, 3, 4).reshape(rows, NKV, MAXP * P, D).contiguous()
    kv_pos = torch.arange(MAXP * P, device=q.device)
    q_pos = (kv_lens - q_lens)[:, None] + torch.arange(W, device=q.device)[None, :]
    mask = (kv_pos[None, None, :] <= q_pos[:, :, None]) & (kv_pos[None, None, :] < kv_lens[:, None, None])
    return q.transpose(1, 2).contiguous(), kc, vc, mask[:, None]


def phase_kernel(dev, flush):
    rs = np.random.default_rng(1234)
    scale = 1.0 / np.sqrt(D)
    batches = {
        "W=1": (1, [(1, 1), (17, 1), (300, 1), (511, 1), (1024, 1), (1500, 1), (2047, 1), (2048, 1)]),
        # chunk at 0, chunk mid-sequence, partial chunk (q_len 7), decode rows,
        # a dead row, a chunk ending at max_seq_len
        "W=32": (32, [(32, 32), (1032, 32), (71, 7), (2048, 1), (513, 1), (0, 0), (2048, 32), (1, 1)]),
    }
    cases = []
    for label, (W, rows) in batches.items():
        args = _batch(rs, W, rows, dev)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            err, cast, splits = _compare(label, args, scale, dtype, tol)
            bitwise = _bitwise_repeat(f"{label} {str(dtype).replace('torch.', '')}", cast, scale)
            ms = _time_ms(lambda: ragged_paged_attention(*cast, scale=scale, impl="kernel"), 50, flush)
            plain_ms = _time_ms(lambda: ragged_paged_attention(*cast, scale=scale, impl="plain"), 20, flush)
            sq, sk, sv, mask = _sdpa_inputs(*cast)
            library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, scale=scale, enable_gqa=True), 50, flush)
            q, _, _, pt, kv_lens, q_lens = args
            bound_ms, bound_by, nbytes, flops = _bound(q, pt, kv_lens, q_lens, dtype)
            case = dict(case=f"{label} {str(dtype).replace('torch.', '')}", max_abs_err=err, tol=tol,
                        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by, bytes=nbytes, flops=flops, roofline_share=bound_ms / ms,
                        library_share=library_ms / ms, splits=splits, bitwise_equal=bitwise)
            emit(phase="kernel", kernel="ragged_paged_attention", dead_rows_and_slots_exact_zero=True, **case,
                 launches_ragged_split=decode_attention.launches_ragged_split,
                 library="scaled_dot_product_attention over pre-gathered contiguous K/V (omits the page walk)")
            cases.append(case)
    # split boundaries (correctness only; 16 splits of 128 keys at MAXP=128, P=16): kv_len on a
    # boundary and one key past it (decode rows, and 8-token chunks that end on or cross one), a row
    # with a single key in its last split, a full row, a partial chunk, a dead row
    rows = [(128, 1), (129, 1), (1024, 8), (1025, 8), (1921, 1), (2048, 8), (5, 3), (0, 0)]
    args = _batch(rs, 8, rows, dev)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        err, _, splits = _compare("split boundaries", args, scale, dtype, tol)
        emit(phase="kernel", kernel="ragged_paged_attention", case=f"split boundaries W=8 {dtype}", rows=rows,
             max_abs_err=err, tol=tol, splits=splits, dead_rows_and_slots_exact_zero=True,
             launches_ragged_split=decode_attention.launches_ragged_split)
    # beyond the main path's shapes (correctness only): head_dim 128, a GQA
    # group of 7, pages of 64 keys across the kernel's 64-key tiles
    other = dict(nh=28, nkv=4, d=128, p=64, maxp=8, np_=24)
    args = _batch(rs, 5, [(300, 1), (70, 5), (0, 0), (5, 5), (129, 3)], dev, **other)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        err, _, splits = _compare("D=128 Hg=7 P=64", args, 1.0 / np.sqrt(128), dtype, tol)
        emit(phase="kernel", kernel="ragged_paged_attention", case=f"D=128 Hg=7 P=64 W=5 {dtype}",
             max_abs_err=err, tol=tol, splits=splits, dead_rows_and_slots_exact_zero=True,
             launches_ragged_split=decode_attention.launches_ragged_split)
    return cases


# --- phase 3: the serving main path ------------------------------------------
def _weights(cfg, seed):
    """The JAX tree layout as numpy with the distributions of the JAX
    ``TransformerLM.init`` (normal std 0.02, output projections
    0.02/sqrt(2L), norm scales 1, biases 0), from
    ``numpy.random.default_rng(seed)``."""
    return init_params(cfg, seed)


def _requests(seed, vocab):
    """16 prompts of 64..512 tokens, the 8 longest (302..512) opening with
    one shared 128-token prefix; budgets 32..128."""
    rs = np.random.default_rng(seed)
    shared = rs.integers(0, vocab, 128, dtype=np.int32)
    lens = np.linspace(64, 512, 16).astype(int)
    prompts = []
    for i, n in enumerate(lens):
        if i >= 8:
            prompts.append(np.concatenate([shared, rs.integers(0, vocab, n - 128, dtype=np.int32)]))
        else:
            prompts.append(rs.integers(0, vocab, n, dtype=np.int32))
    budgets = [int(b) for b in np.linspace(32, 128, 16).astype(int)[rs.permutation(16)]]
    return prompts, budgets


def phase_serve(cfg, tree, seed):
    model = TransformerLM(cfg)
    engine = dst.init_inference(model, dtype="bf16", paged_kv={"page_size": 16, "max_slots": 8})
    t0 = time.perf_counter()
    engine.load_jax_params(tree)
    torch.cuda.synchronize()
    emit(phase="serve", event="weights_loaded", seconds=time.perf_counter() - t0,
         params=sum(p.numel() for p in model.parameters()))
    prompts, budgets = _requests(seed, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # counts from here are the serving main path's
    passes, streams = [], {}
    for name in ("cold", "warm"):
        before = engine.serve_stats() or {"prefix": {"prefix_hit_tokens": 0, "prefix_query_tokens": 0},
                                          "ragged_steps": 0}
        t0 = time.perf_counter()
        outs = streams[name] = engine.serve(prompts, max_new_tokens=budgets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = engine.serve_stats()
        for p, b, o in zip(prompts, budgets, outs):
            if o is None or o.shape != (p.size + b,) or not (o[: p.size] == p).all() \
                    or o.min() < 0 or o.max() >= cfg.vocab_size:
                raise AssertionError(f"serve {name}: malformed output for a {p.size}-token prompt")
        gen = sum(budgets)
        hit = s["prefix"]["prefix_hit_tokens"] - before["prefix"]["prefix_hit_tokens"]
        query = s["prefix"]["prefix_query_tokens"] - before["prefix"]["prefix_query_tokens"]
        rec = dict(phase="serve", pass_=name, requests=len(outs), generated_tokens=gen, wall_s=wall,
                   tokens_per_s=gen / wall, ragged_steps=s["ragged_steps"] - before["ragged_steps"],
                   prefix_hit_rate=hit / query if query else 0.0)
        emit(**rec)
        passes.append(rec)
    counts, split = _counts(), decode_attention.launches_ragged_split
    launches = counts["ragged_paged_attention"]
    s = engine.serve_stats()
    summary = dict(phase="serve", pass_="both", ttft_ms=s["ttft_ms"], tpot_ms=s["tpot_ms"],
                   ragged_steps=s["ragged_steps"], finished=s["finished"], preempted=s["preempted"],
                   prefix=s["prefix"], k4_launches=launches, k4_split_launches=split,
                   num_pages=engine._paged_server.pool.num_pages,
                   kv_pool_bytes=engine._paged_server.pool.cache.hbm_bytes(),
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
    emit(**summary)
    if s["finished"] != 32 or passes[1]["prefix_hit_rate"] <= 0:
        raise AssertionError(f"serve: finished {s['finished']} of 32, warm prefix hit rate {passes[1]['prefix_hit_rate']}")
    if launches != cfg.num_layers * s["ragged_steps"] or launches == 0 or sum(counts.values()) != launches:
        raise AssertionError(f"K4 launches {launches} != {cfg.num_layers} x ragged_steps {s['ragged_steps']}")
    if split != launches:
        raise AssertionError(f"serve: {split} of {launches} K4 calls ran the split-KV kernel and combine, want all")
    phase_forward(engine, cfg, seed)
    del engine, model
    torch.cuda.empty_cache()
    return launches, split, streams


def phase_forward(engine, cfg, seed):
    """``engine(tokens)`` once on the serving engine with model profiling on:
    the logits' shape, dtype and finiteness, the ``model_times()`` entry and
    the launches of that call (the CPU tests hold the values against the JAX
    engine's forward)."""
    tokens = torch.from_numpy(np.random.default_rng(seed + 5).integers(0, cfg.vocab_size, (2, 256),
                                                                         dtype=np.int32)).cuda()
    engine.profile_model_time()
    before = _counts()
    logits = engine(tokens)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
    times = engine.model_times()
    finite = bool(torch.isfinite(logits.float()).all().item())
    emit(phase="forward", call="engine(tokens)", tokens=list(tokens.shape), logits_shape=list(logits.shape),
         logits_dtype=str(logits.dtype).replace("torch.", ""), model_times_s=times, launches=got, finite=finite)
    if logits.shape != (2, 256, cfg.vocab_size) or logits.dtype != torch.bfloat16 or not finite or len(times) != 1:
        raise AssertionError(f"forward: logits {tuple(logits.shape)} {logits.dtype}, finite {finite}, "
                             f"model_times {times}")


# --- phase 4: fp32 greedy-stream identity ------------------------------------
def _top2_gap(cfg, tree_t, context, dev):
    """Top-2 logit gap of the plain path at the position after ``context``
    (one prefill row over a fresh pool)."""
    n = context.size
    pages = -(-n // P)
    maxp = -(-cfg.max_seq_len // P)
    shape = (cfg.num_layers, pages + 1, cfg.num_kv_heads, P, cfg.head_dim)
    kp = torch.zeros(shape, dtype=torch.float32, device=dev)
    vp = torch.zeros_like(kp)
    pt = torch.full((1, maxp), -1, dtype=torch.int32, device=dev)
    pt[0, :pages] = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)
    tokens = torch.from_numpy(context.astype(np.int32))[None].to(dev)
    positions = torch.arange(n, dtype=torch.int32, device=dev)[None]
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    with torch.no_grad():
        logits = decode._paged_forward(cfg, tree_t, tokens, kp, vp, pt, positions, "plain",
                                       write_valid=positions < n, kv_lens=lens, q_lens=lens)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def phase_streams(cfg, tree, seed, dev):
    model = TransformerLM(cfg)
    paged = {"page_size": 16, "max_slots": 8}
    kernel = dst.init_inference(model, dtype="fp32", paged_kv=dict(paged, attn_impl="kernel"))
    kernel.load_jax_params(tree)
    plain = dst.init_inference(model, dtype="fp32", paged_kv=dict(paged, attn_impl="plain"))
    rs = np.random.default_rng(seed + 1)
    prompts = [rs.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in (40, 100, 200, 333)]
    before = decode_attention.launches
    outs_k = kernel.serve(prompts, max_new_tokens=32)
    if decode_attention.launches == before:
        raise AssertionError("the kernel arm never launched the kernel")
    mid = decode_attention.launches
    outs_p = plain.serve(prompts, max_new_tokens=32)
    if decode_attention.launches != mid:
        raise AssertionError("the plain arm launched the kernel")
    partings = []
    for i, (a, b) in enumerate(zip(outs_k, outs_p)):
        if a.shape != b.shape:
            raise AssertionError(f"stream {i}: shapes {a.shape} vs {b.shape}")
        diff = np.nonzero(a != b)[0]
        if diff.size:
            at = int(diff[0])
            gap = _top2_gap(cfg, model.param_tree(), b[:at], dev)
            partings.append({"request": i, "position": at, "plain_top2_gap": gap})
            if gap >= 1e-4:
                raise AssertionError(f"stream {i} parts at {at} with plain top-2 gap {gap} >= 1e-4")
    emit(phase="streams", dtype="float32", requests=len(prompts), new_tokens=32,
         identical=sum(1 for a, b in zip(outs_k, outs_p) if np.array_equal(a, b)), partings=partings)


# --- phases 5 and 6: the decode kernels against their plain versions ----------
def _decode_bound(lens, nh, nkv, d, dtype, extra_bytes=0):
    """Least time of one single-token call: max(bytes / HBM rate, flops /
    peak). Bytes: q and the output once, the live K and V rows once
    (``extra_bytes`` adds what else the call must read: K5's whole live
    pages beyond the live rows and its table entries), the lengths. Flops:
    4·D per (query head, live key) for QK^T and P·V."""
    item = torch.tensor([], dtype=dtype).element_size()
    live = int(np.asarray(lens, np.int64).sum())
    nbytes = 2 * len(lens) * nh * d * item + 2 * live * nkv * d * item + 4 * len(lens) + extra_bytes
    flops = 4 * d * nh * live
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


DECODE_SHAPES = {  # name: (B, S, NH, NKV, D)
    "generate B=16 S=256 NH=32 NKV=4 D=64": (16, 256, 32, 4, 64),
    "MHA B=16 S=256 NH=NKV=12 D=64": (16, 256, 12, 12, 64),
}
DECODE_MAIN = "generate B=16 S=256 NH=32 NKV=4 D=64"
# correctness only, (B, S, NH, NKV, D, kv_lens): a GQA group of 7 at D=128, and S=100 (not a multiple of the
# 64-key split) with kv_len on a split boundary, one past it, S and past S (clamped to S)
DECODE_EXTRA = {
    "Hg=7 D=128 S=256": (5, 256, 28, 4, 128, [1, 64, 65, 200, 256]),
    "S=100 kv_len>S": (6, 100, 32, 4, 64, [0, 1, 64, 65, 100, 150]),
}


def _decode_check(label, args, scale, dtype, tol):
    """K6 on ``args`` (q, k, v in fp32, kv_lens) cast to ``dtype`` against the
    plain version in fp32 on the same (cast) inputs; raises past ``tol``, on
    a non-finite value, on a dead row that is not exact zeros, when a call
    did not run the split kernel and its combine, or when a second call on
    the same inputs is not bitwise equal. Returns (max abs error, the cast
    inputs, the split count)."""
    q, k, v, lens_d = args
    qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
    ref = decode_attention.decode_attention_plain(qd.float(), kd.float(), vd.float(), lens_d, scale)
    before = decode_attention.launches_decode_split
    out = decode_attention.decode_attention_kernel(qd, kd, vd, lens_d, scale)
    again = decode_attention.decode_attention_kernel(qd, kd, vd, lens_d, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    dead_zero = bool((out[lens_d == 0] == 0).all().item())
    finite = bool(torch.isfinite(out.float()).all().item())
    split = decode_attention.launches_decode_split - before
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    equal = torch.equal(out.view(bits), again.view(bits))
    splits = decode_attention.dense_splits(k.shape[1])
    dt = str(dtype).replace("torch.", "")
    emit(phase="kernel_determinism", kernel="decode_attention", case=f"{label} {dt}", bitwise_equal=equal,
         splits=splits)
    if not (err <= tol and dead_zero and finite and split == 2 and equal):
        raise AssertionError(f"K6 {label} {dt}: max_abs_err {err} (tol {tol}), dead rows zero {dead_zero}, "
                             f"finite {finite}, split-KV calls {split} of 2, bitwise equal {equal}")
    return err, (qd, kd, vd, lens_d), splits


def _decode_inputs(rs, B, S, nh, nkv, d, lens, dev):
    q = torch.from_numpy(rs.standard_normal((B, nh, d), dtype=np.float32)).to(dev)
    k, v = (torch.from_numpy(rs.standard_normal((B, S, nkv, d), dtype=np.float32)).to(dev) for _ in range(2))
    return q, k, v, torch.from_numpy(np.asarray(lens, np.int32)).to(dev)


def phase_decode_kernel(dev, flush):
    rs = np.random.default_rng(2345)
    cases = []
    for label, (B, S, nh, nkv, d) in DECODE_SHAPES.items():
        lens = np.linspace(0, S, B).astype(np.int32)  # 0 .. S, ragged
        args = _decode_inputs(rs, B, S, nh, nkv, d, lens, dev)
        scale = 1.0 / np.sqrt(d)
        dtypes = ((torch.float32, 1e-4), (torch.bfloat16, 2e-2), (torch.float16, 2e-2))
        for dtype, tol in dtypes if label == DECODE_MAIN else dtypes[:2]:
            err, cast, splits = _decode_check(label, args, scale, dtype, tol)
            qd, kd, vd, lens_d = cast
            ms = _time_ms(lambda: decode_attention.decode_attention_kernel(qd, kd, vd, lens_d, scale), 50, flush)
            plain_ms = _time_ms(lambda: decode_attention.decode_attention_plain(qd, kd, vd, lens_d, scale), 20, flush)
            sq, sk, sv = qd[:, :, None], kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
            mask = (torch.arange(S, device=dev)[None, :] < lens_d[:, None])[:, None, None]
            library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, scale=scale, enable_gqa=True), 50, flush)
            bound_ms, bound_by, nbytes, flops = _decode_bound(lens, nh, nkv, d, dtype)
            case = dict(case=f"{label} {str(dtype).replace('torch.', '')}", max_abs_err=err, tol=tol, ms=ms,
                        plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                        bytes=nbytes, flops=flops, roofline_share=bound_ms / ms, library_share=library_ms / ms,
                        splits=splits, bitwise_equal=True)
            emit(phase="decode_kernel", kernel="decode_attention", dead_rows_exact_zero=True, **case,
                 launches_decode_split=decode_attention.launches_decode_split,
                 library="scaled_dot_product_attention with a length mask over the same cache")
            cases.append(case)
    for label, (B, S, nh, nkv, d, lens) in DECODE_EXTRA.items():
        args = _decode_inputs(rs, B, S, nh, nkv, d, lens, dev)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2), (torch.float16, 2e-2)):
            err, _, splits = _decode_check(label, args, 1.0 / np.sqrt(d), dtype, tol)
            emit(phase="decode_kernel", kernel="decode_attention", case=f"{label} {dtype}", kv_lens=lens,
                 max_abs_err=err, tol=tol, splits=splits, dead_rows_exact_zero=True,
                 launches_decode_split=decode_attention.launches_decode_split)
    return cases


PAGED_ROWS = [(1, 1), (17, 1), (300, 1), (0, 0), (1024, 1), (1500, 1), (2047, 1), (2048, 1)]


def _paged_compare(label, args, scale, dtype, tol):
    """K5 on ``args`` (``_batch`` at W=1) cast to ``dtype`` against the plain
    version in fp32 on the same (cast) inputs; raises past ``tol``, on a
    non-finite live row, on a dead row that is not exact zeros, when the
    call did not run the split-KV kernel and its combine, or when a second
    call on the same inputs is not bitwise equal. Returns (max abs error,
    the cast inputs, the split count)."""
    q, kp, vp, pt, kv_lens, _ = args
    qd, kd, vd = q[:, 0].to(dtype), kp.to(dtype), vp.to(dtype)
    ref = paged_decode_attention(qd.float(), kd.float(), vd.float(), pt, kv_lens, scale=scale, impl="plain")
    before = decode_attention.launches_paged_split
    out = paged_decode_attention(qd, kd, vd, pt, kv_lens, scale=scale, impl="kernel")
    again = paged_decode_attention(qd, kd, vd, pt, kv_lens, scale=scale, impl="kernel")
    torch.cuda.synchronize()
    live = kv_lens > 0
    err = (out.float() - ref).abs()[live].max().item()
    dead_zero = bool((out[~live] == 0).all().item())
    finite = bool(torch.isfinite(out.float()[live]).all().item())
    split = decode_attention.launches_paged_split - before
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    equal = torch.equal(out.view(bits), again.view(bits))
    splits = decode_attention.paged_splits(pt.shape[1], kp.shape[2])
    emit(phase="kernel_determinism", kernel="paged_decode_attention", case=f"{label} {dtype}", bitwise_equal=equal,
         splits=splits)
    if not (err <= tol and dead_zero and finite and split == 2 and equal):
        raise AssertionError(f"K5 {label} {dtype}: max_abs_err {err} (tol {tol}), dead rows zero "
                             f"{dead_zero}, finite {finite}, split-KV calls {split} of 2, bitwise equal {equal}")
    return err, (qd, kd, vd, pt, kv_lens), splits


def _paged_bound(kv_lens, dtype):
    """K5's bound at the serving heads: the live rows, whole live pages (the
    pool's unit) beyond them and the table entries."""
    lens = kv_lens.cpu().numpy().astype(np.int64)
    pages = -(-lens // P)
    item = torch.tensor([], dtype=dtype).element_size()
    extra = 2 * int((pages * P - lens).sum()) * NKV * D * item + 4 * int(pages.sum())
    return _decode_bound(lens, NH, NKV, D, dtype, extra)


def phase_paged_kernel(dev, flush):
    rs = np.random.default_rng(3456)
    scale = 1.0 / np.sqrt(D)
    cases = []
    # bucket 8 (the main case, fp32 and bf16) and bucket 1 (bf16: one row, the fewest split blocks)
    for bucket, rows, dtypes in ((8, PAGED_ROWS, ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))),
                                 (1, [(1500, 1)], ((torch.bfloat16, 2e-2),))):
        args = _batch(rs, 1, rows, dev)
        for dtype, tol in dtypes:
            err, cast, splits = _paged_compare(f"bucket {bucket}", args, scale, dtype, tol)
            ms = _time_ms(lambda: paged_decode_attention(*cast, scale=scale, impl="kernel"), 50, flush)
            plain_ms = _time_ms(lambda: paged_decode_attention(*cast, scale=scale, impl="plain"), 20, flush)
            qd, kd, vd, pt, kv_lens = cast
            sq, sk, sv, mask = _sdpa_inputs(qd[:, None], kd, vd, pt, kv_lens, (kv_lens > 0).to(torch.int32))
            library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, scale=scale, enable_gqa=True), 50, flush)
            bound_ms, bound_by, nbytes, flops = _paged_bound(kv_lens, dtype)
            case = dict(case=f"bucket {bucket} W=1 {str(dtype).replace('torch.', '')}", max_abs_err=err, tol=tol,
                        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                        bytes=nbytes, flops=flops, roofline_share=bound_ms / ms, splits=splits, bitwise_equal=True)
            emit(phase="paged_kernel", kernel="paged_decode_attention", dead_rows_exact_zero=True, **case,
                 library="scaled_dot_product_attention over pre-gathered contiguous K/V (omits the page walk)")
            cases.append(case)
    # beyond the main path's shapes (correctness only): head_dim 128, a GQA
    # group of 7, pages of 64 keys, sentinel ids and a dead row
    other = dict(nh=28, nkv=4, d=128, p=64, maxp=8, np_=24)
    args = _batch(rs, 1, [(300, 1), (70, 1), (0, 0), (5, 1), (129, 1)], dev, **other)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        err, _, _ = _paged_compare("D=128 Hg=7 P=64", args, 1.0 / np.sqrt(128), dtype, tol)
        emit(phase="paged_kernel", kernel="paged_decode_attention", case=f"D=128 Hg=7 P=64 {dtype}",
             max_abs_err=err, tol=tol, dead_rows_exact_zero=True)
    return cases


# --- phase 7: the dense generate path -------------------------------------------
def _check_generated(label, out, prompts, new, vocab):
    out = out.cpu().numpy()
    if out.shape != (prompts.shape[0], prompts.shape[1] + new) or not (out[:, : prompts.shape[1]] == prompts).all() \
            or out.min() < 0 or out.max() >= vocab:
        raise AssertionError(f"{label}: malformed output {out.shape}")
    return out


def phase_generate(cfg, tree, seed):
    model = TransformerLM(cfg)
    engine = dst.init_inference(model, dtype="bf16")
    engine.load_jax_params(tree)
    engine.profile_model_time()
    rs = np.random.default_rng(seed)
    prompts = rs.integers(0, cfg.vocab_size, (16, 128), dtype=np.int32)
    new = 128
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # counts from here are the generate main path's
    for name in ("cold", "warm"):
        before = _counts()
        t0 = time.perf_counter()
        out = engine.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check_generated(f"generate {name}", out, prompts, new, cfg.vocab_size)
        got = {k: v - before[k] for k, v in _counts().items()}
        emit(phase="generate", pass_=name, batch=16, prompt=128, new_tokens=new, wall_s=wall,
             tokens_per_s=16 * new / wall, ms_per_token=wall * 1e3 / new, launches=got)
        if got["decode_attention"] != cfg.num_layers * new or sum(got.values()) != got["decode_attention"]:
            raise AssertionError(f"generate {name}: launches {got}, want K6 = {cfg.num_layers} x {new} and no other")
    beam_prompts = rs.integers(0, cfg.vocab_size, (2, 224), dtype=np.int32)
    before = _counts()
    t0 = time.perf_counter()
    beam = engine.generate(beam_prompts, max_new_tokens=32, num_beams=4)
    torch.cuda.synchronize()
    beam_wall = time.perf_counter() - t0
    _check_generated("beam", beam, beam_prompts, 32, cfg.vocab_size)
    got = {k: v - before[k] for k, v in _counts().items()}
    if got["decode_attention"] != cfg.num_layers * 32 or sum(got.values()) != got["decode_attention"]:
        raise AssertionError(f"beam: launches {got}, want K6 = {cfg.num_layers} x 32 and no other")
    counts = _counts()
    split = decode_attention.launches_decode_split
    summary = dict(phase="generate", pass_="all", model_times_s=engine.model_times(), beam_wall_s=beam_wall,
                   beam_launches=got, launches=counts, k6_split_launches=split,
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
    emit(**summary)
    if split != counts["decode_attention"]:
        raise AssertionError(f"generate: {split} of {counts['decode_attention']} K6 calls ran the split-KV kernel")
    del engine, model
    torch.cuda.empty_cache()
    return counts["decode_attention"], split


# --- phase 8: the bucketed server -------------------------------------------------
def phase_bucketed(cfg, tree, seed):
    model = TransformerLM(cfg)
    engine = dst.init_inference(model, dtype="bf16", paged_kv={"page_size": 16, "max_slots": 8, "ragged": False})
    engine.load_jax_params(tree)
    prompts, budgets = _requests(seed, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # counts from here are the bucketed serving path's
    passes = []
    for name in ("cold", "warm"):
        before = engine.serve_stats() or {"prefix": {"prefix_hit_tokens": 0, "prefix_query_tokens": 0},
                                          "decode_steps": 0, "prefill_chunks": 0}
        t0 = time.perf_counter()
        outs = engine.serve(prompts, max_new_tokens=budgets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = engine.serve_stats()
        for p, b, o in zip(prompts, budgets, outs):
            if o is None or o.shape != (p.size + b,) or not (o[: p.size] == p).all() \
                    or o.min() < 0 or o.max() >= cfg.vocab_size:
                raise AssertionError(f"bucketed {name}: malformed output for a {p.size}-token prompt")
        hit = s["prefix"]["prefix_hit_tokens"] - before["prefix"]["prefix_hit_tokens"]
        query = s["prefix"]["prefix_query_tokens"] - before["prefix"]["prefix_query_tokens"]
        rec = dict(phase="bucketed", pass_=name, requests=len(outs), generated_tokens=sum(budgets), wall_s=wall,
                   tokens_per_s=sum(budgets) / wall, decode_steps=s["decode_steps"] - before["decode_steps"],
                   prefill_chunks=s["prefill_chunks"] - before["prefill_chunks"],
                   prefix_hit_rate=hit / query if query else 0.0)
        emit(**rec)
        passes.append(rec)
    counts = _counts()
    launches = counts["paged_decode_attention"]
    s = engine.serve_stats()
    emit(phase="bucketed", pass_="both", ttft_ms=s["ttft_ms"], tpot_ms=s["tpot_ms"], decode_steps=s["decode_steps"],
         prefill_chunks=s["prefill_chunks"], dispatches=s["dispatches"], finished=s["finished"],
         preempted=s["preempted"], prefix=s["prefix"], buckets=engine._paged_server.buckets, k5_launches=launches,
         launches=counts, peak_memory_bytes=torch.cuda.max_memory_allocated())
    if s["finished"] != 32 or passes[1]["prefix_hit_rate"] <= 0:
        raise AssertionError(f"bucketed: finished {s['finished']} of 32, warm prefix hit rate "
                             f"{passes[1]['prefix_hit_rate']}")
    if launches != cfg.num_layers * s["decode_steps"] or launches == 0 or sum(counts.values()) != launches:
        raise AssertionError(f"K5 launches {launches} != {cfg.num_layers} x decode_steps {s['decode_steps']}, "
                             f"or another kernel launched: {counts}")
    split_launches = decode_attention.launches_paged_split
    if split_launches != launches:
        raise AssertionError(f"{split_launches} of {launches} K5 calls ran the split-KV kernel, want all")
    del engine, model
    torch.cuda.empty_cache()
    return launches, split_launches


# --- phase 9: fp32 stream identity of K4, K5 and K6 --------------------------------
def _joint_logprob(model, seqs, prompt_len):
    """Σ log p(token | prefix) over each row's generated part, one full fp32
    forward (the rescoring of tests/unit/inference/test_beam.py)."""
    with torch.no_grad():
        logits = model.apply(model.param_tree(), seqs.long(), train=False)
    logp = torch.log_softmax(logits.float(), dim=-1)
    gen = seqs[:, prompt_len:].long()
    return logp[:, prompt_len - 1 : -1].gather(2, gen[..., None])[..., 0].sum(dim=1).tolist()


def phase_three_way(cfg, tree, seed, dev):
    model = TransformerLM(cfg)
    paged = {"page_size": 16, "max_slots": 8}
    ragged = dst.init_inference(model, dtype="fp32", paged_kv=paged)
    ragged.load_jax_params(tree)
    bucketed = dst.init_inference(model, dtype="fp32", paged_kv=dict(paged, ragged=False))
    windows = dst.init_inference(model, dtype="fp32", paged_kv=WINDOWS)
    rs = np.random.default_rng(seed + 2)
    prompts = rs.integers(0, cfg.vocab_size, (4, 224), dtype=np.int32)
    before = _counts()
    streams = {
        "ragged (K4)": ragged.serve(list(prompts), max_new_tokens=32),
        "bucketed (K5)": bucketed.serve(list(prompts), max_new_tokens=32),
        "generate (K6)": list(ragged.generate(prompts, max_new_tokens=32).cpu().numpy()),
    }
    got = {k: v - before[k] for k, v in _counts().items()}
    if not (got["ragged_paged_attention"] and got["paged_decode_attention"]
            and got["decode_attention"] == cfg.num_layers * 32):
        raise AssertionError(f"fp32 three-way: launches {got}")
    # the window server (CUDA graph replays of K4) must give the ragged streams exactly: same kernels, same rows
    window_streams = windows.serve(list(prompts), max_new_tokens=32)
    ws = windows.serve_stats()
    same = sum(1 for a, b in zip(window_streams, streams["ragged (K4)"]) if np.array_equal(a, b))
    emit(phase="three_way", dtype="float32", arm="ragged windows (K4, CUDA graph)", identical_to_ragged=same,
         window_steps=ws["window_steps"], window_captures=ws["window_captures"])
    if same != len(prompts) or ws["window_steps"] == 0:
        raise AssertionError(f"fp32 windows: {same} of {len(prompts)} streams equal the ragged server's, "
                             f"window_steps {ws['window_steps']}")
    partings = []
    names = list(streams)
    for other in names[1:]:
        for i, (a, b) in enumerate(zip(streams[names[0]], streams[other])):
            if a.shape != b.shape:
                raise AssertionError(f"{other} stream {i}: shapes {a.shape} vs {b.shape}")
            diff = np.nonzero(a != b)[0]
            if diff.size:
                at = int(diff[0])
                gap = _top2_gap(cfg, model.param_tree(), a[:at], dev)
                partings.append({"pair": f"{names[0]} vs {other}", "request": i, "position": at, "plain_top2_gap": gap})
                if gap >= 1e-4:
                    raise AssertionError(f"{other} stream {i} parts from {names[0]} at {at} with plain top-2 gap {gap}")
    identical = {other: sum(1 for a, b in zip(streams[names[0]], streams[other]) if np.array_equal(a, b))
                 for other in names[1:]}
    greedy = ragged.generate(prompts[:2], max_new_tokens=32)
    beam = ragged.generate(prompts[:2], max_new_tokens=32, num_beams=4, length_penalty=0.0)
    g_scores = _joint_logprob(model, greedy, 224)
    b_scores = _joint_logprob(model, beam, 224)
    emit(phase="three_way", dtype="float32", requests=4, new_tokens=32, identical_to_ragged=identical,
         partings=partings, launches=got, beam_logprob=b_scores, greedy_logprob=g_scores)
    if beam.shape != greedy.shape or any(b < g - 1e-3 for g, b in zip(g_scores, b_scores)):
        raise AssertionError(f"fp32 beam joint log-prob {b_scores} below greedy's {g_scores}")
    del ragged, bucketed, windows, model
    torch.cuda.empty_cache()


# --- phase 9b: multi-step serving windows (one CUDA graph replay a window) -------------
HORIZON = 8
WINDOWS = {"page_size": 16, "max_slots": 8, "ragged": True, "multi_step": {"enable": True, "horizon": HORIZON}}


def _k4_counter_want(cfg, s):
    """K4's wrapper counter from a window server's stats: one a layer a
    single step; a capture passes the wrapper twice a layer and round (the
    warm-up's launch and the graph's record); a replay never passes it."""
    return cfg.num_layers * (s["ragged_steps"] + 2 * HORIZON * s["window_captures"])


K4_KERNELS = ("ragged_split_kernel", "ragged_combine_kernel")


PROFILED_STEPS = 2  # window replays under the profiler: ~32k device events


def _profiled_windows(cfg, params, prompts, new, ref):
    """K4's kernels counted on the device by ``torch.profiler`` (CUDA
    activity) over PROFILED_STEPS steps of a window server whose graph is
    already captured: one split and one combine a layer per single step and
    a layer and round per replay, which the wrappers' counters cannot see.
    The region is kept short: a whole serve pass under the profiler holds
    ~400k device events, and one such run on the card counted one K4 pair
    fewer than the replays and steps launch (ten more passes, in
    tools/torch_window_launches.py, counted every pair). The server then
    runs to its end, and its streams must equal ``ref``."""
    server = PagedServer(cfg, params, page_size=16, max_slots=8, dtype=torch.bfloat16,
                         prefix_cache=True, multi_step=WINDOWS["multi_step"])
    uids = [server.submit(p, max_new_tokens=new) for p in prompts]
    while server.has_work() and (server.prefilling() or server.stats["window_captures"] == 0):
        server.step()
    before = dict(server.stats)
    _zero_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            server.step()
        torch.cuda.synchronize()
    counter = decode_attention.launches
    device = dict.fromkeys(K4_KERNELS, 0)
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            for name in K4_KERNELS:
                if name in evt.key:
                    device[name] += evt.count
    d_ragged = server.stats["ragged_steps"] - before["ragged_steps"]
    d_windows = server.stats["window_steps"] - before["window_steps"]
    server.run()
    outs = [server.take_result(u) for u in uids]
    return dict(steps=PROFILED_STEPS, window_steps=d_windows, ragged_steps=d_ragged,
                window_captures=server.stats["window_captures"] - before["window_captures"],
                k4_counter=counter, k4_counter_want=cfg.num_layers * d_ragged, k4_device_launches=device,
                k4_device_launches_want=cfg.num_layers * (d_ragged + HORIZON * d_windows),
                identical=sum(1 for a, b in zip(outs, ref) if np.array_equal(a, b)))


def _steady_run(server, prompts, new):
    """Serve ``prompts`` x ``new`` tokens on a fresh server, stepping by hand:
    the host wall of every step after prefill, split into windows and single
    steps (the first window holds the server's capture: a warm-up run and
    the graph's recording), and the device time of each window's replay
    from the server's stats. K4's counter is zeroed first."""
    _zero_counts()
    t0 = time.perf_counter()
    uids = [server.submit(p, max_new_tokens=new) for p in prompts]
    while server.prefilling():
        server.step()
    windows, singles = [], []
    while server.has_work():
        w0, t = server.stats["window_steps"], time.perf_counter()
        server.step()
        (windows if server.stats["window_steps"] > w0 else singles).append(time.perf_counter() - t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [server.take_result(u) for u in uids]
    s = server.serve_stats()
    return outs, dict(wall_s=wall, tokens_per_s=len(prompts) * new / wall, tpot_ms=s["tpot_ms"], ttft_ms=s["ttft_ms"],
                      window_steps=s["window_steps"], window_captures=s["window_captures"],
                      window_replays=s["window_device_ms"]["count"], ragged_steps=s["ragged_steps"],
                      window_break_reasons=s["window_break_reasons"],
                      window_ms_p50=float(np.median(windows)) * 1e3 if windows else None,
                      first_window_ms=windows[0] * 1e3 if windows else None,  # a fresh server's capture
                      window_device_ms=s["window_device_ms"],
                      single_step_ms_p50=float(np.median(singles)) * 1e3 if singles else None,
                      k4_counter=decode_attention.launches, launches=_counts())


def phase_windows(cfg, tree, seed, streams):
    model = TransformerLM(cfg)
    engine = dst.init_inference(model, dtype="bf16", paged_kv=WINDOWS)
    engine.load_jax_params(tree)
    prompts, budgets = _requests(seed, cfg.vocab_size)
    _zero_counts()  # counts from here are the window serving path's
    for name in ("cold", "warm"):
        before = engine.serve_stats() or {"window_steps": 0, "ragged_steps": 0}
        t0 = time.perf_counter()
        outs = engine.serve(prompts, max_new_tokens=budgets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = engine.serve_stats()
        same = sum(1 for a, b in zip(outs, streams[name]) if np.array_equal(a, b))
        emit(phase="windows", pass_=name, requests=len(outs), generated_tokens=sum(budgets), wall_s=wall,
             tokens_per_s=sum(budgets) / wall, identical_to_phase_3=same,
             window_steps=s["window_steps"] - before["window_steps"],
             ragged_steps=s["ragged_steps"] - before["ragged_steps"])
        if same != len(outs):
            raise AssertionError(f"windows {name}: {same} of {len(outs)} streams equal phase 3's single-step streams")
    s = engine.serve_stats()
    counts = _counts()
    counter = _k4_counter_want(cfg, s)
    emit(phase="windows", pass_="both", ttft_ms=s["ttft_ms"], tpot_ms=s["tpot_ms"], window_steps=s["window_steps"],
         window_captures=s["window_captures"], window_replays=s["window_device_ms"]["count"],
         window_break_reasons=s["window_break_reasons"], ragged_steps=s["ragged_steps"],
         dispatches_per_token=s["dispatches_per_token"], finished=s["finished"], launches=counts,
         k4_counter_want=counter)
    if s["finished"] != 32 or s["window_steps"] == 0 or s["window_captures"] != 1:
        raise AssertionError(f"windows: finished {s['finished']} of 32, window_steps {s['window_steps']}, "
                             f"captures {s['window_captures']}")
    if s["window_device_ms"]["count"] != s["window_steps"]:
        raise AssertionError(f"windows: {s['window_device_ms']['count']} timed replays, {s['window_steps']} windows")
    if counts["ragged_paged_attention"] != counter or sum(counts.values()) != counter:
        raise AssertionError(f"windows: launches {counts}, want K4 = {counter} and no other")
    # steady traffic: 8 requests x 128 new tokens, the single-step server and the window server in turns
    # (single, window, window, single), each a fresh server with the serving engine's settings
    rs = np.random.default_rng(seed + 7)
    steady = [rs.integers(0, cfg.vocab_size, 128, dtype=np.int32) for _ in range(8)]
    params = engine.module.param_tree()
    runs, ref = [], None
    for multi_step in (None, WINDOWS["multi_step"], WINDOWS["multi_step"], None):
        server = PagedServer(cfg, params, page_size=16, max_slots=8, dtype=torch.bfloat16,
                             prefix_cache=True, multi_step=multi_step)
        outs, rec = _steady_run(server, steady, 128)
        ref = ref or outs
        rec.update(mode="windows" if multi_step else "single-step",
                   identical=sum(1 for a, b in zip(outs, ref) if np.array_equal(a, b)))
        want = _k4_counter_want(cfg, rec)
        if multi_step:
            rec.update(k4_counter_want=want,
                       window_idle_share=1.0 - rec["window_device_ms"]["p50"] / rec["window_ms_p50"])
        emit(phase="windows_steady", requests=8, new_tokens=128, **rec)
        if rec["identical"] != 8 or rec["k4_counter"] != want or sum(rec["launches"].values()) != want:
            raise AssertionError(f"windows steady {rec['mode']}: {rec['identical']} of 8 streams equal, "
                                 f"K4 counter {rec['k4_counter']} want {want}, launches {rec['launches']}")
        if multi_step and (rec["window_steps"] == 0 or rec["window_captures"] != 1
                           or rec["window_replays"] != rec["window_steps"]):
            raise AssertionError(f"windows steady: window_steps {rec['window_steps']}, captures "
                                 f"{rec['window_captures']}, timed replays {rec['window_replays']}")
        runs.append(rec)
        del server
    # the replays launch K4 without passing its wrapper: count its kernels on the device
    profiled = _profiled_windows(cfg, params, steady, 128, ref)
    emit(phase="windows", pass_="profiled", **profiled)
    if (profiled["identical"] != 8 or profiled["window_steps"] == 0 or profiled["window_captures"] != 0
            or any(n != profiled["k4_device_launches_want"] for n in profiled["k4_device_launches"].values())
            or profiled["k4_counter"] != profiled["k4_counter_want"]):
        raise AssertionError(f"windows profiled: {profiled}")
    del engine, model
    torch.cuda.empty_cache()
    return dict(serve=dict(window_steps=s["window_steps"], window_captures=s["window_captures"],
                           k4_counter=counts["ragged_paged_attention"], k4_counter_want=counter),
                profiled=profiled,
                steady=[{k: r[k] for k in ("mode", "tokens_per_s", "tpot_ms", "window_steps", "window_ms_p50",
                                          "window_device_ms", "single_step_ms_p50") if k in r} for r in runs])


# --- launch counts -------------------------------------------------------------
def _zero_counts():
    decode_attention.launches = decode_attention.launches_decode = decode_attention.launches_paged = 0
    decode_attention.launches_ragged_split = decode_attention.launches_paged_split = 0
    decode_attention.launches_decode_split = 0
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    fa.launches_fwd_tc = fa.launches_dq_tc = fa.launches_dkv_tc = 0
    bs.launches_fwd = bs.launches_dq = bs.launches_dkv = 0
    bs.launches_fwd_tc = bs.launches_dq_tc = bs.launches_dkv_tc = 0


def _variants():
    """Launches of the tensor-core variants of K1-K3 and K7-K9 (bf16, fp16)
    among the counts above (the rest of those kernels' launches took the
    fp32 FMA variants), and the K4, K6 and K5 calls that ran their split-KV
    kernel and combine."""
    return dict(flash_fwd_tc=fa.launches_fwd_tc, flash_dq_tc=fa.launches_dq_tc, flash_dkv_tc=fa.launches_dkv_tc,
                block_sparse_fwd_tc=bs.launches_fwd_tc, block_sparse_dq_tc=bs.launches_dq_tc,
                block_sparse_dkv_tc=bs.launches_dkv_tc,
                ragged_split=decode_attention.launches_ragged_split,
                decode_split=decode_attention.launches_decode_split,
                paged_split=decode_attention.launches_paged_split)


def _counts():
    return dict(ragged_paged_attention=decode_attention.launches, decode_attention=decode_attention.launches_decode,
                paged_decode_attention=decode_attention.launches_paged, flash_fwd=fa.launches_fwd,
                flash_dq=fa.launches_dq, flash_dkv=fa.launches_dkv, block_sparse_fwd=bs.launches_fwd,
                block_sparse_dq=bs.launches_dq, block_sparse_dkv=bs.launches_dkv)


# --- phase 5: K1-K3 against their plain versions -------------------------------
FLASH_CASES = {  # name: (B, T, N, D, causal)
    "train B=8 T=1024 N=12 D=64 causal": (8, 1024, 12, 64, True),
    "ragged B=2 T=200 N=12 D=64 causal": (2, 200, 12, 64, True),
    "full B=2 T=256 N=12 D=64": (2, 256, 12, 64, False),
    "D=128 B=1 T=2048 N=32 causal": (1, 2048, 32, 128, True),
}
FLASH_MAIN = "train B=8 T=1024 N=12 D=64 causal"
FLASH_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 3e-2)}  # (O and LSE abs, grads rel)
FLASH_FP16_TOL = FLASH_TOL[torch.bfloat16]  # fp16 (the training shape only) at bf16's bounds: it rounds finer
VARIANT = {torch.float32: "fma", torch.bfloat16: "tensor_core", torch.float16: "tensor_core"}  # K1-K3, K7-K9


def _flash_bound(B, T, N, D, causal, dtype):
    """Least time of each kernel at these shapes: max(bytes / HBM rate,
    flops / peak). Pairs = the (query, key) pairs the mask leaves
    (T(T+1)/2 per head causal, T^2 full); K1 does 2 products per pair
    (QK^T, PV), K2 3 (QK^T, dO V^T, dS K), K3 4 (QK^T, dO V^T, P^T dO,
    dS^T Q), 2·D flops each. Bytes: each [B, T, N, D] operand read once
    and each output written once (K1: q, k, v, o; K2: q, k, v, dO, dQ; K3:
    q, k, v, dO, dK, dV) plus the fp32 [B·N, T] rows (K1: lse; K2 and K3:
    lse and delta)."""
    item = torch.tensor([], dtype=dtype).element_size()
    pairs = B * N * (T * (T + 1) // 2 if causal else T * T)
    tensor, row = B * T * N * D * item, B * N * T * 4
    out = {}
    for name, products, tensors, rows in (("flash_fwd", 2, 4, 1), ("flash_dq", 3, 5, 2), ("flash_dkv", 4, 6, 2)):
        nbytes, flops = tensors * tensor + rows * row, products * 2 * D * pairs
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        out[name] = dict(bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
                         bytes=nbytes, flops=flops)
    return out


def _flash_errors(q, k, v, do, causal):
    """Each kernel against its plain version in fp32 on the same inputs
    (the backward pair on the kernel forward's LSE and delta). Returns
    {kernel: (max abs error, error relative to the reference's largest
    magnitude)} over its outputs, and the kernel residuals."""
    f = [t.float() for t in (q, k, v, do)]
    before_tc = fa.launches_fwd_tc
    o, lse = fa.flash_fwd_kernel(q, k, v, causal)
    if fa.launches_fwd_tc - before_tc != int(VARIANT[q.dtype] == "tensor_core"):
        raise AssertionError(f"K1 on {q.dtype} did not take the {VARIANT[q.dtype]} variant")
    o_ref, lse_ref = fa.flash_fwd_plain(*f[:3], causal)
    delta = fa.flash_delta(o, do)
    before_tc = (fa.launches_dq_tc, fa.launches_dkv_tc)
    dq = fa.flash_dq_kernel(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_dkv_kernel(q, k, v, do, lse, delta, causal)
    tc = int(VARIANT[q.dtype] == "tensor_core")
    if (fa.launches_dq_tc - before_tc[0], fa.launches_dkv_tc - before_tc[1]) != (tc, tc):
        raise AssertionError(f"K2 or K3 on {q.dtype} did not take the {VARIANT[q.dtype]} variant")
    dq_ref = fa.flash_dq_plain(*f, lse, delta, causal)
    dk_ref, dv_ref = fa.flash_dkv_plain(*f, lse, delta, causal)
    torch.cuda.synchronize()

    def gap(pairs):
        errs = [((a.float() - b).abs().max().item(), (a.float() - b).abs().max().item() / b.abs().max().item())
                for a, b in pairs]
        for a, _ in pairs:
            if not torch.isfinite(a.float()).all():
                raise AssertionError("a flash kernel wrote a non-finite value")
        return max(e[0] for e in errs), max(e[1] for e in errs)

    return dict(flash_fwd=gap([(o, o_ref)]), flash_lse=gap([(lse, lse_ref)]), flash_dq=gap([(dq, dq_ref)]),
                flash_dkv=gap([(dk, dk_ref), (dv, dv_ref)])), (lse, delta)


def phase_flash(dev, flush):
    rs = np.random.default_rng(4321)
    main = {}
    for name, (B, T, N, D, causal) in FLASH_CASES.items():
        base = [torch.from_numpy(rs.standard_normal((B, T, N, D), dtype=np.float32)).to(dev) for _ in range(4)]
        tols = {**FLASH_TOL, **({torch.float16: FLASH_FP16_TOL} if name == FLASH_MAIN else {})}
        for dtype, (tol_o, tol_g) in tols.items():
            q, k, v, do = (t.to(dtype) for t in base)
            errs, (lse, delta) = _flash_errors(q, k, v, do, causal)
            bad = [key for key, (abs_err, rel) in errs.items()
                   if (abs_err > tol_o if key in ("flash_fwd", "flash_lse") else rel > tol_g)]
            dt = str(dtype).replace("torch.", "")
            rec = dict(phase="flash", case=name, dtype=dt, flash_fwd_variant=VARIANT[dtype],
                       flash_dq_variant=VARIANT[dtype], flash_dkv_variant=VARIANT[dtype], tol_o_lse_abs=tol_o,
                       tol_grad_rel=tol_g, errors={key: dict(max_abs_err=a, rel_err=r) for key, (a, r) in errs.items()})
            if name == FLASH_MAIN and dtype == torch.bfloat16:  # K2 twice on the same inputs: bitwise-equal dQ
                runs = [fa.flash_dq_kernel(q, k, v, do, lse, delta, causal) for _ in range(2)]
                torch.cuda.synchronize()
                equal = torch.equal(runs[0].view(torch.int16), runs[1].view(torch.int16))
                emit(phase="flash_dq_determinism", case=name, dtype=dt, bitwise_equal=equal)
                if not equal:
                    raise AssertionError(f"K2 {name}: two calls on the same inputs differ")
                del runs
            if name == FLASH_MAIN:
                bounds = _flash_bound(B, T, N, D, causal, dtype)
                f = [t.float() for t in (q, k, v, do)]
                timed = {
                    "flash_fwd": (lambda: fa.flash_fwd_kernel(q, k, v, causal),
                                  lambda: fa.flash_fwd_plain(*f[:3], causal)),
                    "flash_dq": (lambda: fa.flash_dq_kernel(q, k, v, do, lse, delta, causal),
                                 lambda: fa.flash_dq_plain(*f, lse, delta, causal)),
                    "flash_dkv": (lambda: fa.flash_dkv_kernel(q, k, v, do, lse, delta, causal),
                                  lambda: fa.flash_dkv_plain(*f, lse, delta, causal)),
                }
                # yardsticks the port never calls: SDPA forward, and its autograd backward
                # (dQ, dK and dV together) for K2 and K3
                sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
                so = F.scaled_dot_product_attention(sq, sk, sv, is_causal=causal)
                sdo = do.transpose(1, 2).contiguous()
                lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(sq.detach(), sk.detach(), sv.detach(),
                                                                          is_causal=causal), 20, flush)
                lib_bwd = _time_ms(lambda: torch.autograd.grad(so, (sq, sk, sv), sdo, retain_graph=True), 20, flush)
                timing = {}
                for key, (kernel, plain) in timed.items():
                    ms = _time_ms(kernel, 20, flush)
                    lib = lib_fwd if key == "flash_fwd" else lib_bwd
                    timing[key] = dict(ms=ms, plain_ms=_time_ms(plain, 5, flush), library_ms=lib,
                                       library_share=lib / ms, roofline_share=bounds[key]["bound_ms"] / ms,
                                       **bounds[key])
                rec["timing"] = timing
                rec["library"] = ("flash_fwd: scaled_dot_product_attention(is_causal=True) on [B, N, T, D]; "
                                  "flash_dq and flash_dkv: the autograd backward of that call, dQ, dK and dV "
                                  "together (the same number on both)")
                main[dt] = rec
                del so, sq, sk, sv, sdo
            emit(**rec)
            if bad:
                raise AssertionError(f"flash {name} {dt}: {bad} past tolerance: {errs}")
    torch.cuda.empty_cache()
    return main


# --- phases 6 and 7: the training main path --------------------------------------
TRAIN_CONFIG = {  # bench.py:507-517, config 1
    "train_micro_batch_size_per_gpu": 8,
    "optimizer": {"type": "adam", "params": {"lr": 3e-4, "weight_decay": 0.01}},
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 1},
    "gradient_clipping": 1.0,
    "steps_per_print": 10_000,
}
WARMUP, TIMED = 3, 20


def _train_batch(cfg, dev, micro=8):
    """bench.py:519-521: RandomState(0) tokens [micro, T+1], split into
    inputs and labels, placed on the card once."""
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (micro, cfg.max_seq_len + 1)).astype(np.int32)
    return {"input_ids": torch.from_numpy(toks[:, :-1]).to(dev), "labels": torch.from_numpy(toks[:, 1:]).to(dev)}


def phase_train(seed, dev):
    cfg = gpt2_config("125m", max_seq_len=1024, remat=False)
    t0 = time.perf_counter()
    tree = _weights(cfg, seed)
    engine, _, _, _ = dst.initialize(model=TransformerLM(cfg), config=dict(TRAIN_CONFIG), model_parameters=tree)
    del tree
    batch = _train_batch(cfg, dev)
    torch.cuda.synchronize()
    emit(phase="train", event="engine_built", seconds=time.perf_counter() - t0, params=engine.num_parameters())
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # counts from here are the training main path's
    losses = []
    for _ in range(WARMUP):
        loss = engine(batch)
        engine.backward(loss)
        engine.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        loss = engine(batch)
        engine.backward(loss)
        engine.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, variants = _counts(), _variants()
    losses = [float(x) for x in losses]
    steps, L, H, T = WARMUP + TIMED, cfg.num_layers, cfg.hidden_size, cfg.max_seq_len
    tokens_per_s = TIMED * 8 * T / wall
    n_params = engine.num_parameters()
    flops_per_token = 6 * n_params + 12 * L * H * T  # bench.py:440-443
    rec = dict(phase="train", model='gpt2_config("125m", max_seq_len=1024, remat=False)', config=TRAIN_CONFIG,
               steps=steps, timed_steps=TIMED, losses=losses, ms_per_step=wall * 1e3 / TIMED,
               tokens_per_s=tokens_per_s, mfu=tokens_per_s * flops_per_token / PEAK_FLOPS[torch.bfloat16],
               step_floor_ms=8 * T * flops_per_token / PEAK_FLOPS[torch.bfloat16] * 1e3,
               grad_norm=engine.get_global_grad_norm(), peak_memory_bytes=torch.cuda.max_memory_allocated(),
               params=n_params, launches=counts, variants=variants)
    emit(**rec)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses not finite or not falling: {losses}")
    want = L * steps
    if any(counts[k] != want for k in ("flash_fwd", "flash_dq", "flash_dkv")) or \
            sum(counts[k] for k in ("ragged_paged_attention", "decode_attention", "paged_decode_attention")):
        raise AssertionError(f"train: launches {counts}, want {want} = {L} x {steps} for each flash kernel")
    if any(variants[f"{k}_tc"] != counts[k] for k in ("flash_fwd", "flash_dq", "flash_dkv")):
        raise AssertionError(f"train: {variants['flash_fwd_tc']} of {counts['flash_fwd']} bf16 K1 launches, "
                             f"{variants['flash_dq_tc']} of {counts['flash_dq']} K2 launches and "
                             f"{variants['flash_dkv_tc']} of {counts['flash_dkv']} K3 launches took the tensor-core "
                             f"variant, want all")
    del engine, batch
    torch.cuda.empty_cache()
    return counts, variants


def phase_train_fp32(seed, dev):
    """The same model in fp32 (TF32 off), 3 steps through the kernels and
    3 through the plain attention from the same weights and batch."""
    cfg = gpt2_config("125m", max_seq_len=1024, remat=False, dtype="float32")
    tree = _weights(cfg, seed)
    config = {k: v for k, v in TRAIN_CONFIG.items() if k != "bf16"}
    batch = _train_batch(cfg, dev)
    arms = {}
    for impl in ("kernel", "plain"):
        engine, _, _, _ = dst.initialize(model=TransformerLM(cfg), config=dict(config), model_parameters=tree,
                                         attn_impl=impl)
        before = (fa.launches_fwd, fa.launches_fwd_tc, fa.launches_dq_tc, fa.launches_dkv_tc)
        rec = []
        for _ in range(3):
            loss = engine(batch)
            engine.backward(loss)
            engine.step()
            rec.append((loss.item(), engine.get_global_grad_norm()))
        launched = fa.launches_fwd - before[0]
        tc = (fa.launches_fwd_tc - before[1], fa.launches_dq_tc - before[2], fa.launches_dkv_tc - before[3])
        if (impl == "kernel") != (launched > 0) or tc != (0, 0, 0):
            raise AssertionError(f"fp32 {impl} arm launched K1 {launched} times; K1-K3 launches on the "
                                 f"tensor-core variants {tc} (want 0)")
        arms[impl] = rec
        del engine
        torch.cuda.empty_cache()
    gaps = [dict(step=i + 1, loss_rel=abs(k[0] - p[0]) / abs(p[0]), grad_norm_rel=abs(k[1] - p[1]) / abs(p[1]))
            for i, (k, p) in enumerate(zip(arms["kernel"], arms["plain"]))]
    # fp32 takes K1's FMA variant: step 1's loss and grad norm equal the plain arm's to the last bit
    identical = arms["kernel"][0] == arms["plain"][0]
    emit(phase="train_fp32", kernel=arms["kernel"], plain=arms["plain"], gaps=gaps, tol_step1=1e-5,
         step1_bit_identical=identical, flash_fwd_variant=VARIANT[torch.float32])
    if gaps[0]["loss_rel"] > 1e-5 or gaps[0]["grad_norm_rel"] > 1e-5 or not identical:
        raise AssertionError(f"fp32 training: step 1 kernel vs plain gap {gaps[0]} past 1e-5 or not bit-identical")


# --- phases 13 and 14: block-sparse attention (K7-K9) --------------------------------
SPARSE_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 3e-2)}  # (O and LSE abs, grads rel)
SPARSE_MAIN = "main B=2 NH=16 T=4096 D=64 Fixed blk=16"
SPARSE_BENCH = "bench B=1 NH=8 T=8192 D=64 BSLongformer blk=64 causal"
SPARSE_B, SPARSE_T = 2, 4096  # the main path's batch and sequence
SPARSE_WARMUP, SPARSE_TIMED = 3, 10
# K8's dQ bound on keys where rounding dS shows (_sparse_dq_ds_fp32), relative to its largest magnitude:
# above the output rounding with dS as hi + lo (at most 3.3e-3 in bf16, 9.6e-4 in fp16, emulated in plain
# torch) and below the error of dS rounded to the operand dtype (at least 8.5e-2 and 1.1e-2)
DS_FP32_TOL = {torch.bfloat16: 1.5e-2, torch.float16: 3e-3}


def _dead_rows_layout():
    """tests/unit/ops/test_pallas_block_sparse.py:136-171: q block 0 lists
    only the future kv block 3, so under the causal mask its rows are dead."""
    layout = np.zeros((1, 4, 4), bool)
    layout[0, 0, 3] = layout[0, 1, 1] = layout[0, 2, 2] = layout[0, 2, 0] = layout[0, 3, 3] = True
    return layout


def _dead_keys_layout():
    """Key block 3 is listed only by q block 0, which precedes it: under the
    causal mask its keys have no live pair, so its dK and dV rows are exact
    zeros (and q block 0's rows are dead)."""
    layout = np.zeros((1, 4, 4), bool)
    layout[0, 0, 3] = layout[0, 1, 1] = layout[0, 2, 0] = layout[0, 2, 2] = layout[0, 3, 1] = layout[0, 3, 2] = True
    return layout


def _dead_keys(layout_h, block, causal):
    """[T] bool: keys with no live (query, key) pair in this layout. A listed
    pair of blocks (q block >= k block under the causal mask) makes every key
    of its k block live (on the diagonal, each key meets its own row)."""
    qi, ki = np.nonzero(layout_h)
    live = ki[qi >= ki] if causal else ki
    dead = np.ones(layout_h.shape[1], bool)
    dead[live] = False
    return np.repeat(dead, block)


def _sparse_cases():
    """name: (B, NH, T, D, layout [NH or 1, nb, nb], block, causal, timed)."""
    cfg = bert_config("large")  # 16 heads of 64
    nh, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    return {
        SPARSE_MAIN: (SPARSE_B, nh, SPARSE_T, d, FixedSparsityConfig(num_heads=nh, block=16).make_layout(SPARSE_T)[:1],
                      16, False, True),
        # tests/perf/block_sparse_bench.py:31-39: its default bidirectional layout, causal=True to the kernel
        SPARSE_BENCH: (1, 8, 8192, 64, BSLongformerSparsityConfig(num_heads=8, block=64).make_layout(8192)[:1],
                       64, True, True),
        "per-head BigBird B=1 NH=4 T=2048 D=128 blk=32": (
            1, 4, 2048, 128, BigBirdSparsityConfig(num_heads=4, block=32, different_layout_per_head=True,
                                                   num_random_blocks=1).make_layout(2048), 32, False, False),
        "causal Fixed B=1 NH=8 T=2048 D=64 blk=16": (
            1, 8, 2048, 64, FixedSparsityConfig(num_heads=8, block=16, attention="unidirectional").make_layout(2048)[:1],
            16, True, False),
        "dead rows B=2 NH=2 T=64 D=64 blk=16": (2, 2, 64, 64, _dead_rows_layout(), 16, True, False),
        "block 8 B=1 NH=4 T=512 D=64 BigBird": (
            1, 4, 512, 64, BigBirdSparsityConfig(num_heads=4, block=8).make_layout(512)[:1], 8, True, False),
        "block 128 B=1 NH=4 T=2048 D=128 Fixed": (
            1, 4, 2048, 128, FixedSparsityConfig(num_heads=4, block=128).make_layout(2048)[:1], 128, False, False),
        "dead keys B=2 NH=2 T=64 D=64 blk=16": (2, 2, 64, 64, _dead_keys_layout(), 16, True, False),
    }


def _live_pairs(layout, block, causal, batch):
    """(query, key) pairs the layout leaves, summed over heads and batch:
    block^2 per live block pair, block(block+1)/2 on a causal diagonal and
    none above it."""
    total = 0
    for layout_h in np.asarray(layout, bool):
        qi, ki = np.nonzero(layout_h)
        per = np.full(qi.shape, block * block, np.int64)
        if causal:
            per = np.where(qi > ki, per, np.where(qi == ki, block * (block + 1) // 2, 0))
        total += int(per.sum())
    return total * batch


def _sparse_bound(B, NH, T, D, layout, block, causal, dtype):
    """Least time of K7-K9 at these inputs: max(bytes / HBM rate, flops /
    peak). Pairs = the (query, key) pairs of this layout (causal: on or
    below the diagonal); K7 does 2 products of 2·D flops per pair (QK^T,
    PV), K8 3 (QK^T, dO V^T, dS K), K9 4 (QK^T, dO V^T, P^T dO, dS^T Q).
    Bytes: each [B·NH, T, D] operand read once and each output written once
    (K7: q, k, v, o; K8: q, k, v, dO, dQ; K9: q, k, v, dO, dK, dV), the
    fp32 [B·NH, T] rows (K7: lse; K8, K9: lse and delta) and the int32
    tables each call reads (K7, K8: the row lists; K9: the column lists)."""
    item = torch.tensor([], dtype=dtype).element_size()
    heads = NH if layout.shape[0] == 1 else 1
    pairs = _live_pairs(layout, block, causal, B * heads)
    tensor, row = B * NH * T * D * item, B * NH * T * 4
    table_bytes = {"rows": 0, "cols": 0}
    for layout_h in layout:
        ri, rc, ci, cc = build_block_tables(layout_h)
        table_bytes["rows"] += 4 * (ri.size + rc.size)
        table_bytes["cols"] += 4 * (ci.size + cc.size)
    out = {}
    for name, products, tensors, rows, tables in (("block_sparse_fwd", 2, 4, 1, "rows"),
                                                  ("block_sparse_dq", 3, 5, 2, "rows"),
                                                  ("block_sparse_dkv", 4, 6, 2, "cols")):
        nbytes, flops = tensors * tensor + rows * row + table_bytes[tables], products * 2 * D * pairs
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        out[name] = dict(bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
                         bytes=nbytes, flops=flops, live_pairs=pairs)
    return out


def _sparse_errors(groups, block, causal):
    """Each kernel against its plain version in fp32 on the same inputs (the
    backward pair on the kernel forward's LSE and delta), over the head
    groups (one for a shared layout, one per head otherwise). Returns
    {kernel: (max abs error, error relative to the reference's largest
    magnitude)}, whether the dead rows (rows with no live score) are exact
    zeros in O and dQ and the dead keys (keys with no live pair) exact zeros
    in dK and dV, and the kernel outputs of the first group. K7-K9 must take
    the variant of their dtype (tensor cores for bf16 and fp16, FMA for
    fp32)."""
    errs = {}
    dead_zero = True
    first = None
    for q, k, v, do, tables, f_units, units, layout_h in groups:
        row_idx, row_cnt, col_idx, col_cnt = tables
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
        args = (scale, block, causal)
        f = [t.float() for t in (q, k, v, do)]
        before_tc = (bs.launches_fwd_tc, bs.launches_dq_tc, bs.launches_dkv_tc)
        o, lse = bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, f_units, *args)
        delta = bs.sparse_delta(o, do)
        dq = bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, f_units, *args)
        dk, dv = bs.sparse_dkv_kernel(q, k, v, do, lse, delta, col_idx, col_cnt, units, *args)
        tc = int(VARIANT[q.dtype] == "tensor_core")
        moved = (bs.launches_fwd_tc - before_tc[0], bs.launches_dq_tc - before_tc[1], bs.launches_dkv_tc - before_tc[2])
        if moved != (tc, tc, tc):
            raise AssertionError(f"K7, K8 or K9 on {q.dtype} did not take the {VARIANT[q.dtype]} variant: {moved}")
        o_ref, lse_ref = bs.sparse_fwd_plain(*f[:3], row_idx, row_cnt, *args)
        dq_ref = bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args)
        dk_ref, dv_ref = bs.sparse_dkv_plain(*f, lse, delta, col_idx, col_cnt, *args)
        torch.cuda.synchronize()
        for a in (o, dq, dk, dv):
            if not torch.isfinite(a.float()).all():
                raise AssertionError("a block-sparse kernel wrote a non-finite value")
        dead = lse_ref <= bs.NEG_INF / 2  # [BN, T]: rows with no live score
        dead_keys = torch.from_numpy(_dead_keys(layout_h, block, causal)).to(q.device)
        dead_zero &= bool((o[dead] == 0).all().item() and (dq[dead] == 0).all().item()
                          and (lse[dead] == lse_ref[dead]).all().item()
                          and (dk[:, dead_keys] == 0).all().item() and (dv[:, dead_keys] == 0).all().item())
        for key, pairs in (("block_sparse_fwd", [(o, o_ref)]), ("block_sparse_lse", [(lse, lse_ref)]),
                           ("block_sparse_dq", [(dq, dq_ref)]), ("block_sparse_dkv", [(dk, dk_ref), (dv, dv_ref)])):
            for a, b in pairs:
                if key == "block_sparse_lse":  # NEG_INF on dead rows, checked above
                    a, b = a[~dead], b[~dead]
                gap = (a.float() - b).abs().max().item()
                rel = gap / max(b.abs().max().item(), 1e-30)
                prev = errs.get(key, (0.0, 0.0))
                errs[key] = (max(prev[0], gap), max(prev[1], rel))
        if first is None:
            first = (o, lse, delta)
        del f, o_ref, lse_ref, dq_ref, dk_ref, dv_ref
    return errs, dead_zero, first


def _sparse_groups(q4, k4, v4, do4, layout, block, dev):
    """[B, NH, T, D] inputs as the fused path runs them: heads folded into
    the batch for a shared layout, one [B, T, D] group per head otherwise;
    each with its tables, K7's and K9's units and its layout."""
    B, NH, T, D = q4.shape

    def tables(layout_h):
        return (bs.block_tables(layout_h, dev), bs.fwd_units(layout_h, block, dev),
                bs.dkv_units(layout_h, block, dev), layout_h)

    if layout.shape[0] == 1:
        return [tuple(x.reshape(B * NH, T, D) for x in (q4, k4, v4, do4)) + tables(layout[0])]
    return [tuple(x[:, h].contiguous() for x in (q4, k4, v4, do4)) + tables(layout[h]) for h in range(NH)]


def _sparse_timing(groups, q4, k4, v4, do4, layout, block, causal, dtype, flush, first):
    """ms of each kernel, its plain version, its bound, the library
    yardstick (SDPA with the layout as an element mask; its autograd
    backward for K8 and K9 together) and the port's dense flash kernels K1-K3
    at the same shape."""
    B, NH, T, D = q4.shape
    q, k, v, do, (row_idx, row_cnt, col_idx, col_cnt), f_units, units, _ = groups[0]
    scale = 1.0 / float(np.sqrt(D))
    args = (scale, block, causal)
    _, lse, delta = first
    f = [t.float() for t in (q, k, v, do)]
    timed = {
        "block_sparse_fwd": (lambda: bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, f_units, *args),
                             lambda: bs.sparse_fwd_plain(*f[:3], row_idx, row_cnt, *args)),
        "block_sparse_dq": (lambda: bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, f_units, *args),
                            lambda: bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args)),
        "block_sparse_dkv": (lambda: bs.sparse_dkv_kernel(q, k, v, do, lse, delta, col_idx, col_cnt, units, *args),
                             lambda: bs.sparse_dkv_plain(*f, lse, delta, col_idx, col_cnt, *args)),
    }
    bounds = _sparse_bound(B, NH, T, D, layout, block, causal, dtype)
    # yardsticks the port never calls: SDPA over the layout expanded to an element mask, and its autograd
    # backward (dQ, dK and dV together) for K8 and K9
    elem = _element_mask(layout, block, causal, T, q.device)
    sq, sk, sv = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
    so = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=elem, scale=scale)
    lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=elem, scale=scale), 10, flush)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(so, (sq, sk, sv), do4, retain_graph=True), 10, flush)
    del so, sq, sk, sv, elem
    timing = {}
    for key, (kernel, plain) in timed.items():
        ms = _time_ms(kernel, 20, flush)
        lib = lib_fwd if key == "block_sparse_fwd" else lib_bwd
        timing[key] = dict(ms=ms, plain_ms=_time_ms(plain, 3, flush), library_ms=lib, library_share=lib / ms,
                           roofline_share=bounds[key]["bound_ms"] / ms, **bounds[key])
    if q.dtype != torch.float32:  # K7's, K8's and K9's fp32 workspaces for the split blocks at these shapes
        bn = B * NH // len(groups)
        timing["block_sparse_fwd"].update(units=int(f_units.units.shape[0]), split_q_blocks=int(f_units.reduce.shape[0]),
                                          chunk_cap=f_units.cap, workspace_bytes=bn * f_units.n_slots * block * (D + 2) * 4)
        timing["block_sparse_dq"].update(units=int(f_units.units.shape[0]), split_q_blocks=int(f_units.reduce.shape[0]),
                                         chunk_cap=f_units.cap, workspace_bytes=bn * f_units.n_slots * block * D * 4)
        timing["block_sparse_dkv"].update(units=int(units.units.shape[0]), split_key_blocks=int(units.reduce.shape[0]),
                                          chunk_cap=units.cap, workspace_bytes=bn * units.n_slots * 2 * block * D * 4)
    del f
    torch.cuda.empty_cache()
    # the port's dense flash kernels on the same inputs ([B, T, N, D]): block_sparse_bench's comparison
    fq, fk, fv, fdo = (x.transpose(1, 2).contiguous() for x in (q4, k4, v4, do4))
    fo, flse = fa.flash_fwd_kernel(fq, fk, fv, causal, scale)
    fdelta = fa.flash_delta(fo, fdo)
    dense = {
        "flash_fwd": _time_ms(lambda: fa.flash_fwd_kernel(fq, fk, fv, causal, scale), 10, flush),
        "flash_dq": _time_ms(lambda: fa.flash_dq_kernel(fq, fk, fv, fdo, flse, fdelta, causal, scale), 10, flush),
        "flash_dkv": _time_ms(lambda: fa.flash_dkv_kernel(fq, fk, fv, fdo, flse, fdelta, causal, scale), 10, flush),
    }
    return timing, dense


def _sparse_fp16(name, base, layout, block, causal, timed, dev, flush):
    """K7 and K8 in fp16 against their plain versions in fp32 on the same
    (cast) inputs, K8 on the kernel forward's LSE and delta: O and LSE within
    bf16's bound, dQ within 3e-2 of its largest magnitude, dead rows exact
    zeros in O and dQ, every call on the tensor-core variant; at the timed
    shapes their times, bounds and library yardsticks."""
    q4, k4, v4, do4 = (t.to(torch.float16) for t in base)
    groups = _sparse_groups(q4, k4, v4, do4, layout, block, dev)
    tol, tol_g = SPARSE_TOL[torch.bfloat16]
    err, dq_rel, dead_zero = 0.0, 0.0, True
    for q, k, v, do, (row_idx, row_cnt, _, _), f_units, _, _ in groups:
        args = (1.0 / float(np.sqrt(q.shape[-1])), block, causal)
        before = (bs.launches_fwd_tc, bs.launches_dq_tc)
        o, lse = bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, f_units, *args)
        delta = bs.sparse_delta(o, do)
        dq = bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, f_units, *args)
        f = [t.float() for t in (q, k, v, do)]
        o_ref, lse_ref = bs.sparse_fwd_plain(*f[:3], row_idx, row_cnt, *args)
        dq_ref = bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args)
        torch.cuda.synchronize()
        if (bs.launches_fwd_tc - before[0], bs.launches_dq_tc - before[1]) != (1, 1) or \
                not (torch.isfinite(o.float()).all() and torch.isfinite(dq.float()).all()):
            raise AssertionError(f"K7 or K8 {name} float16: not on the tensor-core variant, or a non-finite value")
        dead = lse_ref <= bs.NEG_INF / 2
        dead_zero &= bool((o[dead] == 0).all().item() and (dq[dead] == 0).all().item()
                          and (lse[dead] == lse_ref[dead]).all().item())
        err = max(err, (o.float() - o_ref).abs().max().item(), (lse - lse_ref)[~dead].abs().max().item())
        dq_rel = max(dq_rel, (dq.float() - dq_ref).abs().max().item() / max(dq_ref.abs().max().item(), 1e-30))
        del f, o_ref, lse_ref, dq_ref
    rec = dict(phase="sparse_fp16", case=name, dtype="float16", block_sparse_fwd_variant="tensor_core",
               block_sparse_dq_variant="tensor_core", max_abs_err=err, tol=tol, dq_rel_err=dq_rel, tol_grad_rel=tol_g,
               dead_rows_exact_zero=dead_zero)
    if timed:
        B, NH, T, D = q4.shape
        q, k, v, do, (row_idx, row_cnt, _, _), f_units, _, _ = groups[0]
        args = (1.0 / float(np.sqrt(D)), block, causal)
        o, lse = bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, f_units, *args)
        delta = bs.sparse_delta(o, do)
        bounds = _sparse_bound(B, NH, T, D, layout, block, causal, torch.float16)
        elem = _element_mask(layout, block, causal, T, dev)
        sq, sk, sv = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
        so = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=elem, scale=args[0])
        rec["timing"] = {
            "block_sparse_fwd": dict(
                ms=_time_ms(lambda: bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, f_units, *args), 20, flush),
                library_ms=_time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=elem, scale=args[0]),
                                    10, flush),
                **bounds["block_sparse_fwd"]),
            "block_sparse_dq": dict(
                ms=_time_ms(lambda: bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, f_units, *args),
                            20, flush),
                library_ms=_time_ms(lambda: torch.autograd.grad(so, (sq, sk, sv), do4, retain_graph=True), 10, flush),
                **bounds["block_sparse_dq"]),
        }
        del so, sq, sk, sv, elem
    emit(**rec)
    if err > tol or dq_rel > tol_g or not dead_zero:
        raise AssertionError(f"K7 or K8 {name} float16: max abs error {err} (tol {tol}), dQ relative error {dq_rel} "
                             f"(tol {tol_g}), dead rows exact zero {dead_zero}")
    return rec


def _element_mask(layout, block, causal, T, dev):
    """The shared layout as a [T, T] boolean element mask (and the causal
    mask where set): the SDPA yardstick's mask."""
    elem = torch.from_numpy(np.kron(layout[0], np.ones((block, block), bool))).to(dev)
    if causal:
        elem &= torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    return elem


def _sparse_dq_ds_fp32(dev):
    """K8 keeps dS in fp32 (hi + lo in the operand dtype), as Pallas does, and
    does not round it to k's dtype as K2 does. On keys within 0.03 of one
    shared vector a head, Σ_k dS_k·c cancels, so dQ is small beside its terms
    and rounding dS would move it some 30 times the output rounding: dQ must
    lie within DS_FP32_TOL of the plain version with fp32 dS, and the plain
    version with dS rounded must not (else the check could not tell)."""
    recs = []
    for dtype, block in ((torch.bfloat16, 16), (torch.bfloat16, 64), (torch.float16, 16)):
        n = 16 if block == 16 else 8
        layout_h = np.ones((n, n), np.int64)
        row_idx, row_cnt, _, _ = bs.block_tables(layout_h, dev)
        rs = np.random.RandomState(block)
        q, v, do = (torch.from_numpy(rs.randn(3, n * block, 64).astype(np.float32)).to(dev).to(dtype) for _ in range(3))
        c = rs.randn(3, 1, 64).astype(np.float32)
        k = torch.from_numpy(c + 0.03 * rs.randn(3, n * block, 64).astype(np.float32)).to(dev).to(dtype)
        args = (0.125, block, False)
        f = [t.float() for t in (q, k, v, do)]
        o, lse = bs.sparse_fwd_plain(*f[:3], row_idx, row_cnt, *args)  # fp32 O: delta = Σ P·dP to fp32
        delta = bs.sparse_delta(o, f[3])
        dq = bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, bs.fwd_units(layout_h, block, dev), *args)
        ref = bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args)
        foil = bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args, ds_dtype=dtype)
        top = ref.abs().max().item()
        err, foil_err = ((x.float() - ref).abs().max().item() / top for x in (dq, foil))
        recs.append(dict(dtype=str(dtype).replace("torch.", ""), block=block, rel_err=err,
                         rounded_ds_rel_err=foil_err, tol=DS_FP32_TOL[dtype]))
    emit(phase="sparse_dq_ds_fp32", cases=recs)
    bad = [r for r in recs if not r["rel_err"] <= r["tol"] < r["rounded_ds_rel_err"]]
    if bad:
        raise AssertionError(f"K8 dS in fp32: {bad}")
    return recs


def phase_sparse_kernels(dev, flush):
    rs = np.random.default_rng(2468)
    main = {}
    for name, (B, NH, T, D, layout, block, causal, timed) in _sparse_cases().items():
        layout = np.asarray(layout, bool)
        base = [torch.from_numpy(rs.standard_normal((B, NH, T, D), dtype=np.float32)).to(dev) for _ in range(4)]
        live = float(layout.mean())
        for dtype, (tol_o, tol_g) in SPARSE_TOL.items():
            q4, k4, v4, do4 = (t.to(dtype) for t in base)
            groups = _sparse_groups(q4, k4, v4, do4, layout, block, dev)
            errs, dead_zero, first = _sparse_errors(groups, block, causal)
            bad = [key for key, (abs_err, rel) in errs.items()
                   if (abs_err > tol_o if key in ("block_sparse_fwd", "block_sparse_lse") else rel > tol_g)]
            dt = str(dtype).replace("torch.", "")
            dead_keys = int(_dead_keys(layout[0], block, causal).sum())
            rec = dict(phase="sparse_kernels", case=name, dtype=dt, causal=causal, block=block,
                       shared_layout=layout.shape[0] == 1, live_block_share=live, block_sparse_fwd_variant=VARIANT[dtype],
                       block_sparse_dq_variant=VARIANT[dtype], block_sparse_dkv_variant=VARIANT[dtype],
                       tol_o_lse_abs=tol_o, tol_grad_rel=tol_g, dead_rows_exact_zero=dead_zero, dead_keys=dead_keys,
                       errors={key: dict(max_abs_err=a, rel_err=r) for key, (a, r) in errs.items()})
            if name.startswith("dead rows") and not (first[1] <= bs.NEG_INF / 2).any():
                raise AssertionError("the dead-rows layout left no dead row")
            if name.startswith("dead keys") and not dead_keys:
                raise AssertionError("the dead-keys layout left no dead key")
            if timed and dtype == torch.bfloat16:  # K7-K9 twice on the same inputs: bitwise-equal outputs
                q, k, v, do, tables, f_units, units, _ = groups[0]
                _, lse, delta = first
                args = (1.0 / float(np.sqrt(D)), block, causal)
                runs = [bs.sparse_fwd_kernel(q, k, v, tables[0], tables[1], f_units, *args) for _ in range(2)]
                torch.cuda.synchronize()
                equal_fwd = torch.equal(runs[0][0].view(torch.int16), runs[1][0].view(torch.int16)) and \
                    torch.equal(runs[0][1].view(torch.int32), runs[1][1].view(torch.int32))
                emit(phase="sparse_fwd_determinism", case=name, dtype=dt, bitwise_equal=equal_fwd,
                     split_q_blocks=int(f_units.reduce.shape[0]))
                runs = [bs.sparse_dq_kernel(q, k, v, do, lse, delta, tables[0], tables[1], f_units, *args)
                        for _ in range(2)]
                torch.cuda.synchronize()
                equal_dq = torch.equal(runs[0].view(torch.int16), runs[1].view(torch.int16))
                emit(phase="sparse_dq_determinism", case=name, dtype=dt, bitwise_equal=equal_dq,
                     split_q_blocks=int(f_units.reduce.shape[0]))
                runs = [bs.sparse_dkv_kernel(q, k, v, do, lse, delta, tables[2], tables[3], units, *args)
                        for _ in range(2)]
                torch.cuda.synchronize()
                equal = all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(*runs))
                emit(phase="sparse_dkv_determinism", case=name, dtype=dt, bitwise_equal=equal,
                     split_key_blocks=int(units.reduce.shape[0]))
                if not (equal and equal_fwd and equal_dq):
                    raise AssertionError(f"K7, K8 or K9 {name}: two calls on the same inputs differ")
                del runs
            if timed:
                rec["timing"], rec["dense_flash_ms"] = _sparse_timing(groups, q4, k4, v4, do4, layout, block,
                                                                      causal, dtype, flush, first)
                rec["library"] = ("block_sparse_fwd: scaled_dot_product_attention with the layout expanded to an "
                                  "element-wise boolean mask (and the causal mask where set) on [B, NH, T, D]; "
                                  "block_sparse_dq and block_sparse_dkv: the autograd backward of that call, dQ, dK "
                                  "and dV together (the same number on both)")
                main[(name, dt)] = rec
            emit(**rec)
            if bad or not dead_zero:
                raise AssertionError(f"block-sparse {name} {dt}: {bad} past tolerance, dead rows and keys exact zero "
                                     f"{dead_zero}: {errs}")
            del groups, first, q4, k4, v4, do4
        main[(name, "float16")] = _sparse_fp16(name, base, layout, block, causal, timed, dev, flush)
        del base
        torch.cuda.empty_cache()
    # one launch per head for a per-head layout through the fused entry, as JAX runs one kernel per head
    name = "per-head BigBird B=1 NH=4 T=2048 D=128 blk=32"
    B, NH, T, D, layout, block, causal, _ = _sparse_cases()[name]
    q4 = torch.from_numpy(rs.standard_normal((B, NH, T, D), dtype=np.float32)).to(dev).to(torch.bfloat16)
    before = bs.launches_fwd
    out = bs.fused_block_sparse_attention(q4, q4, q4, layout, block, causal=causal)
    torch.cuda.synchronize()
    if bs.launches_fwd - before != NH or not torch.isfinite(out.float()).all():
        raise AssertionError(f"per-head fused call: {bs.launches_fwd - before} K7 launches for {NH} heads")
    _sparse_dq_ds_fp32(dev)
    return main


def _bert_step(attn, hidden, target, weights):
    """One forward and backward of BertSparseSelfAttention with MSE against
    ``target``; returns the loss and the weights' gradients."""
    ws = [w.detach().requires_grad_(True) for w in weights]
    out = attn(hidden, *ws)
    loss = F.mse_loss(out.float(), target)
    loss.backward()
    # the clone: mse_loss's scalar keeps the storage of the elementwise loss ([B, T, H] fp32, 32 MiB at the
    # main shape), so a list of the losses themselves grew by a new allocator segment every step
    return loss.detach().clone(), [w.grad for w in ws]


def _timed_window(step, n):
    """Run ``step`` ``n`` times back to back, from a synchronize to a
    synchronize: ``ms_per_step`` is the window's wall time over ``n``. Beside
    it, what a stray reading needs to be read: each step's host enqueue time
    (``host_ms``), each step's interval on the current stream between CUDA
    events recorded at the step boundaries (``stream_ms``; no synchronize
    inside the window), the garbage collections in it (``gc``: generation
    and ms each) and the allocator's device allocations, frees, retries and
    all-stream syncs in it (``allocator``)."""
    collections, started = [], {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            collections.append(dict(generation=info["generation"], ms=(time.perf_counter() - started.pop("t")) * 1e3))

    keys = ("num_device_alloc", "num_device_free", "num_alloc_retries", "num_sync_all_streams")
    mem0 = torch.cuda.memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    stamps = []
    torch.cuda.synchronize()
    gc.callbacks.append(on_gc)
    try:
        t0 = time.perf_counter()
        events[0].record()
        for i in range(n):
            step()
            events[i + 1].record()
            stamps.append(time.perf_counter())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    mem1 = torch.cuda.memory_stats()
    return dict(ms_per_step=wall * 1e3 / n, wall_ms=wall * 1e3,
                host_ms=[(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)],
                stream_ms=[a.elapsed_time(b) for a, b in zip(events, events[1:])],
                gc=collections, allocator={k: mem1.get(k, 0) - mem0.get(k, 0) for k in keys})


def phase_sparse_train(seed, dev):
    """BertSparseSelfAttention at BERT-large width (16 heads, hidden 1024,
    its default FixedDefault(16) layout) on bf16 hidden states [2, 4096,
    1024]: wq, wk and wv with fp32 masters updated by FusedAdam.apply, cast
    to bf16 for each forward; MSE against a seeded target."""
    cfg = bert_config("large")
    config = types.SimpleNamespace(num_attention_heads=cfg.num_heads, hidden_size=cfg.hidden_size)
    H = cfg.hidden_size
    rs = np.random.default_rng(seed + 4)
    hidden32 = torch.from_numpy(rs.standard_normal((SPARSE_B, SPARSE_T, H), dtype=np.float32)).to(dev)
    target = torch.from_numpy(rs.standard_normal((SPARSE_B, SPARSE_T, H), dtype=np.float32)).to(dev)
    masters = {name: torch.from_numpy((0.02 * rs.standard_normal((H, H))).astype(np.float32)).to(dev)
               for name in ("wq", "wk", "wv")}
    hidden = hidden32.to(torch.bfloat16)
    attn = BertSparseSelfAttention(config)
    opt = FusedAdam(lr=1e-3)
    state = opt.init_state(masters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # counts from here are the sparse main path's
    losses = []

    def step():
        nonlocal masters, state
        loss, grads = _bert_step(attn, hidden, target, [m.to(torch.bfloat16) for m in masters.values()])
        masters, state = opt.apply(dict(zip(masters, grads)), state, masters, opt.defaults["lr"])
        losses.append(loss)

    for _ in range(SPARSE_WARMUP):
        step()
    window = _timed_window(step, SPARSE_TIMED)
    counts, variants = _counts(), _variants()
    losses = [float(x) for x in losses]
    steps = SPARSE_WARMUP + SPARSE_TIMED
    rec = dict(phase="sparse_train", model='BertSparseSelfAttention(bert_config("large") widths), FixedDefault(16)',
               batch=SPARSE_B, seq=SPARSE_T, hidden=H, dtype="bfloat16", steps=steps, timed_steps=SPARSE_TIMED,
               losses=losses, ms_per_step=window["ms_per_step"],
               tokens_per_s=SPARSE_B * SPARSE_T / (window["ms_per_step"] * 1e-3), window=window,
               peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=counts, variants=variants)
    emit(**rec)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"sparse train: losses not finite or not falling: {losses}")
    sparse_keys = ("block_sparse_fwd", "block_sparse_dq", "block_sparse_dkv")
    if any(counts[k] != steps for k in sparse_keys) or any(counts[k] for k in counts if k not in sparse_keys):
        raise AssertionError(f"sparse train: launches {counts}, want {steps} for each of K7-K9 and 0 for the rest")
    if any(variants[f"{k}_tc"] != steps for k in sparse_keys):
        raise AssertionError(f"sparse train: {variants['block_sparse_fwd_tc']} K7, {variants['block_sparse_dq_tc']} K8 "
                             f"and {variants['block_sparse_dkv_tc']} K9 of {steps} bf16 calls each took the "
                             f"tensor-core variant, want all")

    # fp32 (TF32 off): one step through the kernels and one through impl="plain"
    arms = {}
    for impl in ("kernel", "plain"):
        before = (bs.launches_fwd, bs.launches_fwd_tc, bs.launches_dq_tc, bs.launches_dkv_tc)
        loss, grads = _bert_step(BertSparseSelfAttention(config, impl=impl), hidden32, target,
                                 list(masters.values()))
        tc = (bs.launches_fwd_tc, bs.launches_dq_tc, bs.launches_dkv_tc)
        if (impl == "kernel") != (bs.launches_fwd > before[0]) or tc != before[1:]:
            raise AssertionError(f"fp32 {impl} arm launched K7 {bs.launches_fwd - before[0]} times, the tensor-core "
                                 f"variants of K7-K9 {[a - b for a, b in zip(tc, before[1:])]} times (want 0)")
        arms[impl] = (float(loss), grads)
        torch.cuda.empty_cache()
    loss_rel = abs(arms["kernel"][0] - arms["plain"][0]) / abs(arms["plain"][0])
    grad_rel = {name: ((a - b).abs().max() / b.abs().max()).item()
                for name, a, b in zip(masters, arms["kernel"][1], arms["plain"][1])}
    emit(phase="sparse_train_fp32", loss_kernel=arms["kernel"][0], loss_plain=arms["plain"][0], loss_rel=loss_rel,
         grad_rel=grad_rel, tol_loss_rel=1e-5, tol_grad_rel=1e-3)
    if loss_rel > 1e-5 or any(r > 1e-3 for r in grad_rel.values()):
        raise AssertionError(f"fp32 sparse step: kernel vs plain loss {loss_rel}, grads {grad_rel}")
    del arms

    # a key_padding_mask takes the emulation by JAX's rule: no K7 launch on that call
    mask = torch.ones(SPARSE_B, SPARSE_T, dtype=torch.bool, device=dev)
    mask[0, -300:] = False
    mask[1, -1000:] = False
    before = _counts()
    with torch.no_grad():
        out = attn(hidden, *(m.to(torch.bfloat16) for m in masters.values()), attention_mask=mask)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
    finite = bool(torch.isfinite(out.float()).all().item())
    emit(phase="sparse_masked_call", path="block_sparse_attention (emulation)", launches=moved, finite=finite,
         shape=list(out.shape))
    if moved or not finite or out.shape != (SPARSE_B, SPARSE_T, H):
        raise AssertionError(f"masked call: launches {moved}, finite {finite}, shape {tuple(out.shape)}")
    torch.cuda.empty_cache()
    return counts, variants


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # phase 1: the card and the kernel build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    sources = ["ragged_paged_attention", "decode_attention", "flash_attention", "block_sparse_attention"]
    libs = native.build_many(sources)  # one nvcc per source, all started together
    emit(phase="device", name=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0,
         builds={name: dict(library=lib.split("/")[-1], nvcc_s=native.build_log.get(name, {}).get("seconds"),
                            ptxas=[line.strip() for line in native.build_log.get(name, {}).get("ptxas", "").splitlines()
                                   if "Used" in line or "spill" in line])
                 for name, lib in zip(sources, libs)})

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB > the 50 MB L2
    cases = phase_kernel(dev, flush)
    del flush

    cfg = llama_config("1b")
    t0 = time.perf_counter()
    tree = _weights(cfg, args.seed)
    emit(phase="serve", event="weights_made", seconds=time.perf_counter() - t0)
    launches, split_launches, serve_streams = phase_serve(cfg, tree, args.seed)
    phase_streams(llama_config("1b", dtype="float32"), tree, args.seed, dev)

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    k6_cases = phase_decode_kernel(dev, flush)
    k5_cases = phase_paged_kernel(dev, flush)
    del flush
    k6_launches, k6_split_launches = phase_generate(cfg, tree, args.seed)
    k5_launches, k5_split_launches = phase_bucketed(cfg, tree, args.seed)
    phase_three_way(llama_config("1b", dtype="float32"), tree, args.seed, dev)
    windows = phase_windows(cfg, tree, args.seed, serve_streams)
    del tree

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    flash = phase_flash(dev, flush)
    del flush
    train_counts, train_variants = phase_train(args.seed, dev)
    phase_train_fp32(args.seed, dev)

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    sparse = phase_sparse_kernels(dev, flush)
    del flush
    sparse_counts, sparse_variants = phase_sparse_train(args.seed, dev)

    main_case = next(c for c in cases if c["case"] == "W=1 bfloat16")
    k6_main = next(c for c in k6_cases if c["case"] == f"{DECODE_MAIN} bfloat16")
    k5_main = next(c for c in k5_cases if c["case"] == "bucket 8 W=1 bfloat16")
    keys = ("case", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit(kernels=[dict(
        name="ragged_paged_attention", route="cuda",
        source="deepspeed_tpu_torch/csrc/ragged_paged_attention.cu",
        replaces="deepspeed_tpu/ops/transformer/decode_attention.py:209",
        launches=launches, max_abs_err=main_case["max_abs_err"], ms=main_case["ms"],
        plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"], case=main_case["case"], variant="split_kv",
        split_launches=split_launches, splits=main_case["splits"], windows=windows,
        cases=[{k: c[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "splits", "bitwise_equal")} for c in cases],
    )] + [dict(
        name=name, route="cuda", source="deepspeed_tpu_torch/csrc/flash_attention.cu",
        replaces=f"deepspeed_tpu/ops/transformer/flash_attention.py:{line}",
        launches=train_counts[name],
        max_abs_err=flash["bfloat16"]["errors"][name]["max_abs_err"],
        case=f"{FLASH_MAIN} bfloat16",
        **{k: flash["bfloat16"]["timing"][name][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_share")},
        fp32={k: flash["float32"]["timing"][name][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        variant={"bfloat16": "tensor_core", "float16": "tensor_core", "float32": "fma"},
        tensor_core_launches=train_variants[f"{name}_tc"],
        fp16={k: flash["float16"]["timing"][name][k] for k in ("ms", "bound_ms", "library_ms")},
    ) for name, line in (("flash_fwd", 63), ("flash_dq", 165), ("flash_dkv", 196))] + [dict(
        name="decode_attention", route="cuda", source="deepspeed_tpu_torch/csrc/decode_attention.cu",
        replaces="deepspeed_tpu/ops/transformer/decode_attention.py:42", launches=k6_launches,
        **{k: k6_main[k] for k in keys}, variant="split_kv", split_launches=k6_split_launches,
        splits=k6_main["splits"], cases=[{k: c[k] for k in keys + ("splits", "bitwise_equal")} for c in k6_cases],
    ), dict(
        name="paged_decode_attention", route="cuda", source="deepspeed_tpu_torch/csrc/decode_attention.cu",
        replaces="deepspeed_tpu/ops/transformer/decode_attention.py:110", launches=k5_launches,
        **{k: k5_main[k] for k in keys}, variant="split_kv", split_launches=k5_split_launches,
        splits=k5_main["splits"], cases=[{k: c[k] for k in keys + ("splits", "bitwise_equal")} for c in k5_cases],
    )] + [dict(
        name=name, route="cuda", source="deepspeed_tpu_torch/csrc/block_sparse_attention.cu",
        replaces=f"deepspeed_tpu/ops/sparse_attention/pallas_block_sparse.py:{line}",
        launches=sparse_counts[name],
        max_abs_err=sparse[(SPARSE_MAIN, "bfloat16")]["errors"][name]["max_abs_err"],
        case=f"{SPARSE_MAIN} bfloat16",
        **{k: sparse[(SPARSE_MAIN, "bfloat16")]["timing"][name][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_share")},
        fp32={k: sparse[(SPARSE_MAIN, "float32")]["timing"][name][k]
              for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        bench={dt: {k: sparse[(SPARSE_BENCH, dt)]["timing"][name][k]
                    for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_share")}
               for dt in ("bfloat16", "float32")},
        variant={"bfloat16": "tensor_core", "float16": "tensor_core", "float32": "fma"},
        tensor_core_launches=sparse_variants[f"{name}_tc"],
        **(dict(fp16={k: sparse[(SPARSE_MAIN, "float16")]["timing"][name][k] for k in ("ms", "bound_ms", "library_ms")},
                bench_fp16={k: sparse[(SPARSE_BENCH, "float16")]["timing"][name][k]
                            for k in ("ms", "bound_ms", "library_ms")})
           if name in ("block_sparse_fwd", "block_sparse_dq") else {}),
    ) for name, line in (("block_sparse_fwd", 78), ("block_sparse_dq", 163), ("block_sparse_dkv", 194))])
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
