#!/usr/bin/env python3
"""Smoke run of deepspeed_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the package's CUDA kernels from ``deepspeed_tpu_torch/csrc`` and
drives the serving main path at full width. Phases, each printing JSON
lines; any failure raises, and the script then exits non-zero without the
final line:

1. device: the card (``nvidia-smi`` name and power limit) and the kernel
   build (nvcc time, ptxas register/shared-memory report);
2. the ragged paged-attention kernel (K4) against its plain PyTorch version
   at the serving shapes of llama-1B (R=8, NH=32, NKV=4, D=64, P=16,
   MAXP=128, NP=1025): a W=1 decode batch and a W=32 mixed batch, fp32 with
   TF32 off (max abs error <= 1e-4) and bf16 (<= 2e-2 against the plain
   version in fp32 on the same bf16 inputs); dead rows must be exact zeros.
   Times the kernel, the plain version and a yardstick
   (``scaled_dot_product_attention`` over K/V pre-gathered into a
   contiguous cache: it omits the page walk, and the port never calls it),
   each with the L2 cache flushed before every launch;
3. the main path: ``init_inference(TransformerLM(llama_config("1b")),
   dtype="bf16", paged_kv={"page_size": 16, "max_slots": 8})`` with seeded
   random weights loaded through ``load_jax_params``, serving 16 requests
   twice (cold, then warm with cached prefixes); the kernel's launch count
   is zeroed just before and read just after, and must equal
   22 × ``ragged_steps``;
4. greedy-stream identity in fp32 (TF32 off): 4 requests × 32 tokens with
   ``attn_impl="kernel"`` against ``"plain"``; where streams part, the plain
   run's top-2 logit gap at that position must be below 1e-4.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.inference import decode
from deepspeed_tpu_torch.models import TransformerLM, llama_config
from deepspeed_tpu_torch.models.transformer import param_shapes
from deepspeed_tpu_torch.ops import native
from deepspeed_tpu_torch.ops.transformer import decode_attention
from deepspeed_tpu_torch.ops.transformer.paged_attention import ragged_paged_attention

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # bf16 tensor core; fp32 without TF32
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
    on a non-finite live slot, or on a dead row that is not exact zeros.
    Returns (max abs error on live slots, the cast inputs)."""
    q, kp, vp, pt, kv_lens, q_lens = args
    qd, kd, vd = q.to(dtype), kp.to(dtype), vp.to(dtype)
    ref = ragged_paged_attention(qd.float(), kd.float(), vd.float(), pt, kv_lens, q_lens, scale=scale,
                                 impl="plain")
    out = ragged_paged_attention(qd, kd, vd, pt, kv_lens, q_lens, scale=scale, impl="kernel")
    torch.cuda.synchronize()
    live = torch.arange(q.shape[1], device=q.device)[None, :] < q_lens[:, None]  # [R, W]
    err = (out.float() - ref).abs()[live].max().item()
    dead_zero = bool((out[kv_lens == 0] == 0).all().item())
    finite = bool(torch.isfinite(out.float()[live]).all().item())
    if not (err <= tol and dead_zero and finite):
        raise AssertionError(f"K4 {label} {dtype}: max_abs_err {err} (tol {tol}), dead rows zero "
                             f"{dead_zero}, finite {finite}")
    return err, (qd, kd, vd, pt, kv_lens, q_lens)


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
    W = q.shape[1]
    idx = pt.long().clamp(0, NP - 1)
    kc = kp[idx].permute(0, 2, 1, 3, 4).reshape(R, NKV, MAXP * P, D).contiguous()
    vc = vp[idx].permute(0, 2, 1, 3, 4).reshape(R, NKV, MAXP * P, D).contiguous()
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
            err, cast = _compare(label, args, scale, dtype, tol)
            ms = _time_ms(lambda: ragged_paged_attention(*cast, scale=scale, impl="kernel"), 50, flush)
            plain_ms = _time_ms(lambda: ragged_paged_attention(*cast, scale=scale, impl="plain"), 20, flush)
            sq, sk, sv, mask = _sdpa_inputs(*cast)
            library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, scale=scale, enable_gqa=True), 50, flush)
            q, _, _, pt, kv_lens, q_lens = args
            bound_ms, bound_by, nbytes, flops = _bound(q, pt, kv_lens, q_lens, dtype)
            case = dict(case=f"{label} {str(dtype).replace('torch.', '')}", max_abs_err=err, tol=tol,
                        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by, bytes=nbytes, flops=flops, roofline_share=bound_ms / ms)
            emit(phase="kernel", kernel="ragged_paged_attention", dead_rows_exact_zero=True, **case,
                 library="scaled_dot_product_attention over pre-gathered contiguous K/V (omits the page walk)")
            cases.append(case)
    # beyond the main path's shapes (correctness only): head_dim 128, a GQA
    # group of 7, pages of 64 keys across the kernel's 32-key tiles
    other = dict(nh=28, nkv=4, d=128, p=64, maxp=8, np_=24)
    args = _batch(rs, 5, [(300, 1), (70, 5), (0, 0), (5, 5), (129, 3)], dev, **other)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        err, _ = _compare("D=128 Hg=7 P=64", args, 1.0 / np.sqrt(128), dtype, tol)
        emit(phase="kernel", kernel="ragged_paged_attention", case=f"D=128 Hg=7 P=64 W=5 {dtype}",
             max_abs_err=err, tol=tol, dead_rows_exact_zero=True)
    return cases


# --- phase 3: the serving main path ------------------------------------------
def _weights(cfg, seed):
    """The JAX tree layout as numpy with the distributions of the JAX
    ``TransformerLM.init`` (normal std 0.02, output projections
    0.02/sqrt(2L), norm scales 1, biases 0), from
    ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, shape in param_shapes(cfg).items():
        name = path.rsplit("/", 1)[-1]
        if "norm_scale" in name:
            tree[path] = np.ones(shape, np.float32)
        elif name.startswith("b") or name.endswith("bias"):
            tree[path] = np.zeros(shape, np.float32)
        else:
            std = 0.02 / np.sqrt(2 * cfg.num_layers) if name in ("wo", "w_out") else 0.02
            leaf = rng.standard_normal(shape, dtype=np.float32)
            leaf *= std
            tree[path] = leaf
    return tree


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
    decode_attention.launches = 0  # counts from here are the main path's
    passes = []
    for name in ("cold", "warm"):
        before = engine.serve_stats() or {"prefix": {"prefix_hit_tokens": 0, "prefix_query_tokens": 0},
                                          "ragged_steps": 0}
        t0 = time.perf_counter()
        outs = engine.serve(prompts, max_new_tokens=budgets)
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
    launches = decode_attention.launches
    s = engine.serve_stats()
    summary = dict(phase="serve", pass_="both", ttft_ms=s["ttft_ms"], tpot_ms=s["tpot_ms"],
                   ragged_steps=s["ragged_steps"], finished=s["finished"], preempted=s["preempted"],
                   prefix=s["prefix"], k4_launches=launches, num_pages=engine._paged_server.pool.num_pages,
                   kv_pool_bytes=engine._paged_server.pool.cache.hbm_bytes(),
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
    emit(**summary)
    if s["finished"] != 32 or passes[1]["prefix_hit_rate"] <= 0:
        raise AssertionError(f"serve: finished {s['finished']} of 32, warm prefix hit rate {passes[1]['prefix_hit_rate']}")
    if launches != cfg.num_layers * s["ragged_steps"] or launches == 0:
        raise AssertionError(f"K4 launches {launches} != {cfg.num_layers} x ragged_steps {s['ragged_steps']}")
    del engine, model
    torch.cuda.empty_cache()
    return launches


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
    lib = native.build("ragged_paged_attention")
    info = native.build_log.get("ragged_paged_attention", {})
    emit(phase="device", name=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0, library=lib.split("/")[-1],
         ptxas=[line.strip() for line in info.get("ptxas", "").splitlines() if "Used" in line or "spill" in line])

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB > the 50 MB L2
    cases = phase_kernel(dev, flush)
    del flush

    cfg = llama_config("1b")
    t0 = time.perf_counter()
    tree = _weights(cfg, args.seed)
    emit(phase="serve", event="weights_made", seconds=time.perf_counter() - t0)
    launches = phase_serve(cfg, tree, args.seed)
    phase_streams(llama_config("1b", dtype="float32"), tree, args.seed, dev)

    main_case = next(c for c in cases if c["case"] == "W=1 bfloat16")
    emit(kernels=[dict(
        name="ragged_paged_attention", route="cuda",
        source="deepspeed_tpu_torch/csrc/ragged_paged_attention.cu",
        replaces="deepspeed_tpu/ops/transformer/decode_attention.py:209",
        launches=launches, max_abs_err=main_case["max_abs_err"], ms=main_case["ms"],
        plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"], case=main_case["case"],
        cases=[{k: c[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")} for c in cases],
    )])
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
