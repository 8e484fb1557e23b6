"""Wrappers of the CUDA decode-attention kernels K4, K5 and K6.

Each replaces a Pallas kernel of
``deepspeed_tpu/ops/transformer/decode_attention.py``; the kernels are built
with ``nvcc`` on first use and bound through ``ctypes`` (``ops/native.py``).

* K4 ``ragged_paged_attention`` (``_ragged_kernel``, ``pallas_call`` at
  ``:313``; ``csrc/ragged_paged_attention.cu``): for row r, query slot w
  sits at position ``kv_len[r] - q_len[r] + w`` and sees the keys
  ``kv_pos <= q_pos`` with ``kv_pos < kv_len[r]``; rows with
  ``kv_len == 0`` are exact zeros, and so are window slots past ``q_len``.
  The CUDA side is split-KV: a split kernel writes per-split partials
  ``(m, l, acc)`` into an fp32 workspace and a combine kernel merges them
  in split order. ``ragged_split_partials_plain`` and
  ``ragged_combine_plain`` are that arithmetic in plain torch (the CPU
  tests hold it against the unsplit plain version; no main path calls
  them). This entry takes CUDA tensors only; the dispatch with the plain
  version is ``paged_attention.ragged_paged_attention``.
* K6 ``decode_attention`` (``_decode_kernel`` :42, ``pallas_call`` :358 in
  ``_grouped_decode``; ``csrc/decode_attention.cu``): one token per row
  over a contiguous cache ``[B, S, NKV, D]``, keys ``< kv_len[b]``
  (clamped into ``[0, S]``). The CUDA side is split-KV with K5's split body
  and combine (``dense_splits(S)`` splits, from the shape alone).
  ``dense_split_partials_plain`` with ``paged_combine_plain`` is that
  arithmetic in plain torch (CPU tests only).
* K5 ``paged_decode_attention`` (``_paged_kernel`` :110, ``pallas_call``
  :199; ``csrc/decode_attention.cu``): one token per row over its pages of
  a shared pool ``[NP, NKV, P, D]``; page ids clamp into ``[0, NP)``. The
  CUDA side is split-KV as K4's is: a split kernel writes per-split
  partials ``(m, l, acc)`` into an fp32 workspace and a combine kernel
  merges them in split order. ``paged_split_partials_plain`` and
  ``paged_combine_plain`` are that arithmetic in plain torch (CPU tests
  only).

All three read q, k and v in their dtype, run the softmax and P·V in fp32
with the scale and write the result in q's dtype. K5 and K6 take a CPU
tensor to their plain version (``decode_attention_plain``, with the
kernel's math; ``paged_decode_attention_plain``, with the JAX XLA path's
math) and launch the kernel for a CUDA tensor, or raise; ``*_kernel`` are
the bare launches, which take CUDA tensors only. ``paged_attention`` builds
its dispatch on these and imports nothing back into this module.

This module imports no CUDA tooling at import time: the library is built
and loaded at the first launch. ``launches`` (K4), ``launches_decode`` (K6)
and ``launches_paged`` (K5) count each kernel's launches (one per call that
reaches the kernel) and nothing else; ``launches_ragged_split``,
``launches_decode_split`` and ``launches_paged_split`` count the K4, K6
and K5 calls that ran the split-KV kernel and its combine (every such call
today). A call made while a CUDA graph is being captured counts once, at
the capture: the graph's replays launch again without passing here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

NEG_INF = -1e30

launches = 0  # K4 launches since the caller last set it to 0
launches_ragged_split = 0  # of those, calls that ran the split kernel and the combine
launches_decode = 0  # K6
launches_decode_split = 0  # of those, calls that ran the split kernel and the combine
launches_paged = 0  # K5
launches_paged_split = 0  # of those, calls that ran the split kernel and the combine

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)
_fn = None
_split_keys = None  # keys a split of K4 holds (the C side's SPLIT)
_decode_fns = {}
_decode_split_keys = None  # keys a split of K5 and K6 holds (the C side's SPLIT)


def _entry():
    global _fn, _split_keys
    if _fn is None:
        from deepspeed_tpu_torch.ops import native

        lib = native.load("ragged_paged_attention")
        fn = lib.ragged_paged_attention
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int]  # dtype code
            + [ctypes.c_void_p] * 9  # q, k_pages, v_pages, page_table, kv_lens, q_lens, out, ws_ml, ws_acc
            + [ctypes.c_int] * 9  # R, W, NH, NKV, NP, P, D, MAXP, nsplit
            + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
        )
        lib.ragged_paged_attention_split_keys.restype = ctypes.c_int
        _split_keys = int(lib.ragged_paged_attention_split_keys())
        _fn = fn
    return _fn


def ragged_splits(maxp: int, page_size: int) -> int:
    """The number of key splits K4 launches for a table of ``maxp`` pages of
    ``page_size`` keys: from the shapes alone, never from ``kv_lens``."""
    _entry()
    return -(-maxp * page_size // _split_keys)


def _check(q, k_pages, v_pages, page_table, kv_lens, q_lens):
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA ragged attention kernel takes CUDA tensors, got q on {q.device}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages), ("page_table", page_table),
                    ("kv_lens", kv_lens), ("q_lens", q_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16, float16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"k/v pages ({k_pages.dtype}, {v_pages.dtype}) must match q ({q.dtype})")
    for name, t in (("page_table", page_table), ("kv_lens", kv_lens), ("q_lens", q_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"q must be [R, W, NH, D] and pages [NP, NKV, P, D], got {tuple(q.shape)}, {tuple(k_pages.shape)}")
    R, W, NH, D = q.shape
    NP, NKV, P, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"pages {tuple(k_pages.shape)} / {tuple(v_pages.shape)} do not match head_dim {D}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported by the kernel (supported: {_HEAD_DIMS})")
    if NH % NKV:
        raise ValueError(f"query heads {NH} not a multiple of kv heads {NKV}")
    if page_table.dim() != 2 or page_table.shape[0] != R or kv_lens.shape != (R,) or q_lens.shape != (R,):
        raise ValueError(
            f"page_table {tuple(page_table.shape)}, kv_lens {tuple(kv_lens.shape)}, "
            f"q_lens {tuple(q_lens.shape)} do not match R={R}"
        )
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the kernel's vector loads")


def ragged_paged_attention(q, k_pages, v_pages, page_table, kv_lens, q_lens, scale: float):
    """Launch the CUDA split kernel and its combine on the current stream;
    returns ``[R, W, NH, D]`` in q's dtype. The fp32 partials go to a
    workspace sized from the shapes (``torch.empty``: the caching allocator
    hands the same block back to the next layer). Raises on a tensor the
    kernel does not take and on a non-zero ``cudaError_t`` from either
    launch. Does not synchronise."""
    global launches, launches_ragged_split
    _check(q, k_pages, v_pages, page_table, kv_lens, q_lens)
    R, W, NH, D = q.shape
    NP, NKV, P, _ = k_pages.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = _entry()
    maxp = page_table.shape[1]
    nsplit = ragged_splits(maxp, P)
    partials = R * NKV * nsplit * W * (NH // NKV)
    ws_ml = torch.empty(2 * partials, dtype=torch.float32, device=q.device)
    ws_acc = torch.empty(partials * D, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype],
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            kv_lens.data_ptr(), q_lens.data_ptr(), out.data_ptr(), ws_ml.data_ptr(), ws_acc.data_ptr(),
            R, W, NH, NKV, NP, P, D, maxp, nsplit,
            float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: cudaError_t {err}")
    launches += 1
    launches_ragged_split += 1
    return out


def ragged_split_partials_plain(q, k_pages, v_pages, page_table, kv_lens, q_lens, split_keys: int,
                                scale: float):
    """K4's split kernel in plain torch: for every key split of
    ``split_keys`` keys (``ceil(MAXP·P / split_keys)`` of them), each query
    slot's partial ``(m, l, acc)``: ``m`` its largest visible scaled score in
    the split, ``l = Σ exp(s - m)`` and ``acc = Σ exp(s - m)·v`` over the
    visible keys, in fp32. A slot with no visible key in a split has the
    empty partial ``m = NEG_INF``, ``l = 0``, ``acc = 0``. Returns ``m``,
    ``l`` as ``[R, W, NH, nsplit]`` and ``acc`` as ``[R, W, NH, nsplit, D]``."""
    R, W, NH, D = q.shape
    NP, NKV, P, _ = k_pages.shape
    G = NH // NKV
    S = page_table.shape[1] * P
    nsplit = -(-S // split_keys)
    pad = nsplit * split_keys - S
    k = torch.nn.functional.pad(gather_pages(k_pages, page_table).float(), (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(gather_pages(v_pages, page_table).float(), (0, 0, 0, 0, 0, pad))
    lens = kv_lens.to(torch.int32)
    kv_pos = torch.arange(nsplit * split_keys, dtype=torch.int32, device=q.device)
    q_pos = (lens - q_lens.to(torch.int32))[:, None] + torch.arange(W, dtype=torch.int32, device=q.device)[None, :]
    live = (kv_pos[None, None, :] <= q_pos[:, :, None]) & (kv_pos[None, None, :] < lens[:, None, None])
    live = live.reshape(R, W, 1, 1, nsplit, split_keys)  # [R, W, NKV, G, split, key]
    qg = q.float().reshape(R, W, NKV, G, D)
    kg = k.reshape(R, nsplit, split_keys, NKV, D)
    s = torch.einsum("rwkgd,rnjkd->rwkgnj", qg, kg) * scale
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(live, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("rwkgnj,rnjkd->rwkgnd", p, v.reshape(R, nsplit, split_keys, NKV, D))
    m = torch.where(l > 0, m, torch.full_like(m, NEG_INF))
    return m.reshape(R, W, NH, nsplit), l.reshape(R, W, NH, nsplit), acc.reshape(R, W, NH, nsplit, D)


def ragged_combine_plain(m, l, acc, kv_lens, q_lens, dtype):
    """K4's combine in plain torch, the kernel's formula in its order: over
    the splits of each slot, skipping empty partials (``l == 0``),
    ``M = max m``, then ``L += exp(m - M)·l`` and ``O += exp(m - M)·acc``
    split by split, ``O / L`` (``L == 0`` divides by 1). Rows with
    ``kv_len == 0`` and slots ``w >= q_len`` are exact zeros. Returns
    ``[R, W, NH, D]`` in ``dtype``."""
    W, nsplit = m.shape[1], m.shape[3]
    full = l > 0
    M = torch.where(full, m, torch.full_like(m, NEG_INF)).amax(dim=-1)
    L = torch.zeros_like(M)
    out = torch.zeros(acc.shape[:3] + acc.shape[4:], dtype=torch.float32, device=acc.device)
    for s in range(nsplit):
        wgt = torch.where(full[..., s], torch.exp(m[..., s] - M), torch.zeros_like(M))
        L = L + wgt * l[..., s]
        out = out + wgt[..., None] * torch.where(full[..., s, None], acc[..., s, :], torch.zeros_like(out))
    out = out / torch.where(L == 0, torch.ones_like(L), L)[..., None]
    w = torch.arange(W, device=m.device)
    live = (kv_lens[:, None] > 0) & (w[None, :] < q_lens[:, None])  # [R, W]
    return torch.where(live[:, :, None, None], out, torch.zeros_like(out)).to(dtype)


# --- K5 and K6: one query token per row ---------------------------------------
def _decode_entry(name: str):
    """The ctypes function ``name`` of ``csrc/decode_attention.cu``."""
    fn = _decode_fns.get(name)
    if fn is None:
        from deepspeed_tpu_torch.ops import native

        fn = getattr(native.load("decode_attention"), name)
        fn.restype = ctypes.c_int
        if name == "dense_decode_attention":
            fn.argtypes = (
                [ctypes.c_int]  # dtype code
                + [ctypes.c_void_p] * 7  # q, k_cache, v_cache, kv_lens, out, ws_ml, ws_acc
                + [ctypes.c_int] * 6  # B, NH, NKV, S, D, nsplit
                + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
            )
        else:
            fn.argtypes = (
                [ctypes.c_int]
                + [ctypes.c_void_p] * 8  # q, k_pages, v_pages, page_table, kv_lens, out, ws_ml, ws_acc
                + [ctypes.c_int] * 8  # B, NH, NKV, NP, P, D, MAXP, nsplit
                + [ctypes.c_float, ctypes.c_void_p]
            )
        _decode_fns[name] = fn
    return fn


def _k5_k6_split_keys() -> int:
    """Keys a K5 or K6 split holds, read once from the built library."""
    global _decode_split_keys
    if _decode_split_keys is None:
        from deepspeed_tpu_torch.ops import native

        lib = native.load("decode_attention")
        lib.decode_split_keys.restype = ctypes.c_int
        _decode_split_keys = int(lib.decode_split_keys())
    return _decode_split_keys


def paged_splits(maxp: int, page_size: int) -> int:
    """The number of key splits K5 launches for a table of ``maxp`` pages of
    ``page_size`` keys: from the shapes alone, never from ``kv_lens``."""
    return -(-maxp * page_size // _k5_k6_split_keys())


def dense_splits(S: int) -> int:
    """The number of key splits K6 launches for a cache of ``S`` positions:
    from the shape alone, never from ``kv_lens``."""
    return -(-S // _k5_k6_split_keys())


def _scale(scale, D: int) -> float:
    return float(scale) if scale is not None else 1.0 / float(np.sqrt(D))


def lengths_tensor(kv_len, B: int, device) -> torch.Tensor:
    """``kv_len`` (a scalar or ``[B]``) as an int32 ``[B]`` tensor on ``device``."""
    if isinstance(kv_len, torch.Tensor):
        return torch.broadcast_to(kv_len.to(device=device, dtype=torch.int32), (B,)).contiguous()
    return torch.full((B,), int(kv_len), dtype=torch.int32, device=device)


def _check_decode_args(q, k, v, label):
    """The JAX argument checks of both entries: q ``[B, NH, D]``, k/v of
    one shape whose last two axes are ``(NKV, ·, D)`` (pool) or
    ``(·, NKV, D)`` (cache) as the caller unpacks them."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"{label}: q must be [B, NH, D] and k/v 4-D, got {tuple(q.shape)}, {tuple(k.shape)}")
    if v.shape != k.shape or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"{label}: k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")


def _check_dense_args(q, k_cache, v_cache):
    _check_decode_args(q, k_cache, v_cache, "decode_attention")
    B, NH, _ = q.shape
    if k_cache.shape[0] != B:
        raise ValueError(f"cache batch {k_cache.shape[0]} != q batch {B}")
    if NH % k_cache.shape[2]:
        raise ValueError(f"query heads {NH} not a multiple of kv heads {k_cache.shape[2]}")


def _check_paged_args(q, k_pages, v_pages, page_table):
    _check_decode_args(q, k_pages, v_pages, "paged_decode_attention")
    B, NH, _ = q.shape
    if NH % k_pages.shape[1]:
        raise ValueError(f"query heads {NH} not a multiple of kv heads {k_pages.shape[1]}")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table {tuple(page_table.shape)} does not match B={B}")


def _check_kernel_tensors(label, q, *tensors):
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA {label} kernel takes CUDA tensors, got q on {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16, float16)")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not supported by the kernel (supported: {_HEAD_DIMS})")
    for name, t in (("q", q),) + tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in tensors:
        if name in ("k", "v") and t.dtype != q.dtype:
            raise TypeError(f"{name} ({t.dtype}) must match q ({q.dtype})")
        if name in ("page_table", "kv_lens") and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q),) + tensors[:2]:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the kernel's vector loads")


def decode_attention_plain(q, k_cache, v_cache, kv_len, scale=None):
    """K6's plain version, with the kernel's math: q, k and v in fp32, the
    masked softmax and P·V in fp32, the result in q's dtype, rows with
    ``kv_len == 0`` exact zeros."""
    _check_dense_args(q, k_cache, v_cache)
    B, NH, D = q.shape
    S, NKV = k_cache.shape[1], k_cache.shape[2]
    lens = lengths_tensor(kv_len, B, q.device)
    qg = q.float().reshape(B, NKV, NH // NKV, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * _scale(scale, D)
    live = torch.arange(S, device=q.device)[None, :] < lens[:, None]  # [B, S]
    scores = scores.masked_fill(~live[:, None, None, :], NEG_INF)
    out = torch.einsum("bkgs,bskd->bkgd", torch.softmax(scores, dim=-1), v_cache.float())
    out = out.masked_fill((lens <= 0)[:, None, None, None], 0.0)
    return out.reshape(B, NH, D).to(q.dtype)


def decode_attention_kernel(q, k_cache, v_cache, kv_lens, scale: float):
    """Launch K6's split kernel and its combine on the current stream: q
    ``[B, NH, D]``, caches ``[B, S, NKV, D]`` in q's dtype, ``kv_lens [B]``
    int32, all contiguous CUDA tensors; returns ``[B, NH, D]``. The fp32
    partials go to a workspace sized from the shapes (``torch.empty``).
    Raises on a tensor the kernel does not take and on a non-zero
    ``cudaError_t``. Does not synchronise."""
    global launches_decode, launches_decode_split
    _check_kernel_tensors("decode attention", q, ("k", k_cache), ("v", v_cache), ("kv_lens", kv_lens))
    _check_dense_args(q, k_cache, v_cache)
    B, NH, D = q.shape
    S, NKV = k_cache.shape[1], k_cache.shape[2]
    if kv_lens.shape != (B,):
        raise ValueError(f"kv_lens {tuple(kv_lens.shape)} does not match B={B}")
    out = torch.empty_like(q)
    fn = _decode_entry("dense_decode_attention")
    nsplit = dense_splits(S)
    ws_ml = torch.empty(2 * B * NH * nsplit, dtype=torch.float32, device=q.device)
    ws_acc = torch.empty(B * NH * nsplit * D, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), ws_ml.data_ptr(), ws_acc.data_ptr(), B, NH, NKV, S, D, nsplit,
            float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError_t {err}")
    launches_decode += 1
    launches_decode_split += 1
    return out


def dense_split_partials_plain(q, k_cache, v_cache, kv_lens, split_keys: int, scale: float):
    """K6's split kernel in plain torch: the contiguous cache read as one
    page of ``S`` keys a row, then K5's partials
    (``paged_split_partials_plain``), kv_len clamped into ``[0, S]`` as the
    kernel clamps it. ``paged_combine_plain`` is its combine. Returns
    ``m``, ``l`` as ``[B, NH, nsplit]`` and ``acc`` as
    ``[B, NH, nsplit, D]``, ``nsplit = ceil(S / split_keys)``."""
    B = q.shape[0]
    table = torch.arange(B, dtype=torch.int32, device=q.device)[:, None]
    return paged_split_partials_plain(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2), table, kv_lens,
                                      split_keys, scale)


def decode_attention(q, k_cache, v_cache, kv_len, scale=None, block_k: int = 256):
    """K6: one token per row over a contiguous cache. q ``[B, NH, D]``,
    ``k_cache`` / ``v_cache`` ``[B, S, NKV, D]`` (no GQA expansion),
    ``kv_len`` a scalar or ``[B]``. ``block_k`` is the TPU kernel's cache
    block, kept for its checks (``S`` must divide into blocks of
    ``min(block_k, S)``); the CUDA kernel tiles on its own. A CPU tensor
    takes the plain version, a CUDA tensor the kernel; each checks the
    remaining arguments."""
    S = k_cache.shape[1]
    blk = min(block_k, S)
    if S % blk:
        raise ValueError(f"cache capacity {S} not divisible by block_k {blk}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_len, scale)
    return decode_attention_kernel(q.contiguous(), k_cache, v_cache, lengths_tensor(kv_len, q.shape[0], q.device),
                                   _scale(scale, q.shape[-1]))


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """``[NP, NKV, P, D]`` pool + ``[B, MAXP]`` table -> ``[B, MAXP*P, NKV, D]``
    linear view (kv position s lives in table slot s // P at offset s % P);
    ids clamp into ``[0, NP)``."""
    NP, NKV, P, D = pages.shape
    B, maxp = page_table.shape
    pt = page_table.long().clamp(0, NP - 1)
    return pages[pt].permute(0, 1, 3, 2, 4).reshape(B, maxp * P, NKV, D)


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, kv_len, scale=None):
    """K5's plain version, with the math of the JAX
    ``paged_decode_attention_xla``: scores in the input dtype, the masked
    softmax in fp32, probabilities cast to v's dtype before P·V, and rows
    of length 0 exact zeros."""
    _check_paged_args(q, k_pages, v_pages, page_table)
    B, NH, D = q.shape
    NKV, P = k_pages.shape[1], k_pages.shape[2]
    S = page_table.shape[1] * P
    k = gather_pages(k_pages, page_table)  # [B, S, NKV, D]
    v = gather_pages(v_pages, page_table)
    lens = lengths_tensor(kv_len, B, q.device)
    qg = q.reshape(B, NKV, NH // NKV, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k).float() * _scale(scale, D)
    live = torch.arange(S, dtype=torch.int32, device=q.device)[None, :] < lens[:, None]
    scores = scores.masked_fill(~live[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v)
    out = out.masked_fill((lens <= 0)[:, None, None, None], 0)
    return out.reshape(B, NH, D)


def paged_split_partials_plain(q, k_pages, v_pages, page_table, kv_lens, split_keys: int, scale: float):
    """K5's split kernel in plain torch: K4's partials
    (``ragged_split_partials_plain``) at one query token a row, with kv_len
    clamped into ``[0, MAXP·P]`` as the kernel clamps it. Returns ``m``,
    ``l`` as ``[B, NH, nsplit]`` and ``acc`` as ``[B, NH, nsplit, D]``; a
    split with no live key holds the empty partial (``l == 0``)."""
    lens = kv_lens.to(torch.int32).clamp(0, page_table.shape[1] * k_pages.shape[2])
    m, l, acc = ragged_split_partials_plain(q[:, None], k_pages, v_pages, page_table, lens,
                                            (lens > 0).to(torch.int32), split_keys, scale)
    return m[:, 0], l[:, 0], acc[:, 0]


def paged_combine_plain(m, l, acc, kv_lens, dtype):
    """K5's combine in plain torch: ``ragged_combine_plain`` at one query
    token a row (the splits below kv_len merged in split order, empty ones
    skipped), rows with ``kv_len <= 0`` exact zeros. Returns ``[B, NH, D]``
    in ``dtype``."""
    lens = kv_lens.to(torch.int32)
    return ragged_combine_plain(m[:, None], l[:, None], acc[:, None], lens, (lens > 0).to(torch.int32), dtype)[:, 0]


def paged_decode_attention_kernel(q, k_pages, v_pages, page_table, kv_lens, scale: float):
    """Launch K5's split kernel and its combine on the current stream: q
    ``[B, NH, D]``, pools ``[NP, NKV, P, D]`` in q's dtype, ``page_table
    [B, MAXP]`` and ``kv_lens [B]`` int32, all contiguous CUDA tensors;
    returns ``[B, NH, D]``. The fp32 partials go to a workspace sized from
    the shapes (``torch.empty``). Raises on a tensor the kernel does not
    take and on a non-zero ``cudaError_t``. Does not synchronise."""
    global launches_paged, launches_paged_split
    _check_kernel_tensors("paged decode attention", q, ("k", k_pages), ("v", v_pages),
                          ("page_table", page_table), ("kv_lens", kv_lens))
    _check_paged_args(q, k_pages, v_pages, page_table)
    B, NH, D = q.shape
    NP, NKV, P, _ = k_pages.shape
    if kv_lens.shape != (B,):
        raise ValueError(f"kv_lens {tuple(kv_lens.shape)} does not match B={B}")
    out = torch.empty_like(q)
    fn = _decode_entry("paged_decode_attention")
    maxp = page_table.shape[1]
    nsplit = paged_splits(maxp, P)
    ws_ml = torch.empty(2 * B * NH * nsplit, dtype=torch.float32, device=q.device)
    ws_acc = torch.empty(B * NH * nsplit * D, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), ws_ml.data_ptr(), ws_acc.data_ptr(),
            B, NH, NKV, NP, P, D, maxp, nsplit, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: cudaError_t {err}")
    launches_paged += 1
    launches_paged_split += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_len, scale=None):
    """K5: one token per row over its pages. q ``[B, NH, D]``, pools
    ``[NP, NKV, P, D]``, ``page_table [B, MAXP]``, ``kv_len`` a scalar or
    ``[B]``. A CPU tensor takes the plain version, a CUDA tensor the
    kernel; each checks the arguments."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table, kv_len, scale)
    return paged_decode_attention_kernel(q.contiguous(), k_pages, v_pages, page_table.to(torch.int32).contiguous(),
                                         lengths_tensor(kv_len, q.shape[0], q.device), _scale(scale, q.shape[-1]))
