"""Wrapper of the CUDA ragged paged-attention kernel (K4).

Replaces ``deepspeed_tpu/ops/transformer/decode_attention.py:_ragged_kernel``
(the Pallas kernel behind ``ragged_paged_attention``, ``pallas_call`` at
``:313``). The kernel is ``csrc/ragged_paged_attention.cu``, built with
``nvcc`` on first use and bound through ``ctypes``
(``ops/native.py``). It computes exactly what the Pallas kernel computes:
for row r, query slot w sits at position ``kv_len[r] - q_len[r] + w`` and
sees the keys ``kv_pos <= q_pos`` with ``kv_pos < kv_len[r]``; q, k and v
are read in their dtype and the softmax and P·V run in fp32 with the
scale; the result is written in q's dtype; rows with ``kv_len == 0`` are
exact zeros, and so are window slots past ``q_len``.

This module imports no CUDA tooling at import time: the library is built
and loaded at the first launch. ``launches`` counts the kernel's launches
(one per call that reaches the kernel) and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

launches = 0  # kernel launches since the caller last set it to 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)
_fn = None


def _entry():
    global _fn
    if _fn is None:
        from deepspeed_tpu_torch.ops import native

        fn = native.load("ragged_paged_attention").ragged_paged_attention
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int]  # dtype code
            + [ctypes.c_void_p] * 7  # q, k_pages, v_pages, page_table, kv_lens, q_lens, out
            + [ctypes.c_int] * 8  # R, W, NH, NKV, NP, P, D, MAXP
            + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
        )
        _fn = fn
    return _fn


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
    """Launch the CUDA kernel on the current stream; returns ``[R, W, NH, D]``
    in q's dtype. Raises on a tensor the kernel does not take and on a
    non-zero ``cudaError_t`` from the launch. Does not synchronise."""
    global launches
    _check(q, k_pages, v_pages, page_table, kv_lens, q_lens)
    R, W, NH, D = q.shape
    NP, NKV, P, _ = k_pages.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype],
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            kv_lens.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
            R, W, NH, NKV, NP, P, D, page_table.shape[1],
            float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: cudaError_t {err}")
    launches += 1
    return out
