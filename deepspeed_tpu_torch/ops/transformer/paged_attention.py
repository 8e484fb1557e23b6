"""Ragged paged attention: the plain PyTorch version and the dispatch.

Counterpart of ``deepspeed_tpu/ops/transformer/paged_attention.py``. Every
sequence's KV cache is fixed-size pages in one shared pool
``[num_pages, NKV, page_size, D]`` per layer, addressed through a
per-sequence page table. Table ids < 0 or >= num_pages are sentinels; they
clamp onto page 0 (the pool's reserved trash page) and their scores are
masked by the length, so padded tables are always safe to read.

* ``paged_decode_attention`` — one generated token per row attends over
  its live pages (the bucketed server's decode rounds). On a CUDA tensor
  it launches the hand-written CUDA kernel K5
  (``decode_attention.paged_decode_attention``); on a CPU tensor, or with
  ``impl="plain"``, it runs ``decode_attention.paged_decode_attention_plain``,
  the JAX package's XLA path (``paged_decode_attention_xla``).
* ``paged_prefill_attention`` — a token slab ``[B, T]`` attends causally
  over each row's own pages, optionally capped by ``kv_lens``. Plain
  PyTorch (the JAX package's XLA path, ``paged_attention.py:177``).
* ``ragged_paged_attention`` — the serving step's one attention call:
  mixed prefill-chunk / decode / verify rows in one ``[R, W]`` window,
  driven by per-row ``(kv_len, q_len)`` arrays. On a CUDA tensor it
  launches the hand-written CUDA kernel
  (``decode_attention.ragged_paged_attention``); on a CPU tensor it runs
  the plain version. ``impl="plain"`` runs the plain version on a CUDA
  tensor too, but only when asked for by name (the kernel's comparison
  arm). Nothing here catches a kernel failure and falls back.

GQA is grouped (queries reshape to ``[B, T, NKV, G, D]``), so no path
materializes an NH-wide copy of the cache.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.config import canonical_attn_impl
from deepspeed_tpu_torch.ops.transformer import decode_attention
from deepspeed_tpu_torch.ops.transformer.decode_attention import gather_pages, paged_decode_attention_plain

NEG_INF = decode_attention.NEG_INF


def _scale_or_default(scale: Optional[float], head_dim: int) -> float:
    return float(scale) if scale is not None else 1.0 / float(np.sqrt(head_dim))


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_len,
                           scale: Optional[float] = None, impl: str = "auto"):
    """Single-token paged attention: ``q [B, NH, D]``, pools
    ``[NP, NKV, P, D]``, ``page_table [B, MAXP]`` int32, ``kv_len`` ``[B]``
    (or a scalar) live lengths. ``impl``: ``auto`` / ``kernel`` take K5's
    entry (``decode_attention.paged_decode_attention``: the kernel for a
    CUDA tensor, the plain version for a CPU tensor); ``plain`` forces the
    plain version (the JAX names ``pallas`` / ``xla`` are accepted)."""
    if canonical_attn_impl(impl) == "plain":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table, kv_len, scale=scale)
    return decode_attention.paged_decode_attention(q, k_pages, v_pages, page_table, kv_len, scale=scale)


def paged_prefill_attention(q, k_pages, v_pages, page_table, q_positions,
                            scale: Optional[float] = None, kv_lens=None):
    """Causal slab attention over each sequence's own pages: the query at
    absolute position p sees kv positions <= p (the slab's k/v are already
    scattered into the pages). ``kv_lens [B]`` also caps every row's
    visible range; rows with ``kv_lens == 0`` return exact zeros. Scores
    are taken in the input dtype and softmaxed in fp32, and the
    probabilities are cast to the value dtype before P·V, as the JAX
    version does."""
    B, T, NH, D = q.shape
    NP, NKV, P, _ = k_pages.shape
    if NH % NKV:
        raise ValueError(f"query heads {NH} not a multiple of kv heads {NKV}")
    G = NH // NKV
    S = page_table.shape[1] * P
    scale_f = _scale_or_default(scale, D)
    k = gather_pages(k_pages, page_table)  # [B, S, NKV, D]
    v = gather_pages(v_pages, page_table)
    qg = q.reshape(B, T, NKV, G, D)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k).float() * scale_f
    kv_pos = torch.arange(S, dtype=torch.int32, device=q.device)
    mask = q_positions[:, None, None, :, None] >= kv_pos[None, None, None, None, :]
    if kv_lens is not None:
        lens = kv_lens.to(torch.int32)
        mask = mask & (kv_pos[None, None, None, None, :] < lens[:, None, None, None, None])
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v).reshape(B, T, NH, D)
    if kv_lens is not None:
        out = torch.where((lens > 0)[:, None, None, None], out, torch.zeros_like(out))
    return out


def ragged_paged_attention_plain(q, k_pages, v_pages, page_table, kv_lens, q_lens,
                                 scale: Optional[float] = None):
    """The plain version of the ragged kernel: each row's query slot w sits
    at absolute position ``kv_len - q_len + w``; causality bounds every
    real slot and the ``kv_lens`` cap silences pad slots' reads above the
    live prefix (``paged_attention.py:165-174`` of the JAX package)."""
    W = q.shape[1]
    lens = kv_lens.to(torch.int32)
    qlens = q_lens.to(torch.int32)
    q_positions = (lens - qlens)[:, None] + torch.arange(W, dtype=torch.int32, device=q.device)[None, :]
    return paged_prefill_attention(q, k_pages, v_pages, page_table, q_positions,
                                   scale=scale, kv_lens=lens)


def ragged_paged_attention(q, k_pages, v_pages, page_table, kv_lens, q_lens,
                           scale: Optional[float] = None, impl: str = "auto"):
    """Mixed-row attention for the ragged serving step.

    ``q [R, W, NH, D]``, pools ``[NP, NKV, P, D]``, ``page_table [R, MAXP]``
    int32, ``kv_lens [R]`` (live kv length including this step's tokens),
    ``q_lens [R]`` (real tokens in the window, 0 = dead row). Dead rows
    return exact zeros; window slots past ``q_lens`` carry no contract.

    ``impl``: ``auto`` / ``kernel`` launch the CUDA kernel for a CUDA
    tensor and run the plain version for a CPU tensor; ``plain`` forces
    the plain version (the JAX names ``pallas`` / ``xla`` are accepted)."""
    impl = canonical_attn_impl(impl)
    if impl == "plain" or q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pages, v_pages, page_table, kv_lens, q_lens, scale=scale)
    return decode_attention.ragged_paged_attention(
        q, k_pages, v_pages, page_table, kv_lens, q_lens,
        scale=_scale_or_default(scale, q.shape[-1]),
    )
