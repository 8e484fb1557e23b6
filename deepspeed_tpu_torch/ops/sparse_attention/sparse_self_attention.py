"""Block-sparse self-attention modules.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``
(the reference's ``SparseSelfAttention`` and ``BertSparseSelfAttention``).

* ``block_sparse_attention`` is the port of JAX's dense-gather emulation
  (``:46``): each q block gathers its live kv blocks (``[rows, max_live,
  block, D]``), with per-element masks for dead padding, the causal mask
  inside pairs and a ``key_padding_mask``. Its casts are JAX's: the scores
  product runs in the inputs' dtype and is then widened to fp32 and scaled,
  and the probabilities are cast to v's dtype before P·V.
* ``SparseSelfAttention`` builds the layout of its ``SparsityConfig`` once
  per sequence length and dispatches by JAX's own argument rule (``:156``):
  with no ``key_padding_mask``, ``T % block == 0`` and ``block % 8 == 0`` the
  call takes ``fused_block_sparse_attention`` (the CUDA kernels K7–K9 on a
  CUDA tensor, their plain versions on a CPU one); otherwise it takes the
  emulation. The choice is made from the arguments before any launch, as JAX
  makes it on the TPU; a kernel failure raises and is never caught.
* ``BertSparseSelfAttention`` wraps it with the q/k/v projections of a
  ``[B, T, H]`` hidden state; ``FixedDefault`` is its default layout.

Neither module holds parameters: ``BertSparseSelfAttention`` takes ``wq``,
``wk`` and ``wv`` as call arguments, as in JAX. Both take an optional
``impl`` (``"plain"`` runs the plain versions on the card, as the comparison
arm) that is passed down to the fused path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.sparse_attention.block_sparse import fused_block_sparse_attention
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    DenseSparsityConfig,
    FixedSparsityConfig,
    SparsityConfig,
)

NEG_INF = -1e30


def _layout_gather_indices(layout_h: np.ndarray):
    """Per query-block row: indices of live kv blocks, padded to the max
    row population (padding marked dead)."""
    num_blocks = layout_h.shape[0]
    live = [np.nonzero(layout_h[r])[0] for r in range(num_blocks)]
    max_live = max(max((len(l) for l in live), default=1), 1)
    idx = np.zeros((num_blocks, max_live), dtype=np.int64)
    mask = np.zeros((num_blocks, max_live), dtype=bool)
    for r, l in enumerate(live):
        idx[r, : len(l)] = l
        mask[r, : len(l)] = True
    return idx, mask


def block_sparse_attention(
    q: torch.Tensor,  # [B, NH, T, D]
    k: torch.Tensor,
    v: torch.Tensor,
    layout: np.ndarray,  # [NH or 1, T/block, T/block]
    block: int,
    causal: bool = False,
    scale: Optional[float] = None,
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, T], True = keep
) -> torch.Tensor:
    """Exact attention over the layout's live pairs by dense gathers (the
    JAX package's XLA emulation); rows with no live key give zeros."""
    B, NH, T, D = q.shape
    nb = T // block
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    dev = q.device

    def one_head_group(qh, kh, vh, layout_h, kp_mask):
        # qh: [Bh, T, D] for one head (or heads folded into the batch when the
        # layout is shared); Bh = B or B*NH
        Bh = qh.shape[0]
        idx_np, live_np = _layout_gather_indices(layout_h)
        max_live = idx_np.shape[1]
        idx = torch.from_numpy(idx_np).to(dev)
        qb = qh.reshape(Bh, nb, block, D)
        kg = kh.reshape(Bh, nb, block, D)[:, idx]  # [Bh, nb, max_live, block, D]
        vg = vh.reshape(Bh, nb, block, D)[:, idx]
        scores = torch.einsum("brqd,brlkd->brqlk", qb, kg).float() * scale  # [Bh, nb, block, max_live, block]
        mask = torch.from_numpy(live_np).to(dev)[None, :, None, :, None]
        if causal:
            q_pos = torch.arange(nb, device=dev)[:, None] * block + torch.arange(block, device=dev)[None, :]
            k_pos = idx[:, :, None] * block + torch.arange(block, device=dev)[None, None, :]
            mask = mask & (q_pos[:, :, None, None] >= k_pos[:, None, :, :])[None]
        if kp_mask is not None:
            kp_g = kp_mask.reshape(Bh, nb, block)[:, idx]  # [Bh, nb, max_live, block]
            mask = mask & kp_g[:, :, None, :, :]
        mask = mask.expand(scores.shape)
        scores = scores.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(scores.reshape(Bh, nb, block, max_live * block), dim=-1)
        # rows with no live keys (padded causal heads) -> zero out
        any_live = mask.reshape(Bh, nb, block, -1).any(dim=-1, keepdim=True)
        probs = torch.where(any_live, probs, torch.zeros_like(probs)).to(vh.dtype)
        out = torch.einsum("brqlk,brlkd->brqd", probs.reshape(Bh, nb, block, max_live, block), vg)
        return out.reshape(Bh, T, D)

    if layout.shape[0] == 1:
        # fold heads into the batch: one gather pattern for all heads
        fold = lambda x: x.reshape(B * NH, T, D)  # noqa: E731
        kp = key_padding_mask.repeat_interleave(NH, dim=0) if key_padding_mask is not None else None
        return one_head_group(fold(q), fold(k), fold(v), layout[0], kp).reshape(B, NH, T, D)
    outs = [one_head_group(q[:, h], k[:, h], v[:, h], layout[h], key_padding_mask) for h in range(NH)]
    return torch.stack(outs, dim=1)


class SparseSelfAttention:
    """Reference ``SparseSelfAttention`` module surface: config-driven
    layout, q/k/v in ``[B, NH, T, D]``."""

    def __init__(
        self,
        sparsity_config: SparsityConfig = None,
        key_padding_mask_mode: str = "add",  # noqa: ARG002 - parity
        attn_mask_mode: str = "mul",  # noqa: ARG002
        max_seq_length: int = 2048,
        impl: Optional[str] = None,
    ):
        self.sparsity_config = sparsity_config or DenseSparsityConfig(num_heads=4)
        self.max_seq_length = max_seq_length
        self.impl = impl
        self._layouts = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def __call__(self, query, key, value, key_padding_mask=None, attn_mask=None):  # noqa: ARG002
        T = query.shape[2]
        layout = self.get_layout(T)
        causal = getattr(self.sparsity_config, "attention", "bidirectional") == "unidirectional"
        if not self.sparsity_config.different_layout_per_head:
            layout = layout[:1]
        if key_padding_mask is not None and key_padding_mask.dtype != torch.bool:
            key_padding_mask = key_padding_mask > 0
        block = self.sparsity_config.block
        # JAX's rule (sparse_self_attention.py:156), from the arguments alone:
        # the fused kernels carry the hot path; key-padding masks and odd
        # blocks take the dense-gather emulation
        if key_padding_mask is None and T % block == 0 and block % 8 == 0:
            return fused_block_sparse_attention(query, key, value, layout, block, causal=causal, impl=self.impl)
        return block_sparse_attention(query, key, value, layout, block, causal=causal,
                                      key_padding_mask=key_padding_mask)


class BertSparseSelfAttention:
    """Reference ``BertSparseSelfAttention``: the q/k/v projections around
    ``SparseSelfAttention`` for BERT-shaped inputs ``[B, T, H]``. ``config``
    carries ``num_attention_heads`` and ``hidden_size``."""

    def __init__(self, config, sparsity_config=None, impl: Optional[str] = None):
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.sparse = SparseSelfAttention(sparsity_config or FixedDefault(self.num_heads), impl=impl)

    def __call__(self, hidden, wq, wk, wv, attention_mask=None):
        B, T, H = hidden.shape

        def split(x):
            return x.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2)

        q = split(hidden @ wq)
        k = split(hidden @ wk)
        v = split(hidden @ wv)
        out = self.sparse(q, k, v, key_padding_mask=attention_mask)
        return out.transpose(1, 2).reshape(B, T, H)


def FixedDefault(num_heads: int):  # noqa: N802 - the reference's name
    return FixedSparsityConfig(num_heads=num_heads)
