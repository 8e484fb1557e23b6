"""The ragged serving step over the paged KV cache.

Counterpart of the ragged path of ``deepspeed_tpu/inference/decode.py``:
the per-layer pieces (``_layer_project_qkv``, ``_ffn_body``,
``_post_attention``, ``_softmax_scale``, ``_final_logits``), the page
scatter, the paged forward's ragged branch, ``_accepted_prefix`` and
``build_ragged_step``. PyTorch runs eagerly, so the "program" is a plain
callable; there is no jit and no compile count.

Numerics follow the JAX functions op for op: norms and RoPE in fp32 cast
back, matmuls in the activation dtype, attention scores softmaxed in fp32.
Weights are already in the engine dtype (``checkpoint/jax_params.py``),
where JAX casts them at each matmul.

The page pools update in place (JAX donates them): each layer scatters its
new k/v into ``k_pages[l]`` / ``v_pages[l]`` BEFORE that layer's attention,
so a chunk row attends to its own just-written tokens.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from deepspeed_tpu_torch.models.config import TransformerConfig
from deepspeed_tpu_torch.models.transformer import _norm, _rope
from deepspeed_tpu_torch.moe.experts import apply_dense_ffn
from deepspeed_tpu_torch.ops.transformer.paged_attention import ragged_paged_attention


def _layer_project_qkv(cfg: TransformerConfig, p, h):
    """Norm + qkv projection for a ``[B, T, H]`` slab."""
    B, T, _ = h.shape
    NH, NKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hn = _norm(h, p["attn_norm_scale"], p.get("attn_norm_bias"), cfg.norm, cfg.norm_eps)
    q = hn @ p["wq"]
    k = hn @ p["wk"]
    v = hn @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(hn.dtype)
        k = k + p["bk"].to(hn.dtype)
        v = v + p["bv"].to(hn.dtype)
    return q.reshape(B, T, NH, D), k.reshape(B, T, NKV, D), v.reshape(B, T, NKV, D)


def _ffn_body(cfg: TransformerConfig, p, x, norm_scale, norm_bias):
    """norm → ffn, NO residual — callers place the residual per architecture."""
    h = _norm(x, norm_scale, norm_bias, cfg.norm, cfg.norm_eps)
    if "moe" in p:
        raise NotImplementedError("MoE serving is not ported yet (ROADMAP M1)")
    return apply_dense_ffn(p, h, cfg.activation)


def _softmax_scale(cfg, head_dim: int) -> float:
    return (
        cfg.attn_softmax_scale
        if getattr(cfg, "attn_softmax_scale", None) is not None
        else 1.0 / float(np.sqrt(head_dim))
    )


def _post_attention(cfg, p, x, attn):
    """Output projection + residual placement + MLP: the shared tail of
    every cached-attention layer."""
    B, T = x.shape[:2]
    a = attn.reshape(B, T, cfg.num_heads * cfg.head_dim)
    attn = (a @ p["wo"]).to(x.dtype)
    if cfg.use_bias:
        attn = attn + p["bo"].to(x.dtype)
    if cfg.parallel_residual:
        # GPT-J/NeoX: the mlp branch reads x (shared ln_1 or its own norm)
        norm_scale = p["attn_norm_scale"] if cfg.shared_parallel_norm else p["mlp_norm_scale"]
        norm_bias = p.get("attn_norm_bias") if cfg.shared_parallel_norm else p.get("mlp_norm_bias")
        return x + attn + _ffn_body(cfg, p, x, norm_scale, norm_bias)
    x = x + attn
    return x + _ffn_body(cfg, p, x, p["mlp_norm_scale"], p.get("mlp_norm_bias"))


def _final_logits(cfg, params, x):
    """Final norm + LM head."""
    x = _norm(x, params["final_norm_scale"], params.get("final_norm_bias"), cfg.norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["tokens"].to(x.dtype).T
    logits = x @ params["lm_head"]
    if cfg.lm_head_bias:
        logits = logits + params["lm_head_bias"].to(logits.dtype)
    return logits


def split_layers(params) -> List[Dict[str, torch.Tensor]]:
    """Per-layer views ``{name: layers[name][l]}`` of the stacked tree."""
    layers = params["layers"]
    L = next(iter(layers.values())).shape[0]
    return [{name: w[l] for name, w in layers.items()} for l in range(L)]


def _accepted_prefix(tokens, greedy, n_drafts):
    """Per-row count of leading drafts (``tokens[:, 1:]``) that match the
    model's own greedy argmax for their positions, bounded by ``n_drafts``."""
    n_slots = tokens.shape[1] - 1
    slots = torch.arange(n_slots, dtype=torch.int32, device=tokens.device)
    matches = (tokens[:, 1:] == greedy[:, :-1]) & (slots[None, :] < n_drafts[:, None])
    return torch.cumprod(matches.to(torch.int32), dim=1).sum(dim=1)


def _scatter_pages(pages_l, vals, page_table, positions, page_size, valid=None):
    """Write ``[B, T, NKV, D]`` new k/v rows into one layer's pool
    ``[NP, NKV, P, D]`` at absolute ``positions [B, T]`` through the page
    table, in place. Sentinel table entries clamp onto the trash page 0, and
    ``valid`` (bool ``[B, T]``) sends masked positions there too, so pad
    slots and dead rows write only where nothing lives."""
    NP = pages_l.shape[0]
    maxp = page_table.shape[1]
    slot = torch.clamp(positions // page_size, 0, maxp - 1).long()
    pid = torch.clamp(torch.gather(page_table, 1, slot), 0, NP - 1)
    if valid is not None:
        pid = torch.where(valid, pid, torch.zeros_like(pid))
    off = positions % page_size
    pages_l[pid.long(), :, off.long(), :] = vals


def _paged_forward(cfg, params, tokens, k_pages, v_pages, page_table, positions_b,
                   attn_impl, write_valid, kv_lens, q_lens, layers=None):
    """Forward ``[R, W]`` ragged rows against the paged cache: per layer,
    scatter the rows' k/v into the pool, then attend through the ragged
    paged attention with per-row ``(kv_lens, q_lens)``. Returns logits
    ``[R, W, V]``; the pools are updated in place."""
    dtype = k_pages.dtype
    P = k_pages.shape[3]
    x = params["embed"]["tokens"].to(dtype)[tokens.long()]
    if cfg.position == "learned":
        # pad slots may sit past max_seq_len; JAX clamps such gathers
        pos = torch.clamp(positions_b, 0, params["embed"]["pos"].shape[0] - 1).long()
        x = x + params["embed"]["pos"].to(dtype)[pos]
    scale = _softmax_scale(cfg, cfg.head_dim)
    for l, p in enumerate(layers if layers is not None else split_layers(params)):
        q, k_new, v_new = _layer_project_qkv(cfg, p, x)
        if cfg.position == "rope":
            q = _rope(q, positions_b, cfg.rope_theta, cfg.rope_dim)
            k_new = _rope(k_new, positions_b, cfg.rope_theta, cfg.rope_dim)
        _scatter_pages(k_pages[l], k_new.to(dtype), page_table, positions_b, P, valid=write_valid)
        _scatter_pages(v_pages[l], v_new.to(dtype), page_table, positions_b, P, valid=write_valid)
        attn = ragged_paged_attention(
            q.contiguous(), k_pages[l], v_pages[l], page_table, kv_lens, q_lens,
            scale=scale, impl=attn_impl,
        )
        x = _post_attention(cfg, p, x, attn)
    return _final_logits(cfg, params, x)


def build_ragged_step(cfg, width: int, attn_impl: str = "auto"):
    """The one serving step: an ``R × width`` ragged window of mixed
    prefill-chunk, decode and dead rows.

    ``step(params, tokens [R, W], k_pages, v_pages, page_table [R, MAXP],
    lengths [R], q_lens [R]) -> out [R, W+1]`` (int32, on the device).
    Row r carries ``q_lens[r]`` real tokens written at positions
    ``lengths[r] + j``; window slots past ``q_lens[r]`` write to the trash
    page. ``out[r, 1 + j]`` is the greedy token after position j, and
    ``out[r, 0]`` the accepted-prefix length of drafted rows (0 wherever
    nothing was drafted). The pools update in place. All arguments are
    tensors on the pools' device."""
    if cfg.position == "alibi":
        raise NotImplementedError("paged serving does not support alibi attention biases")
    if cfg.embed_norm or not cfg.prenorm:
        raise NotImplementedError("embed_norm / post-LN models are not on the paged serving path")
    if width < 1:
        raise ValueError(f"ragged step needs width >= 1, got {width}")
    W = int(width)
    split = {"key": None, "layers": None}

    @torch.no_grad()
    def _step(params, tokens, k_pages, v_pages, page_table, lengths, q_lens):
        if split["key"] is not params["layers"]:
            split["key"], split["layers"] = params["layers"], split_layers(params)
        offs = torch.arange(W, dtype=torch.int32, device=tokens.device)
        positions_b = lengths[:, None] + offs[None, :]
        valid = offs[None, :] < q_lens[:, None]
        kv_lens = torch.where(q_lens > 0, lengths + q_lens, torch.zeros_like(lengths))
        logits = _paged_forward(
            cfg, params, tokens, k_pages, v_pages, page_table, positions_b, attn_impl,
            write_valid=valid, kv_lens=kv_lens, q_lens=q_lens, layers=split["layers"],
        )
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # [R, W], first max on ties
        accepted = _accepted_prefix(tokens, greedy, q_lens - 1)
        return torch.cat([accepted[:, None].to(torch.int32), greedy], dim=1)

    return _step
