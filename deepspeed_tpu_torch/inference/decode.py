"""Incremental decoding: the dense KV-cached loop and the paged serving steps.

Counterpart of ``deepspeed_tpu/inference/decode.py``:

* the dense path: ``KVCache`` / ``init_cache`` (a preallocated
  ``[L, B, max_len, NKV, D]`` workspace), ``_cached_attention``,
  ``_forward_with_cache``, ``build_decoder``, ``generate`` (greedy,
  temperature, top-k, top-p) and ``beam_generate``. Single-token steps whose
  cache length is a multiple of 256 attend through the CUDA kernel K6
  (``decode_attention.decode_attention``), under JAX's own condition;
* the paged serving programs over the page pool: the ragged step
  (``build_ragged_step``, K4), the multi-step window of ``horizon`` ragged
  decode rounds (``build_ragged_multistep``; on a card one CUDA graph,
  ``WindowGraph``) and the bucketed oracle's decode step
  (``build_paged_decode_step``, K5) and prefill chunk
  (``build_paged_prefill``, plain causal attention), all through one
  ``_paged_forward``; with the per-layer pieces (``_layer_project_qkv``,
  ``_ffn_body``, ``_post_attention``, ``_softmax_scale``,
  ``_final_logits``), the page scatter and ``_accepted_prefix``.

PyTorch runs eagerly, so a "program" is a plain callable; there is no jit
and no compile count. ``generate``'s token loop runs on the host, one
forward per token, and synchronises only to test EOS; the serving window is
the one program replayed as a whole (a CUDA graph stands where JAX runs one
jitted ``lax.scan``).

Numerics follow the JAX functions op for op: norms and RoPE in fp32 cast
back, matmuls in the activation dtype, attention scores softmaxed in fp32.
Weights stay in the engine dtype (``checkpoint/jax_params.py``) and are cast
to the activation dtype at each matmul, as JAX's ``qmatmul`` casts them: the
dense cache takes the model config's dtype, which may differ from the
engine's.

Caches update in place where JAX donates them: the dense cache's layer l
takes its new k/v rows before that layer's attention, and the page pools
take each layer's scatter before its attention, so a row attends to its
own just-written tokens.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.inference.sampling import sample_logits
from deepspeed_tpu_torch.models.config import TransformerConfig
from deepspeed_tpu_torch.models.transformer import _FFN_LEAVES, _norm, _rope
from deepspeed_tpu_torch.moe.experts import apply_dense_ffn
from deepspeed_tpu_torch.ops.transformer.decode_attention import decode_attention
from deepspeed_tpu_torch.ops.transformer.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
    ragged_paged_attention,
)

NEG_INF_F = -1e30  # additive mask for dead beams (finite: keeps fp math NaN-free)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _layer_project_qkv(cfg: TransformerConfig, p, h):
    """Norm + qkv projection for a ``[B, T, H]`` slab."""
    B, T, _ = h.shape
    NH, NKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hn = _norm(h, p["attn_norm_scale"], p.get("attn_norm_bias"), cfg.norm, cfg.norm_eps)
    q = hn @ p["wq"].to(hn.dtype)
    k = hn @ p["wk"].to(hn.dtype)
    v = hn @ p["wv"].to(hn.dtype)
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
    ffn = {name: p[name].to(h.dtype) for name in _FFN_LEAVES if name in p}
    return apply_dense_ffn(ffn, h, cfg.activation)


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
    attn = (a @ p["wo"].to(a.dtype)).to(x.dtype)
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
    logits = x @ params["lm_head"].to(x.dtype)
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
                   attn_impl, write_valid=None, kv_lens=None, q_lens=None, attn_lens=None,
                   layers=None):
    """Forward ``[B, T]`` tokens against the paged cache: per layer, scatter
    the rows' k/v into the pool (``write_valid`` sends masked positions to
    the trash page), then attend. Three branches, as in JAX:

    * ``q_lens`` given: the ragged rows of the serving step, through the
      ragged paged attention with per-row ``(kv_lens, q_lens)`` (K4);
    * ``T == 1`` and ``attn_lens`` given: a bucketed decode round, one
      token per row over ``attn_lens`` live positions (K5);
    * otherwise a prefill chunk: causal attention masked by
      ``positions_b`` (and capped by ``kv_lens`` when given), plain.

    ``attn_lens`` is what tells decode from prefill: a ``prefill_chunk=1``
    chunk also has ``T == 1`` but takes the causal path. Returns logits
    ``[B, T, V]``; the pools are updated in place."""
    dtype = k_pages.dtype
    P = k_pages.shape[3]
    T = tokens.shape[1]
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
        if q_lens is not None:
            attn = ragged_paged_attention(
                q.contiguous(), k_pages[l], v_pages[l], page_table, kv_lens, q_lens,
                scale=scale, impl=attn_impl,
            )
        elif T == 1 and attn_lens is not None:
            attn = paged_decode_attention(
                q[:, 0], k_pages[l], v_pages[l], page_table, attn_lens, scale=scale, impl=attn_impl,
            )[:, None]
        else:
            attn = paged_prefill_attention(
                q, k_pages[l], v_pages[l], page_table, positions_b, scale=scale, kv_lens=kv_lens,
            )
        x = _post_attention(cfg, p, x, attn)
    return _final_logits(cfg, params, x)


def _check_cached_cfg(cfg) -> None:
    """The model forms the cached paths serve. ALiBi is refused on every
    cached path: JAX's paged ``build_*`` functions raise for it, while its
    dense ``generate`` drops the slopes without a word
    (``_cached_attention`` applies none), which the port does not copy.
    JAX has no embed_norm / post-LN branch in its cached forward."""
    if cfg.position == "alibi":
        raise NotImplementedError("the KV-cached paths do not support alibi attention biases")
    if cfg.embed_norm or not cfg.prenorm:
        raise NotImplementedError("embed_norm / post-LN models are not on the KV-cached paths")


def _layer_views():
    """``layers_of(params)``: ``split_layers(params)``, redone only when the
    stacked tree changes, so each step callable splits the weights once."""
    memo = {"key": None, "layers": None}

    def layers_of(params):
        if memo["key"] is not params["layers"]:
            memo["key"], memo["layers"] = params["layers"], split_layers(params)
        return memo["layers"]

    return layers_of


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
    _check_cached_cfg(cfg)
    if width < 1:
        raise ValueError(f"ragged step needs width >= 1, got {width}")
    W = int(width)
    layers_of = _layer_views()

    @torch.no_grad()
    def _step(params, tokens, k_pages, v_pages, page_table, lengths, q_lens):
        offs = torch.arange(W, dtype=torch.int32, device=tokens.device)
        positions_b = lengths[:, None] + offs[None, :]
        valid = offs[None, :] < q_lens[:, None]
        kv_lens = torch.where(q_lens > 0, lengths + q_lens, torch.zeros_like(lengths))
        logits = _paged_forward(
            cfg, params, tokens, k_pages, v_pages, page_table, positions_b, attn_impl,
            write_valid=valid, kv_lens=kv_lens, q_lens=q_lens, layers=layers_of(params),
        )
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # [R, W], first max on ties
        accepted = _accepted_prefix(tokens, greedy, q_lens - 1)
        return torch.cat([accepted[:, None].to(torch.int32), greedy], dim=1)

    return _step


def build_ragged_multistep(cfg, rows: int, width: int, horizon: int, attn_impl: str = "auto"):
    """``horizon`` plain-decode rounds of the ragged step body in one call:
    the counterpart of JAX's one-dispatch ``lax.scan`` window, run eagerly
    on the CPU and captured as one CUDA graph on a card (``WindowGraph``).

    ``window(params, tokens [R], k_pages, v_pages, page_table [R, MAXP],
    lengths [R], live [R], eos_ids [R], budgets [R]) -> packed [R, 1+N]``
    (int32, on the device). Row r starts from its pending token
    ``tokens[r]`` at live length ``lengths[r]`` (``live[r] == 0``: a dead
    padding row). Each round writes the carried token at the row's next
    position, attends through the ragged step's entry with per-row
    ``(kv_len, q_len)``, ``q_len`` in {0, 1} (K4), takes the greedy argmax
    (lowest index on ties, as ``jnp.argmax``) and advances the carry. A
    row freezes the round it emits its ``eos_ids[r]`` token (-1: none) or
    its ``budgets[r]``-th token: its ``q_len`` drops to 0, so its writes go
    to the trash page and its length stops, which makes a frozen row look
    like a dead one to every other row. ``packed[:, 0]`` is each row's
    emitted count n and ``packed[:, 1 : 1+n]`` its tokens (-1 after it
    froze). The page table must already cover ``lengths + min(N,
    budget)`` (the scheduler reserves it). The pools update in place. The
    body reads nothing back to the host, so it can be captured. ``width``
    must be 1 (drafted windows are JAX's reserved case)."""
    _check_cached_cfg(cfg)
    if width != 1:
        raise ValueError(f"multi-step windows run plain decode only (width 1), got {width}")
    if rows < 1 or horizon < 2:
        raise ValueError(f"multi-step window needs rows >= 1 and horizon >= 2, got {rows} rows x horizon {horizon}")
    N = int(horizon)
    layers_of = _layer_views()

    @torch.no_grad()
    def _window(params, tokens, k_pages, v_pages, page_table, lengths, live, eos_ids, budgets):
        tok, lens, alive = tokens, lengths, live > 0
        emitted = torch.zeros_like(lengths)
        out = []
        for _ in range(N):
            q_lens = alive.to(torch.int32)  # 1 live, 0 frozen or dead
            kv_lens = torch.where(alive, lens + 1, torch.zeros_like(lens))
            logits = _paged_forward(
                cfg, params, tok[:, None], k_pages, v_pages, page_table, lens[:, None], attn_impl,
                write_valid=alive[:, None], kv_lens=kv_lens, q_lens=q_lens, layers=layers_of(params),
            )
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            out.append(torch.where(alive, nxt, torch.full_like(nxt, -1)))
            emitted = emitted + q_lens
            lens = lens + q_lens
            # freeze after emitting the EOS / budget-hitting token: the
            # scheduler's emit includes that token, as sequential decode does
            alive = alive & (nxt != eos_ids) & (emitted < budgets)
            tok = torch.where(alive, nxt, tok)
        return torch.cat([emitted[:, None], torch.stack(out, dim=1)], dim=1)

    return _window


class WindowGraph:
    """A window (``build_ragged_multistep``) captured once as a
    ``torch.cuda.CUDAGraph`` over fixed buffers: the six int32 inputs in one
    device buffer, the pools' own ``k_pages`` / ``v_pages`` (the page pool
    updates them in place, a copy-on-write included, so their storage
    never moves) and the weights. The kernels' workspaces come from the
    graph's memory pool. A call copies its inputs into the buffer (one
    host-to-device copy), replays, and fetches the packed result (the one
    device-to-host copy). The first call runs the window once eagerly on a
    side stream before the capture (PyTorch's warm-up; its page writes are
    redone by the replay that follows, which writes each position before
    reading it): a kernel wrapper's counter then moves twice per call
    site, once for the warm-up's launch and once for the capture, and the
    replays launch again without passing the wrappers. CUDA events around
    each replay give its device time (``device_ms``, one entry a call; the
    fetch that follows has waited for them). A failed capture raises;
    nothing runs the window eagerly instead."""

    def __init__(self, window, params, k_pages, v_pages, rows: int, max_pages: int):
        self.window = window
        self.params = params
        self.k_pages, self.v_pages = k_pages, v_pages
        self.static = torch.zeros(rows * (5 + max_pages), dtype=torch.int32, device=k_pages.device)
        self.tokens, self.lengths, self.live, self.eos_ids, self.budgets = (
            self.static[i * rows:(i + 1) * rows] for i in range(5))
        self.page_table = self.static[5 * rows:].view(rows, max_pages)
        self.graph = None
        self.out = None
        self.start, self.end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        self.device_ms: deque = deque(maxlen=4096)

    def _run(self):
        return self.window(self.params, self.tokens, self.k_pages, self.v_pages, self.page_table, self.lengths,
                           self.live, self.eos_ids, self.budgets)

    def _capture(self) -> None:
        side = torch.cuda.Stream(self.static.device)
        side.wait_stream(torch.cuda.current_stream(self.static.device))
        with torch.cuda.stream(side):
            self._run()
        torch.cuda.current_stream(self.static.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = self._run()
        self.graph = graph

    def __call__(self, tokens, page_table, lengths, live, eos_ids, budgets) -> np.ndarray:
        flat = np.concatenate([np.ascontiguousarray(a, np.int32).ravel()
                               for a in (tokens, lengths, live, eos_ids, budgets, page_table)])
        self.static.copy_(torch.from_numpy(flat), non_blocking=True)
        if self.graph is None:
            self._capture()
        self.start.record()
        self.graph.replay()
        self.end.record()
        packed = self.out.cpu().numpy()
        self.device_ms.append(self.start.elapsed_time(self.end))
        return packed


# --- the bucketed oracle's programs -------------------------------------------
def build_paged_decode_step(cfg, attn_impl: str = "auto"):
    """One decode round for a slot-bucket batch of rows.

    ``decode_step(params, tokens [B], k_pages, v_pages, page_table [B, MAXP],
    lengths [B]) -> next_tokens [B]`` (int32, on the device): writes each
    row's pending token at position ``lengths[b]``, attends over
    ``lengths[b] + 1`` live positions through the paged decode attention
    (K5), and returns the greedy next token. Dead pad rows (``-1`` tables,
    length 0) write to and read the trash page. The pools update in place."""
    _check_cached_cfg(cfg)
    layers_of = _layer_views()

    @torch.no_grad()
    def _decode(params, tokens, k_pages, v_pages, page_table, lengths):
        logits = _paged_forward(
            cfg, params, tokens[:, None], k_pages, v_pages, page_table, lengths[:, None], attn_impl,
            attn_lens=lengths + 1, layers=layers_of(params),
        )
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)

    return _decode


def build_paged_prefill(cfg, attn_impl: str = "auto"):
    """One prompt chunk of one row.

    ``prefill(params, tokens [1, C], k_pages, v_pages, page_table [1, MAXP],
    start [1], last_idx) -> next_token [1]`` (int32, on the device):
    scatters the chunk's k/v at ``start .. start + C - 1``, attends
    causally (plain: JAX computes it outside any Pallas kernel), and
    returns the greedy token after chunk slot ``last_idx`` (an int). A
    short final chunk arrives padded; its pad slots (past ``last_idx``)
    write to the trash page, since a pad position past the table width
    would otherwise clamp onto the last live page, and no real token sees
    them. The pools update in place."""
    _check_cached_cfg(cfg)
    layers_of = _layer_views()

    @torch.no_grad()
    def _prefill(params, tokens, k_pages, v_pages, page_table, start, last_idx: int):
        offs = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        positions_b = start[:, None] + offs[None, :]
        logits = _paged_forward(
            cfg, params, tokens, k_pages, v_pages, page_table, positions_b, attn_impl,
            write_valid=(offs <= last_idx)[None, :], layers=layers_of(params),
        )
        return torch.argmax(logits[:, last_idx], dim=-1).to(torch.int32)

    return _prefill


# --- the dense KV-cached path -----------------------------------------------------
class KVCache(NamedTuple):
    """Preallocated decode workspace; the forward writes it in place."""

    k: torch.Tensor  # [L, B, max_len, NKV, D]
    v: torch.Tensor  # [L, B, max_len, NKV, D]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, device=None) -> KVCache:
    """Zeroed k and v of ``[L, batch, max_len, NKV, D]``. ``dtype`` defaults
    to the model config's ``dtype`` (as in JAX, whose engine passes none),
    ``device`` to ``cuda`` (raises without a card)."""
    if dtype is None:
        dtype = _DTYPES[cfg.dtype]
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    device = resolve_device(device)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _cached_attention(cfg, q, k_cache, v_cache, q_positions, kv_len_mask, kv_len=None):
    """q ``[B, T, NH, D]`` against one layer's cache ``[B, S, NKV, D]``; keys
    past the valid length are masked. A single-token step with a
    ``kv_len`` and ``S % 256 == 0`` (JAX's condition) goes through K6,
    which reads only the live keys; everything else through the grouped
    einsum, which casts the probabilities to v's dtype."""
    NH, NKV = q.shape[2], k_cache.shape[2]
    scale = _softmax_scale(cfg, q.shape[-1])
    if q.shape[1] == 1 and kv_len is not None and cfg.position != "alibi" and k_cache.shape[1] % 256 == 0:
        return decode_attention(q[:, 0], k_cache, v_cache, kv_len, scale=scale)[:, None]
    B, T, _, D = q.shape
    S = k_cache.shape[1]
    kv_pos = torch.arange(S, dtype=torch.int32, device=q.device)
    mask = q_positions[:, None, :, None] >= kv_pos[None, None, None, :]  # [B, 1, T, S]
    if kv_len_mask is not None:
        mask = mask & kv_len_mask[None, None, None, :]
    # GQA grouped (MHA is G = 1): no NH-wide copy of the cache
    qg = q.reshape(B, T, NKV, NH // NKV, D)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k_cache).float() * scale
    scores = scores.masked_fill(~mask[:, :, None], NEG_INF_F)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    return torch.einsum("bkgts,bskd->btkgd", probs, v_cache).reshape(B, T, NH, D)


def _forward_with_cache(cfg, params, tokens, cache: KVCache, start_pos: int, layers=None):
    """Run ``[B, T]`` tokens starting at ``start_pos``, reading and writing
    the cache in place. Returns ``(logits of the last token [B, V], cache)``."""
    B, T = tokens.shape
    dtype = cache.k.dtype
    dev = cache.k.device
    x = params["embed"]["tokens"].to(dtype)[tokens.long()]
    positions = torch.arange(start_pos, start_pos + T, dtype=torch.int32, device=dev)
    positions_b = positions[None, :].expand(B, T)
    if cfg.position == "learned":
        # past max_seq_len JAX clamps the gather
        pos = torch.clamp(positions, max=params["embed"]["pos"].shape[0] - 1).long()
        x = x + params["embed"]["pos"].to(dtype)[pos][None]
    S = cache.max_len
    end = start_pos + T
    kv_len_mask = torch.arange(S, dtype=torch.int32, device=dev) < end
    kv_len = torch.full((B,), end, dtype=torch.int32, device=dev)
    for l, p in enumerate(layers if layers is not None else split_layers(params)):
        q, k_new, v_new = _layer_project_qkv(cfg, p, x)
        if cfg.position == "rope":
            q = _rope(q, positions_b, cfg.rope_theta, cfg.rope_dim)
            k_new = _rope(k_new, positions_b, cfg.rope_theta, cfg.rope_dim)
        cache.k[l, :, start_pos:end] = k_new.to(dtype)
        cache.v[l, :, start_pos:end] = v_new.to(dtype)
        attn = _cached_attention(cfg, q, cache.k[l], cache.v[l], positions_b, kv_len_mask, kv_len=kv_len)
        x = _post_attention(cfg, p, x, attn)
    return _final_logits(cfg, params, x[:, -1:])[:, 0], cache


def build_decoder(cfg: TransformerConfig):
    """``(prefill, decode_step)`` for a model config:
    ``prefill(params, tokens [B, T], cache)`` consumes the prompt and
    ``decode_step(params, token [B], cache, pos)`` appends one token at
    ``pos``; both return ``(logits [B, V], cache)`` and write the cache in
    place (JAX donates it)."""
    _check_cached_cfg(cfg)
    layers_of = _layer_views()

    @torch.no_grad()
    def prefill(params, tokens, cache):
        return _forward_with_cache(cfg, params, tokens, cache, 0, layers_of(params))

    @torch.no_grad()
    def decode_step(params, token, cache, pos: int):
        return _forward_with_cache(cfg, params, token[:, None], cache, pos, layers_of(params))

    return prefill, decode_step


def _as_tokens(input_ids, device) -> torch.Tensor:
    """``[B, T]`` int32 on ``device`` from a 1-D or 2-D array, list or tensor."""
    t = input_ids if isinstance(input_ids, torch.Tensor) else torch.as_tensor(np.asarray(input_ids))
    t = t.to(device=device, dtype=torch.int32)
    return t[None] if t.dim() == 1 else t


def generate(
    cfg: TransformerConfig,
    params,
    input_ids,
    max_new_tokens: int,
    eos_token_id=None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    top_k: int = 0,
    top_p: float = 1.0,
    pad_token_id: int = 0,
    dtype=None,
):
    """KV-cached generation: one prefill, then one single-token forward per
    new token (greedy, or temperature / top-k / top-p sampling drawn from
    ``generator``; no generator means greedy, as no rng does in JAX).

    As in JAX, the token sampled last is written and then run through one
    more forward, so a call without EOS runs ``max_new_tokens`` decode
    forwards. With ``eos_token_id`` the loop checks on the host after each
    step whether every row has emitted it (rows finished earlier keep
    emitting EOS as padding) and stops; without it the loop never
    synchronises. Returns ``[B, prompt_len + emitted]`` int32 on the
    weights' device."""
    device = params["embed"]["tokens"].device
    tokens = _as_tokens(input_ids, device)
    B, prompt_len = tokens.shape
    max_len = prompt_len + max_new_tokens
    cache = init_cache(cfg, B, max_len, dtype=dtype, device=device)
    prefill, decode_step = build_decoder(cfg)
    logits, cache = prefill(params, tokens, cache)
    if generator is None:
        temperature = 0.0
    out = torch.full((B, max_len), pad_token_id, dtype=torch.int32, device=device)
    out[:, :prompt_len] = tokens
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    emitted = 0
    for step in range(max_new_tokens):
        tok = sample_logits(logits, generator, temperature, top_k, top_p).to(torch.int32)
        if eos_token_id is not None:
            tok = tok.masked_fill(finished, eos_token_id)
            finished |= tok == eos_token_id
        out[:, prompt_len + step] = tok
        logits, cache = decode_step(params, tok, cache, prompt_len + step)
        emitted = step + 1
        if eos_token_id is not None and bool(finished.all()):
            break
    return out[:, : prompt_len + emitted]


def _top_stable(x: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest along the last axis, the lower
    index first on ties (``jax.lax.top_k``'s order; ``torch.topk`` leaves
    it unspecified)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def beam_generate(
    cfg: TransformerConfig,
    params,
    input_ids,
    max_new_tokens: int,
    num_beams: int = 4,
    eos_token_id=None,
    pad_token_id: int = 0,
    length_penalty: float = 1.0,
    dtype=None,
):
    """KV-cached beam search with the JAX loop's semantics (HF's
    BeamSearchScorer with ``early_stopping=True``): the prompt prefills
    once at batch B and the cache is tiled to B·K rows; each step draws 2K
    candidates, records EOS candidates ranked below K into a per-row
    best-finished register scored by ``cum_logprob / (prompt_len +
    emitted) ** length_penalty``, continues the K best non-EOS candidates,
    and reorders the cache rows to follow their beams (an
    ``index_select`` over the batch axis). A row stops once K finished
    hypotheses were seen; the answer is the better of the best finished
    hypothesis and the best live beam. Beam 0 starts at cum 0 and the rest
    at ``-1e30``, so the first draw expands distinct tokens. Ties select the
    lower index, as ``jax.lax.top_k`` and ``jnp.argmax`` do. Returns
    ``[B, prompt_len + emitted]`` int32."""
    K = int(num_beams)
    device = params["embed"]["tokens"].device
    tokens = _as_tokens(input_ids, device)
    B, prompt_len = tokens.shape
    max_len = prompt_len + max_new_tokens
    V = cfg.vocab_size
    prefill, decode_step = build_decoder(cfg)
    cache = init_cache(cfg, B, max_len, dtype=dtype, device=device)
    logits, cache = prefill(params, tokens, cache)  # [B, V]
    cache = KVCache(k=cache.k.repeat_interleave(K, dim=1), v=cache.v.repeat_interleave(K, dim=1))
    out = torch.full((B * K, max_len), pad_token_id, dtype=torch.int32, device=device)
    out[:, :prompt_len] = tokens.repeat_interleave(K, dim=0)
    logits = logits.repeat_interleave(K, dim=0)

    def norm_score(cum, emitted: int):
        # HF denominator: the FULL sequence length (prompt + generated)
        return cum / float(prompt_len + max(emitted, 1)) ** length_penalty

    cum = torch.full((B, K), NEG_INF_F, dtype=torch.float32, device=device)
    cum[:, 0] = 0.0
    rows = torch.arange(B, device=device)
    done_count = torch.zeros(B, dtype=torch.int64, device=device)
    best_score = torch.full((B,), NEG_INF_F, dtype=torch.float32, device=device)
    best_out = out[::K].clone()
    best_len = torch.zeros(B, dtype=torch.int64, device=device)
    topk_rank = torch.arange(2 * K, device=device)[None, :] < K
    step = 0
    while step < max_new_tokens and (eos_token_id is None or bool((done_count < K).any())):
        logp = torch.log_softmax(logits.float(), dim=-1)
        total = cum[:, :, None] + logp.reshape(B, K, V)
        cand_cum, flat_idx = _top_stable(total.reshape(B, K * V), 2 * K)
        cand_beam = flat_idx // V  # [B, 2K]
        cand_tok = flat_idx % V
        if eos_token_id is not None:
            is_eos = cand_tok == eos_token_id
            # HF records and counts only EOS candidates ranked < K
            rec = is_eos & topk_rank
            fin = torch.where(rec, norm_score(cand_cum, step + 1), torch.full_like(cand_cum, NEG_INF_F))
            j = torch.argmax(fin, dim=1)  # the first maximum
            row_score = fin.gather(1, j[:, None])[:, 0]
            src = rows * K + cand_beam.gather(1, j[:, None])[:, 0]
            cand_out = out.index_select(0, src)
            cand_out[:, prompt_len + step] = eos_token_id
            better = row_score > best_score
            best_out = torch.where(better[:, None], cand_out, best_out)
            best_score = torch.where(better, row_score, best_score)
            best_len = best_len.masked_fill(better, step + 1)
            done_count = done_count + rec.sum(dim=1)
            live_vals = cand_cum.masked_fill(is_eos, NEG_INF_F)
        else:
            live_vals = cand_cum
        new_cum, pick = _top_stable(live_vals, K)  # [B, K] into 2K
        beam_src = cand_beam.gather(1, pick)
        tok = cand_tok.gather(1, pick).to(torch.int32)
        flat_src = (beam_src + rows[:, None] * K).reshape(B * K)
        out = out.index_select(0, flat_src)
        cache = KVCache(k=cache.k.index_select(1, flat_src), v=cache.v.index_select(1, flat_src))
        flat_tok = tok.reshape(B * K)
        out[:, prompt_len + step] = flat_tok
        logits, cache = decode_step(params, flat_tok, cache, prompt_len + step)
        cum = new_cum
        step += 1
    live = norm_score(cum, step)  # every live beam emitted `step` tokens
    k_live = torch.argmax(live, dim=1)
    live_out = out.index_select(0, rows * K + k_live)
    live_score = live.gather(1, k_live[:, None])[:, 0]
    use_fin = best_score >= live_score
    final_out = torch.where(use_fin[:, None], best_out, live_out)
    final_len = torch.where(use_fin, best_len, torch.full_like(best_len, step))
    return final_out[:, : prompt_len + int(final_len.max())]
