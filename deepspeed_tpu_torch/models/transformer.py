"""The decoder: its parameters, its training forward and the loss.

Counterpart of ``deepspeed_tpu/models/transformer.py``. ``TransformerLM``
holds the parameters in the JAX package's tree layout
(``models/transformer.py:157-218``): ``embed.tokens`` / ``embed.pos``, the
per-layer weights stacked on a leading ``[L, ...]`` axis under ``layers``,
``final_norm_*`` and ``lm_head``. Weights are ``x @ w`` oriented
(``[in, out]``), as in JAX.

A new module holds its parameters on the ``meta`` device (no memory); they
become real through ``checkpoint/jax_params.py`` (the JAX tree as numpy),
which is how weights enter the port. The serving forward lives in
``inference/decode.py`` and reads the tree returned by ``param_tree()``.

The training forward is functional, as in JAX: ``apply(params, batch,
train=...)`` takes a nested tree of tensors (the engine's compute-dtype
leaves, which require grad) and returns the loss when the batch carries
labels, else the logits. It follows ``_forward`` / ``_layer`` /
``_local_full_attention`` op for op: matmuls in the activation dtype,
norms and RoPE in fp32 cast back, attention through the flash kernels
(``ops/transformer/flash_attention.py``) under exactly JAX's condition,
else the grouped einsum with the softmax in fp32, and the cross entropy in
fp32. ``remat`` wraps each layer in ``torch.utils.checkpoint`` under
``remat_policy`` (JAX's policy names, ``runtime/activation_checkpointing``;
a name PyTorch cannot express raises). Dropout
masks are a counter-based hash of the step's seed, the layer and the
element index (``_dropout``): the seed may be a device tensor, so a
captured CUDA graph draws new masks each replay from the seeds copied in
with its batch and the eager path draws the same ones; a recomputed layer
redraws the same masks; no generator state is touched. ALiBi adds JAX's
per-head distance bias in the plain attention (the flash kernels never see
it, as in JAX).

Progressive layer drop and random-LTD (JAX ``_forward``,
``transformer.py:531-672``) take their random decisions as arguments, so
the caller draws them (the engine, from a ``torch.Generator`` on its
device) and tests hand JAX's own decisions in. ``pld_keep`` holds one keep
flag a layer: host booleans skip a dropped layer (identity, no rescale),
a device tensor keeps or drops it by ``torch.where`` over the layer's
output, so a captured CUDA graph computes every layer and replays new
flags from its input buffer. ``ltd_idx [n, B, kept]`` runs layers 1..n
each on its own sorted token subset (gathered with its true positions, so
RoPE, learned positions and the causal mask see the subset's order, as
JAX's flash call does) and scatters the result back; layer 0 and the rest
run on every token. Both apply in training only. The MoE family
(``models/moe_transformer.py``) overrides ``_mlp`` and the per-layer tree;
its load-balance loss joins the training loss here, as in JAX. Sequence
parallelism and sparse embedding gradients raise ``NotImplementedError``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.models.config import TransformerConfig
from deepspeed_tpu_torch.moe.experts import apply_dense_ffn
from deepspeed_tpu_torch.ops.transformer.flash_attention import flash_attention
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import remat

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _norm(x, scale, bias, kind: str, eps: float):
    x32 = x.float()
    if kind == "rmsnorm":
        rms = torch.sqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True) + eps)
        out = x32 / rms * scale.float()
    else:
        mean = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
        out = (x32 - mean) / torch.sqrt(var + eps) * scale.float()
        if bias is not None:
            out = out + bias.float()
    return out.to(x.dtype)


def _rope(x, positions, theta: float, rope_dim=None):
    """Rotary embedding over the last dim of ``[B, T, N, D]`` at integer
    ``positions [B, T]``. ``rope_dim`` rotates only the leading features
    (GPT-J rotary_dim / NeoX rotary_pct); the tail passes through."""
    if rope_dim is not None and rope_dim < x.shape[-1]:
        rotated = _rope(x[..., :rope_dim], positions, theta)
        return torch.cat([rotated, x[..., rope_dim:]], dim=-1)
    half = x.shape[-1] // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(theta, exponent)
    angles = positions[..., None].float() * freqs  # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def param_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat ``path -> shape`` of the JAX tree (``embed/tokens``,
    ``layers/wq``, ``final_norm_scale``, ...), stacked ``[L, ...]``
    per-layer leaves included; an MoE config's tree
    (``moe_transformer.moe_param_shapes``) for an ``MoETransformerConfig``."""
    if is_moe_config(cfg):
        from deepspeed_tpu_torch.models.moe_transformer import moe_param_shapes

        return moe_param_shapes(cfg)
    return dense_param_shapes(cfg)


def is_moe_config(cfg) -> bool:
    return hasattr(cfg, "moe_layer_freq")


def dense_param_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """``param_shapes`` of the dense decoder."""
    H, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    NH, NKV, D, I = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.intermediate_size
    gated = cfg.activation in ("swiglu", "geglu")
    s: Dict[str, Tuple[int, ...]] = {"embed/tokens": (V, H)}
    if cfg.position == "learned":
        s["embed/pos"] = (cfg.max_seq_len, H)
    if cfg.embed_norm:
        s["embed/norm_scale"] = (H,)
        if cfg.norm == "layernorm":
            s["embed/norm_bias"] = (H,)
    layer = {
        "attn_norm_scale": (L, H),
        "wq": (L, H, NH * D),
        "wk": (L, H, NKV * D),
        "wv": (L, H, NKV * D),
        "wo": (L, NH * D, H),
        "mlp_norm_scale": (L, H),
        "w_out": (L, I, H),
    }
    if gated:
        layer["w_gate"] = (L, H, I)
        layer["w_up"] = (L, H, I)
    else:
        layer["w_in"] = (L, H, I)
    if cfg.norm == "layernorm":
        layer["attn_norm_bias"] = (L, H)
        layer["mlp_norm_bias"] = (L, H)
    if cfg.qkv_bias:
        layer["bq"] = (L, NH * D)
        layer["bk"] = (L, NKV * D)
        layer["bv"] = (L, NKV * D)
    if cfg.use_bias:
        layer["bo"] = (L, H)
        layer["b_out"] = (L, H)
        if not gated:
            layer["b_in"] = (L, I)
    s.update({f"layers/{k}": v for k, v in layer.items()})
    if cfg.prenorm:  # post-LN nets end inside the last layer's norm
        s["final_norm_scale"] = (H,)
        if cfg.norm == "layernorm":
            s["final_norm_bias"] = (H,)
    if not cfg.tie_embeddings:
        s["lm_head"] = (H, V)
        if cfg.lm_head_bias:
            s["lm_head_bias"] = (V,)
    return s


class TransformerLM(nn.Module):
    """Decoder parameters in the JAX tree layout, and the training forward
    (see the module docstring).

    Covers the dense features: layernorm and rmsnorm, learned and rope
    positions (``rope_dim`` included), pre-LN and post-LN, ``embed_norm``,
    ``qkv_bias``, ``use_bias``, tied or untied head, ``lm_head_bias``,
    ``parallel_residual`` / ``shared_parallel_norm``, MHA and GQA, ALiBi,
    and ``attn_softmax_scale``. An MoE config builds
    ``moe_transformer.MoETransformerLM``."""

    _moe = False

    def __init__(self, config: TransformerConfig):
        super().__init__()
        if is_moe_config(config) and not self._moe:
            raise TypeError("an MoETransformerConfig builds models.moe_transformer.MoETransformerLM")
        self.config = config
        self.dtype = DTYPES[config.dtype]
        self.embed = nn.ParameterDict()
        self.layers = nn.ParameterDict()  # keys: the path under "layers/" ("wq", "moe/gate/wg", ...)
        self.groups = nn.ParameterDict()  # other nested leaves by full path ("dense_mlp/w_up", ...)
        for path, shape in param_shapes(config).items():
            self.set_leaf(path, torch.empty(shape, device="meta"))

    def set_leaf(self, path: str, value: torch.Tensor) -> None:
        """Install one leaf of the tree under its JAX path."""
        p = nn.Parameter(value, requires_grad=False)
        head, _, rest = path.partition("/")
        if head == "embed":
            self.embed[rest] = p
        elif head == "layers":
            self.layers[rest] = p
        elif rest == "":
            setattr(self, head, p)
        elif head in ("dense_mlp", "moe_layers"):
            self.groups[path] = p
        else:
            raise KeyError(f"unknown parameter path {path!r}")

    def param_tree(self) -> Dict:
        """The parameters as the JAX package's nested dict (tensors, not
        copies)."""
        tree: Dict = {"embed": dict(self.embed.items()), "layers": _nest(dict(self.layers.items()))}
        for name, p in self.named_parameters(recurse=False):
            tree[name] = p
        tree.update(_nest(dict(self.groups.items())))
        return tree

    # --- TP sharding rules ----------------------------------------------
    def tp_partition_rules(self, params_shapes=None):
        """Megatron-style shard dims (JAX ``transformer.py:221-262``, whose
        PartitionSpecs name the ``model`` axis): column-parallel
        qkv/gate/up (the output features, the heads), row-parallel
        ``wo`` / ``w_out`` (the input features), a vocab-parallel token
        embedding (dim 0) and an output-vocab-parallel ``lm_head``; the
        stacked layer dim stays whole. A tree of the ``params_shapes``
        structure whose leaves are the dim to split or None (replicated);
        None without ``params_shapes``. The pre-sharded inference
        checkpoint (``inference/mp_checkpoint.py``) splits by it; the
        serving layout is ``inference/tp.py``'s (embeddings replicated)."""
        if params_shapes is None:
            return None

        def dim_for(path: str, ndim: int):
            stacked = ndim == 3  # [L, in, out]
            name = path.split("/")[-1]
            if name in ("wq", "wk", "wv", "w_gate", "w_up", "w_in"):
                return 2 if stacked else 1
            if name in ("wo", "w_out"):
                return 1 if stacked else 0
            if name in ("bq", "bk", "bv", "b_in"):
                return 1 if ndim == 2 else 0
            if name == "tokens":
                return 0  # vocab-parallel embedding
            if name == "lm_head":
                return 1
            return None

        def walk(prefix, tree):
            if isinstance(tree, dict):
                return {k: walk(f"{prefix}/{k}", v) for k, v in tree.items()}
            return dim_for(prefix, len(tree.shape))

        return walk("", params_shapes)

    # --- training forward ------------------------------------------------
    def apply(self, params, batch, *, dropout_seed: Optional[int] = None, train: bool = True,
              attn_impl: Optional[str] = None, pld_keep=None, ltd_idx=None, tp=None, layer_stream=None,
              split_aux: bool = False, replicated: bool = False):
        """JAX ``apply`` (``transformer.py:821``): the scalar LM loss when the
        batch carries labels (``(tokens, labels)`` or ``{"input_ids",
        "labels"}``), else the logits ``[B, T, V]``. ``params`` is the nested
        tree of tensors; ``dropout_seed`` seeds this step's dropout masks
        (and an MoE model's gate noise); ``attn_impl="plain"`` asks for the
        plain flash functions on the card (the comparison arm). In training
        the loss includes the MoE load-balance loss, as in JAX.

        ``pld_keep`` (progressive layer drop: one keep flag a layer) and
        ``ltd_idx`` (random-LTD: ``[n, B, kept]`` token indices of layers
        1..n) apply in training only; see the module docstring.

        With ``tp`` (``inference/tp.py:TPServing``, inference only)
        ``params`` is this rank's shard (``tp.shard_params``): each layer
        runs the rank's heads, the row-parallel ``wo`` and ``w_out`` sum
        their partials in ``tp.row_matmul``'s all-reduces, and the sharded
        head's logits are gathered along the vocabulary, so every rank
        returns the full logits (JAX runs the same layout by GSPMD).

        With ``layer_stream`` (ZeRO-3, ``runtime/zero/overlap.py``)
        ``params`` holds no ``layers``: the stream gathers each layer's
        weights and runs it (``layer_stream.run(i, fn, x, remat)``).

        With ``split_aux`` a labelled training batch returns ``(lm_loss,
        aux)`` apart (``aux`` None for a dense model): the data-parallel
        engine weighs the two by their own shares.

        ``replicated`` says every rank holds the whole batch (the inference
        engine's forward), not its own rows: an MoE layer across ranks then
        takes its token shard itself (``moe/layer.py``)."""
        if tp is not None and train:
            raise NotImplementedError("tensor-parallel training is not ported yet (ROADMAP P1)")
        tokens, labels = _split_batch(batch)
        logits, aux = self._forward(params, tokens, dropout_seed, train, attn_impl, tp, layer_stream,
                                    pld_keep=pld_keep if train else None, ltd_idx=ltd_idx if train else None,
                                    replicated=replicated)
        if tp is not None:
            logits = tp.gather_vocab(logits)
        if labels is None:
            return logits
        loss = cross_entropy_loss(logits, labels)
        if split_aux:
            return loss, (aux if train else None)
        if train and aux is not None:
            loss = loss + aux
        return loss

    def _per_layer(self, params) -> List[Dict]:
        """One tree a layer from the stacked ``params["layers"]``: one
        unbind per stacked leaf, whose backward stacks the per-layer
        gradients into the ``[L, ...]`` leaf in one op."""
        unbound = {k: v.unbind(0) for k, v in _flat(params["layers"]).items()}
        return [_nest({k: u[i] for k, u in unbound.items()}) for i in range(self.config.num_layers)]

    def _forward(self, params, tokens, dropout_seed, train, attn_impl, tp=None, layer_stream=None,
                 pld_keep=None, ltd_idx=None, replicated=False):
        """``(logits, aux)``: the logits and the summed (coefficient-scaled)
        MoE load-balance loss, None for a dense model."""
        cfg = self.config if tp is None else tp.local_cfg(self.config)
        if cfg.sequence_parallel:
            raise NotImplementedError("sequence parallelism is not ported yet (ROADMAP P1)")
        if cfg.sparse_embedding_grads:
            raise NotImplementedError("sparse embedding gradients are not ported yet (ROADMAP P1)")
        dt = self.dtype
        B, T = tokens.shape
        L = cfg.num_layers
        x = params["embed"]["tokens"].to(dt)[tokens]
        positions = torch.arange(T, dtype=torch.int32, device=tokens.device)[None].expand(B, T)
        if cfg.position == "learned":
            x = x + params["embed"]["pos"].to(dt)[positions[0].long()][None]
        if cfg.embed_norm:
            x = _norm(x, params["embed"]["norm_scale"], params["embed"].get("norm_bias"), cfg.norm, cfg.norm_eps)
        if pld_keep is not None and ltd_idx is not None:
            raise ValueError("progressive_layer_drop and random-LTD cannot be combined")
        n_ltd = 0 if ltd_idx is None else int(ltd_idx.shape[0])
        if n_ltd and n_ltd > L - 2:
            raise ValueError(f"random-LTD covers {n_ltd} layers but only {L - 2} middle layers exist (the first "
                             "and last layers always run full)")
        if pld_keep is not None and layer_stream is not None and not isinstance(pld_keep, torch.Tensor):
            # the stream gathers every layer in order: a dropped layer runs and is discarded by torch.where
            pld_keep = torch.as_tensor(list(pld_keep), dtype=torch.bool, device=tokens.device)
        per_layer = self._per_layer(params) if layer_stream is None else None
        aux_total = None
        for i in range(L):
            if pld_keep is not None and not isinstance(pld_keep, torch.Tensor) and not pld_keep[i]:
                continue  # PLD: a dropped layer passes x through (identity, no rescale)
            seed = None if dropout_seed is None else dropout_seed + i
            block = functools.partial(self._block, replicated=replicated)
            extra = ()
            if 1 <= i <= n_ltd:
                block, extra = self._ltd_block, (ltd_idx[i - 1],)  # training only: never replicated
            if layer_stream is not None:
                y, aux = layer_stream.run(i, lambda h, per, seed=seed, block=block, extra=extra: block(
                    h, per, positions, seed, train, attn_impl, cfg, None, *extra), x, cfg.remat)
            elif cfg.remat and torch.is_grad_enabled():
                # remat_policy as JAX's model reads it; the masks and the gate noise are a function of the
                # seed, not of torch's RNG, so no generator state is stashed (nor could its CUDA state be
                # read inside a graph capture)
                y, aux = remat(block, x, per_layer[i], positions, seed, train, attn_impl, cfg, None, *extra,
                               policy=cfg.remat_policy)
            else:
                y, aux = block(x, per_layer[i], positions, seed, train, attn_impl, cfg, tp, *extra)
            if isinstance(pld_keep, torch.Tensor):
                keep = pld_keep[i]
                y = torch.where(keep, y, x)
                if aux is not None:
                    aux = torch.where(keep, aux, torch.zeros_like(aux))
            x = y
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        if cfg.prenorm:
            x = _norm(x, params["final_norm_scale"], params.get("final_norm_bias"), cfg.norm, cfg.norm_eps)
        if cfg.tie_embeddings:
            return x @ params["embed"]["tokens"].to(dt).T, aux_total
        logits = x @ params["lm_head"].to(dt)
        if cfg.lm_head_bias:
            logits = logits + params["lm_head_bias"].to(logits.dtype)
        return logits, aux_total

    # --- layer streaming (ZeRO-Infinity param offload, ZeRO-Inference) ----
    def stream_fns(self):
        """The forward split into embed, layer and head functions for the
        layer-streamed engine (``runtime/zero/param_offload.py``; JAX
        ``transformer.py:762-826``): ``embed_fwd(resident, tokens) -> h``,
        ``layer_fwd(layer_params, h, positions, seed, train=True,
        attn_impl=None) -> h``, ``head_loss(resident, h, labels=None)`` (the
        logits when ``labels`` is None, else the loss), where ``resident``
        is the tree without ``layers`` and ``layer_params`` one layer's
        leaves. ``seed`` is the layer's dropout seed (``_forward``'s
        ``dropout_seed + i``), so a recomputed layer redraws the same
        masks."""
        cfg = self.config
        dt = self.dtype

        def embed_fwd(resident, tokens):
            x = resident["embed"]["tokens"].to(dt)[tokens]
            if cfg.position == "learned":
                T = tokens.shape[1]
                x = x + resident["embed"]["pos"].to(dt)[torch.arange(T, device=tokens.device)][None]
            if cfg.embed_norm:
                x = _norm(x, resident["embed"]["norm_scale"], resident["embed"].get("norm_bias"), cfg.norm,
                          cfg.norm_eps)
            return x

        def layer_fwd(layer_params, h, positions, seed, train=True, attn_impl=None):
            return self._layer(h, layer_params, positions, seed, train, attn_impl, cfg)

        def head_loss(resident, h, labels=None):
            x = h
            if cfg.prenorm:
                x = _norm(x, resident["final_norm_scale"], resident.get("final_norm_bias"), cfg.norm, cfg.norm_eps)
            if cfg.tie_embeddings:
                logits = x @ resident["embed"]["tokens"].to(dt).T
            else:
                logits = x @ resident["lm_head"].to(dt)
                if cfg.lm_head_bias:
                    logits = logits + resident["lm_head_bias"].to(logits.dtype)
            if labels is None:
                return logits
            return cross_entropy_loss(logits, labels)

        return embed_fwd, layer_fwd, head_loss

    def _layer(self, x, p, positions, seed, train, attn_impl, cfg=None, tp=None):
        """One block's output (``_block`` without its MoE loss)."""
        return self._block(x, p, positions, seed, train, attn_impl, cfg, tp)[0]

    def _ltd_block(self, x, p, positions, seed, train, attn_impl, cfg, tp, idx):
        """A random-LTD layer (JAX ``ltd_body``): the block on the rows
        ``idx [B, kept]`` of ``x`` at their own positions, scattered back
        over ``x``; the other rows pass through."""
        from deepspeed_tpu_torch.runtime.data_pipeline.data_routing import gather_tokens, scatter_tokens

        pos_sub = torch.gather(positions, 1, idx.long())
        y, aux = self._block(gather_tokens(x, idx), p, pos_sub, seed, train, attn_impl, cfg, tp)
        return scatter_tokens(x, y, idx), aux

    def _mlp(self, p, h, seed, train, tp=None, replicated=False):  # noqa: ARG002
        """The dense FFN over one layer's leaves: ``(out, None)``; the MoE
        family returns its layer's scaled load-balance loss as the second
        item (``replicated``: see ``apply``)."""
        ffn = {name: p[name].to(h.dtype) for name in _FFN_LEAVES if name in p}
        return apply_dense_ffn(ffn, h, self.config.activation, tp=tp), None

    def _block(self, x, p, positions, seed, train, attn_impl, cfg=None, tp=None, replicated=False):
        """One block (``transformer.py:412``): pre-LN or post-LN, parallel
        residual, biases; weights cast to the activation dtype at use.
        ``cfg`` is the rank's local view under ``tp`` (the model's config
        otherwise). Returns ``(x, aux)``, ``aux`` the MoE loss or None."""
        cfg = cfg if cfg is not None else self.config
        B, T, _ = x.shape
        NH, NKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dt = x.dtype
        dropout = cfg.attn_dropout > 0 or cfg.hidden_dropout > 0
        lseed = None  # this layer's seed, an int64 tensor on x's device (dropout masks, gate noise)
        if train and seed is not None and (dropout or self._moe):
            lseed = torch.as_tensor(seed, dtype=torch.int64, device=x.device)
        dseed = lseed if dropout else None
        h = _norm(x, p["attn_norm_scale"], p.get("attn_norm_bias"), cfg.norm, cfg.norm_eps) if cfg.prenorm else x
        q = h @ p["wq"].to(dt)
        k = h @ p["wk"].to(dt)
        v = h @ p["wv"].to(dt)
        if cfg.qkv_bias:
            q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
        q = q.reshape(B, T, NH, D)
        k = k.reshape(B, T, NKV, D)
        v = v.reshape(B, T, NKV, D)
        if cfg.position == "rope":
            q = _rope(q, positions, cfg.rope_theta, cfg.rope_dim)
            k = _rope(k, positions, cfg.rope_theta, cfg.rope_dim)
        attn = self._attention(q, k, v, positions, dseed, train, attn_impl)
        attn = attn.reshape(B, T, NH * D)
        attn = tp.row_matmul(attn, p["wo"]).to(dt) if tp is not None else attn @ p["wo"].to(dt)
        if cfg.use_bias:
            attn = attn + p["bo"].to(dt)
        if train and cfg.hidden_dropout > 0 and dseed is not None:
            attn = _dropout(attn, cfg.hidden_dropout, dseed, _HIDDEN_SALT)
        if cfg.parallel_residual:
            h_mlp = h if cfg.shared_parallel_norm else _norm(
                x, p["mlp_norm_scale"], p.get("mlp_norm_bias"), cfg.norm, cfg.norm_eps)
            out, aux = self._mlp(p, h_mlp, lseed, train, tp, replicated)
            return x + attn + out, aux
        if cfg.prenorm:
            x = x + attn
            h = _norm(x, p["mlp_norm_scale"], p.get("mlp_norm_bias"), cfg.norm, cfg.norm_eps)
        else:
            x = _norm(x + attn, p["attn_norm_scale"], p.get("attn_norm_bias"), cfg.norm, cfg.norm_eps)
            h = x
        out, aux = self._mlp(p, h, lseed, train, tp, replicated)
        if cfg.prenorm:
            return x + out, aux
        return _norm(x + out, p["mlp_norm_scale"], p.get("mlp_norm_bias"), cfg.norm, cfg.norm_eps), aux

    def _attention(self, q, k, v, positions, dseed, train, attn_impl):
        """``_local_full_attention`` (``transformer.py:282``): the flash
        kernels under JAX's condition (``:293-304``), else the grouped
        einsum with the softmax in fp32."""
        cfg = self.config
        scale = cfg.attn_softmax_scale if cfg.attn_softmax_scale is not None else 1.0 / float(np.sqrt(q.shape[-1]))
        NH, NKV = q.shape[2], k.shape[2]
        if cfg.flash_attention and cfg.position != "alibi" and cfg.causal and (not train or cfg.attn_dropout == 0):
            if NKV != NH:
                k, v = _expand_gqa(q, k, v)  # kernel contract: equal head counts
            return flash_attention(q, k, v, causal=True, scale=scale, impl=attn_impl)
        B, T, _, D = q.shape
        G = NH // NKV
        scores = torch.einsum("btkgd,bskd->bkgts", q.reshape(B, T, NKV, G, D), k).float() * scale
        if cfg.position == "alibi":  # JAX transformer.py:311-326: -slope_h * |i - j|, heads as [NKV, G]
            slopes = _alibi_slopes_on(NH, q.device).reshape(NKV, G)
            dist = (positions[:, None, :] - positions[:, :, None]).float()
            scores = scores - slopes[None, :, :, None, None] * torch.abs(dist)[:, None, None]
        if cfg.causal:
            mask = positions[:, None, None, :, None] >= positions[:, None, None, None, :]
            scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1)
        if train and cfg.attn_dropout > 0 and dseed is not None:
            probs = _dropout(probs, cfg.attn_dropout, dseed, _ATTN_SALT)
        out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)
        return out.reshape(B, T, NH, D)


_FFN_LEAVES = ("w_in", "b_in", "w_gate", "w_up", "w_out", "b_out")


_M32 = 0xFFFFFFFF
_ATTN_SALT, _HIDDEN_SALT = 0x2545F491, 0x6A09E667  # attention and hidden masks of one layer differ


def _mix32(h):
    """A 32-bit integer finaliser on int64 tensors holding values below
    2**32 (the products stay below 2**63)."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x346CA68B) & _M32
    return h ^ (h >> 16)


def _as_int32(h):
    """int64 values below 2**32 as int32 with the same 32 bits."""
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def _hash_bits(shape, seed: torch.Tensor, salt: int, device, row0: int = 0) -> torch.Tensor:
    """Uniform int32 draws over ``[-2**31, 2**31)``, a hash of (``seed``,
    ``salt``, element index) for a tensor of ``shape``. ``seed`` is an
    int64 tensor on ``device``, read by no host code, so a CUDA graph
    replays it from whatever its buffer holds.

    The index is split into row (every dim but the last) and column: each
    row and each column gets a fully mixed 32-bit key (small int64
    tensors), and the full-size work is their xor mixed by two multiplies
    and a xorshift in int32 (a multiply wraps; the shift is masked to act
    as a logical one), seven passes over the elements. Readers take the
    high bits, which the multiplies mix from every input bit. ``row0``
    offsets the row index: rows ``[row0, row0 + rows)`` of a larger draw
    (an expert-parallel token shard's rows of the global batch)."""
    shape = tuple(shape)
    n = shape[-1]
    rows = torch.arange(row0, row0 + math.prod(shape) // n, dtype=torch.int64, device=device)
    s = seed ^ salt
    rk = _mix32(_mix32((rows & _M32) ^ (s & _M32)) ^ ((s >> 32) & _M32) ^ ((rows >> 32) & _M32))
    ck = _mix32(torch.arange(n, dtype=torch.int64, device=device) * 0x9E3779B9 & _M32 ^ salt)
    h = _as_int32(rk).view(shape[:-1] + (1,)) ^ _as_int32(ck)
    h.mul_(0x7FEB352D)
    h.bitwise_xor_(torch.bitwise_and(h >> 16, 0xFFFF))
    h.mul_(0x346CA68B)
    return h


def _uniform(shape, seed: torch.Tensor, salt: int, device, row0: int = 0) -> torch.Tensor:
    """fp32 uniforms in ``(0, 1)`` from the top 24 bits of ``_hash_bits``
    (exact in fp32: never 0 or 1)."""
    h = _hash_bits(shape, seed, salt, device, row0)
    return (torch.bitwise_and(h >> 8, 0xFFFFFF).to(torch.float32) + 0.5) * (2.0 ** -24)


def _dropout(x, rate: float, seed: torch.Tensor, salt: int):
    """Inverted dropout whose mask is ``_hash_bits`` kept below ``(1 -
    rate) · 2**32``."""
    h = _hash_bits(x.shape, seed, salt, x.device)
    keep = h < int((1.0 - rate) * 2**32) - 2**31  # h is uniform over [-2**31, 2**31)
    return x * keep / (1.0 - rate)


_SLOPES: Dict[Tuple[int, str], torch.Tensor] = {}


def _alibi_slopes_on(n_heads: int, device) -> torch.Tensor:
    """``_alibi_slopes`` as an fp32 tensor on ``device``, made once (its
    host-to-device copy then never falls inside a captured step)."""
    key = (n_heads, str(device))
    if key not in _SLOPES:
        _SLOPES[key] = torch.as_tensor(_alibi_slopes(n_heads), dtype=torch.float32, device=device)
    return _SLOPES[key]


def _alibi_slopes(n_heads: int) -> np.ndarray:
    """The per-head ALiBi slopes (JAX ``transformer.py:91``): a geometric
    sequence from ``2**(-8/n)``, interleaved past the largest power of two."""
    def pow2slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return start * (start ** np.arange(n))

    if np.log2(n_heads).is_integer():
        return pow2slopes(n_heads)
    closest = 2 ** int(np.floor(np.log2(n_heads)))
    return np.concatenate([pow2slopes(closest), pow2slopes(2 * closest)[0::2][: n_heads - closest]])


def _expand_gqa(q, k, v):
    """Repeat kv heads up to q's head count, for the flash kernels only
    (``transformer.py:837``; ``jnp.repeat`` on the head axis)."""
    NH, NKV = q.shape[2], k.shape[2]
    if NKV != NH:
        k = torch.repeat_interleave(k, NH // NKV, dim=2)
        v = torch.repeat_interleave(v, NH // NKV, dim=2)
    return k, v


def _flat(tree, prefix: str = "") -> Dict:
    """A nested dict as flat ``path -> leaf``."""
    out: Dict = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat: Dict) -> Dict:
    """Flat ``path -> leaf`` as a nested dict."""
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        *heads, name = path.split("/")
        for head in heads:
            node = node.setdefault(head, {})
        node[name] = leaf
    return tree


def _split_batch(batch):
    """``transformer.py:849``: dict, 2-tuple or bare tokens."""
    if isinstance(batch, dict):
        return batch["input_ids"], batch.get("labels")
    if isinstance(batch, (tuple, list)) and len(batch) == 2:
        return batch[0], batch[1]
    return batch, None


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Mean token cross entropy in fp32 over the positions whose label is
    not ``ignore_index`` (``transformer.py:112``)."""
    mask = labels != ignore_index
    safe_labels = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, safe_labels[..., None])[..., 0].float()
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1)


def init_params(cfg: TransformerConfig, seed: int) -> Dict[str, np.ndarray]:
    """Weights in the JAX tree layout (flat paths) as fp32 numpy, with the
    distributions of the JAX ``TransformerLM.init`` (``transformer.py:157``):
    normal std 0.02, output projections ``wo`` / ``w_out`` at
    0.02/sqrt(2L), norm scales 1, biases 0; drawn leaf by leaf in
    ``param_shapes`` order from ``numpy.random.default_rng(seed)``. The
    bits differ from ``jax.random``'s; the distributions do not."""
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
