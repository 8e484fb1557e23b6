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
fp32. ``remat`` wraps each layer in ``torch.utils.checkpoint``. Dropout
draws from a per-layer ``torch.Generator`` seeded from the step's seed, so
a recomputed layer redraws the same masks; it never touches the global RNG.
Sequence parallelism, progressive layer drop, random-LTD, sparse embedding
gradients, MoE and ALiBi raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.models.config import TransformerConfig
from deepspeed_tpu_torch.moe.experts import apply_dense_ffn
from deepspeed_tpu_torch.ops.transformer.flash_attention import flash_attention

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
    per-layer leaves included."""
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
    ``parallel_residual`` / ``shared_parallel_norm``, MHA and GQA, and
    ``attn_softmax_scale``. MoE and ALiBi models raise."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        if config.position == "alibi":
            raise NotImplementedError("alibi attention biases are not ported yet (ROADMAP T4)")
        if getattr(config, "num_experts", 0):
            raise NotImplementedError("MoE models are not ported yet (ROADMAP M1)")
        self.config = config
        self.dtype = DTYPES[config.dtype]
        self.embed = nn.ParameterDict()
        self.layers = nn.ParameterDict()
        for path, shape in param_shapes(config).items():
            self.set_leaf(path, torch.empty(shape, device="meta"))

    def set_leaf(self, path: str, value: torch.Tensor) -> None:
        """Install one leaf of the tree under its JAX path."""
        p = nn.Parameter(value, requires_grad=False)
        head, _, name = path.rpartition("/")
        if head == "embed":
            self.embed[name] = p
        elif head == "layers":
            self.layers[name] = p
        elif head == "":
            setattr(self, name, p)
        else:
            raise KeyError(f"unknown parameter path {path!r}")

    def param_tree(self) -> Dict:
        """The parameters as the JAX package's nested dict (tensors, not
        copies)."""
        tree: Dict = {"embed": dict(self.embed.items()), "layers": dict(self.layers.items())}
        for name, p in self.named_parameters(recurse=False):
            tree[name] = p
        return tree

    # --- training forward ------------------------------------------------
    def apply(self, params, batch, *, dropout_seed: Optional[int] = None, train: bool = True,
              attn_impl: Optional[str] = None, pld_theta=None, ltd_idx=None):
        """JAX ``apply`` (``transformer.py:821``): the scalar LM loss when the
        batch carries labels (``(tokens, labels)`` or ``{"input_ids",
        "labels"}``), else the logits ``[B, T, V]``. ``params`` is the nested
        tree of tensors; ``dropout_seed`` seeds this step's dropout masks;
        ``attn_impl="plain"`` asks for the plain flash functions on the card
        (the comparison arm)."""
        if pld_theta is not None or ltd_idx is not None:
            raise NotImplementedError("progressive layer drop and random-LTD are not ported yet (ROADMAP T5)")
        tokens, labels = _split_batch(batch)
        logits = self._forward(params, tokens, dropout_seed, train, attn_impl)
        if labels is None:
            return logits
        return cross_entropy_loss(logits, labels)

    def _forward(self, params, tokens, dropout_seed, train, attn_impl):
        cfg = self.config
        if cfg.sequence_parallel:
            raise NotImplementedError("sequence parallelism is not ported yet (ROADMAP P1)")
        if cfg.sparse_embedding_grads:
            raise NotImplementedError("sparse embedding gradients are not ported yet (ROADMAP P1)")
        dt = self.dtype
        B, T = tokens.shape
        x = params["embed"]["tokens"].to(dt)[tokens]
        positions = torch.arange(T, dtype=torch.int32, device=tokens.device)[None].expand(B, T)
        if cfg.position == "learned":
            x = x + params["embed"]["pos"].to(dt)[positions[0].long()][None]
        if cfg.embed_norm:
            x = _norm(x, params["embed"]["norm_scale"], params["embed"].get("norm_bias"), cfg.norm, cfg.norm_eps)
        # one unbind per stacked leaf: its backward stacks the per-layer
        # gradients into the [L, ...] leaf in one op
        layers = {name: leaf.unbind(0) for name, leaf in params["layers"].items()}
        for i in range(cfg.num_layers):
            per = {name: leaves[i] for name, leaves in layers.items()}
            seed = None if dropout_seed is None else int(dropout_seed) + i
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(self._layer, x, per, positions, seed, train, attn_impl, use_reentrant=False)
            else:
                x = self._layer(x, per, positions, seed, train, attn_impl)
        if cfg.prenorm:
            x = _norm(x, params["final_norm_scale"], params.get("final_norm_bias"), cfg.norm, cfg.norm_eps)
        if cfg.tie_embeddings:
            return x @ params["embed"]["tokens"].to(dt).T
        logits = x @ params["lm_head"].to(dt)
        if cfg.lm_head_bias:
            logits = logits + params["lm_head_bias"].to(logits.dtype)
        return logits

    def _layer(self, x, p, positions, seed, train, attn_impl):
        """One block (``transformer.py:412``): pre-LN or post-LN, parallel
        residual, biases; weights cast to the activation dtype at use."""
        cfg = self.config
        B, T, _ = x.shape
        NH, NKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dt = x.dtype
        gen = None
        if train and seed is not None and (cfg.attn_dropout > 0 or cfg.hidden_dropout > 0):
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed)  # a recomputed layer redraws the same masks
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
        attn = self._attention(q, k, v, positions, gen, train, attn_impl)
        attn = attn.reshape(B, T, NH * D) @ p["wo"].to(dt)
        if cfg.use_bias:
            attn = attn + p["bo"].to(dt)
        if train and cfg.hidden_dropout > 0 and gen is not None:
            attn = _dropout(attn, cfg.hidden_dropout, gen)
        ffn = {name: p[name].to(dt) for name in _FFN_LEAVES if name in p}
        if cfg.parallel_residual:
            h_mlp = h if cfg.shared_parallel_norm else _norm(
                x, p["mlp_norm_scale"], p.get("mlp_norm_bias"), cfg.norm, cfg.norm_eps)
            return x + attn + apply_dense_ffn(ffn, h_mlp, cfg.activation)
        if cfg.prenorm:
            x = x + attn
            h = _norm(x, p["mlp_norm_scale"], p.get("mlp_norm_bias"), cfg.norm, cfg.norm_eps)
        else:
            x = _norm(x + attn, p["attn_norm_scale"], p.get("attn_norm_bias"), cfg.norm, cfg.norm_eps)
            h = x
        out = apply_dense_ffn(ffn, h, cfg.activation)
        if cfg.prenorm:
            return x + out
        return _norm(x + out, p["mlp_norm_scale"], p.get("mlp_norm_bias"), cfg.norm, cfg.norm_eps)

    def _attention(self, q, k, v, positions, gen, train, attn_impl):
        """``_local_full_attention`` (``transformer.py:282``): the flash
        kernels under JAX's condition (``:293-304``), else the grouped
        einsum with the softmax in fp32."""
        cfg = self.config
        scale = cfg.attn_softmax_scale if cfg.attn_softmax_scale is not None else 1.0 / float(np.sqrt(q.shape[-1]))
        NH, NKV = q.shape[2], k.shape[2]
        if cfg.flash_attention and cfg.causal and (not train or cfg.attn_dropout == 0):
            if NKV != NH:
                k, v = _expand_gqa(q, k, v)  # kernel contract: equal head counts
            return flash_attention(q, k, v, causal=True, scale=scale, impl=attn_impl)
        B, T, _, D = q.shape
        G = NH // NKV
        scores = torch.einsum("btkgd,bskd->bkgts", q.reshape(B, T, NKV, G, D), k).float() * scale
        if cfg.causal:
            mask = positions[:, None, None, :, None] >= positions[:, None, None, None, :]
            scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1)
        if train and cfg.attn_dropout > 0 and gen is not None:
            probs = _dropout(probs, cfg.attn_dropout, gen)
        out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)
        return out.reshape(B, T, NH, D)


_FFN_LEAVES = ("w_in", "b_in", "w_gate", "w_up", "w_out", "b_out")


def _dropout(x, rate: float, gen: torch.Generator):
    keep = torch.rand(x.shape, generator=gen, device=x.device) < (1.0 - rate)
    return x * keep / (1.0 - rate)


def _expand_gqa(q, k, v):
    """Repeat kv heads up to q's head count, for the flash kernels only
    (``transformer.py:837``; ``jnp.repeat`` on the head axis)."""
    NH, NKV = q.shape[2], k.shape[2]
    if NKV != NH:
        k = torch.repeat_interleave(k, NH // NKV, dim=2)
        v = torch.repeat_interleave(v, NH // NKV, dim=2)
    return k, v


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
