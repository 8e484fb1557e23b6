"""The decoder's parameters and its shared pointwise pieces.

Counterpart of ``deepspeed_tpu/models/transformer.py``. ``TransformerLM``
is an ``nn.Module`` that holds the parameters in the JAX package's tree
layout (``models/transformer.py:157-218``): ``embed.tokens`` /
``embed.pos``, the per-layer weights stacked on a leading ``[L, ...]`` axis
under ``layers``, ``final_norm_*`` and ``lm_head``. Layer ``l`` reads
``layers[name][l]``, a view, so the stacked layout costs nothing. Weights
are ``x @ w`` oriented (``[in, out]``), as in JAX.

A new module holds its parameters on the ``meta`` device (no memory); they
become real through ``checkpoint/jax_params.py:load_jax_params`` (the JAX
tree as numpy), which is how weights enter the port.
The serving forward lives in ``inference/decode.py`` and reads the tree
returned by ``param_tree()``.

``_norm`` and ``_rope`` compute in fp32 and cast back to the input dtype,
exactly as the JAX functions do.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from deepspeed_tpu_torch.models.config import TransformerConfig

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
    s["final_norm_scale"] = (H,)
    if cfg.norm == "layernorm":
        s["final_norm_bias"] = (H,)
    if not cfg.tie_embeddings:
        s["lm_head"] = (H, V)
        if cfg.lm_head_bias:
            s["lm_head_bias"] = (V,)
    return s


class TransformerLM(nn.Module):
    """Decoder parameters in the JAX tree layout (see module docstring).

    Covers the dense features the paged serving forward handles: layernorm
    and rmsnorm, learned and rope positions (``rope_dim`` included),
    ``qkv_bias``, ``use_bias``, tied or untied head, ``lm_head_bias``,
    ``parallel_residual`` / ``shared_parallel_norm`` and
    ``attn_softmax_scale``. MoE and ALiBi models raise."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        if config.position == "alibi":
            raise NotImplementedError("alibi attention biases are not ported (the JAX serving path rejects them too)")
        if getattr(config, "num_experts", 0):
            raise NotImplementedError("MoE models are not ported yet (ROADMAP M1)")
        if config.embed_norm or not config.prenorm:
            raise NotImplementedError(
                "embed_norm / post-LN models are not on the paged serving path"
            )
        self.config = config
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
