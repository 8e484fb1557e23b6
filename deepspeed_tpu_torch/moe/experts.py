"""Dense FFN: the dense half of ``deepspeed_tpu/moe/experts.py``.

``apply_dense_ffn`` is the single source of activation semantics for the
decoder's MLP. Every projection goes through ``compression.int8.qmatmul``,
as in JAX: ``h @ w.to(h.dtype)`` for a plain weight (a no-op cast for the
engine-dtype weights ``checkpoint/jax_params.py`` stores), the codes and
scales of a ``QuantizedTensor`` for an int8 serving weight. Expert stacks
are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.compression.int8 import qmatmul


def _pointwise_activation(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu defaults to the tanh form
    if activation == "relu":
        return F.relu(x)
    if activation == "quick_gelu":  # CLIP: x * sigmoid(1.702 x)
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(f"unknown pointwise activation {activation!r}")


def apply_dense_ffn(params: Dict[str, Any], x: torch.Tensor, activation: str = "gelu", tp=None) -> torch.Tensor:
    """``[..., H] -> [..., H]`` dense FFN over one layer's weights. Under
    tensor parallelism (``tp``, an ``inference/tp.py:TPServing``) the
    up and gate projections are column-parallel (this rank's slices), the
    down projection is row-parallel through ``tp.row_matmul``'s
    all-reduces, and the replicated output bias is added once, after the
    reduce."""
    dt = x.dtype
    if activation in ("swiglu", "geglu"):
        gate = qmatmul(x, params["w_gate"])
        up = qmatmul(x, params["w_up"])
        act = F.silu(gate) if activation == "swiglu" else F.gelu(gate, approximate="tanh")
        inner = act * up
    else:
        inner = qmatmul(x, params["w_in"])
        if "b_in" in params:
            inner = inner + params["b_in"].to(dt)
        inner = _pointwise_activation(inner, activation)
    out = (tp.row_matmul(inner, params["w_out"]) if tp is not None else qmatmul(inner, params["w_out"])).to(dt)
    if "b_out" in params:
        out = out + params["b_out"].to(dt)
    return out
