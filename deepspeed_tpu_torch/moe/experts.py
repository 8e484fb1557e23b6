"""Dense FFN: the dense half of ``deepspeed_tpu/moe/experts.py``.

``apply_dense_ffn`` is the single source of activation semantics for the
decoder's MLP. The JAX version's ``qmatmul`` (``compression/int8.py:97``)
is ``h @ w.astype(h.dtype)`` for plain weights; the port stores weights in
the engine dtype once (``checkpoint/jax_params.py``), so it is ``h @ w``.
Expert stacks are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F


def _pointwise_activation(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu defaults to the tanh form
    if activation == "relu":
        return F.relu(x)
    if activation == "quick_gelu":  # CLIP: x * sigmoid(1.702 x)
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(f"unknown pointwise activation {activation!r}")


def apply_dense_ffn(params: Dict[str, Any], x: torch.Tensor, activation: str = "gelu") -> torch.Tensor:
    """``[..., H] -> [..., H]`` dense FFN over one layer's weights."""
    dt = x.dtype
    if activation in ("swiglu", "geglu"):
        gate = x @ params["w_gate"]
        up = x @ params["w_up"]
        act = F.silu(gate) if activation == "swiglu" else F.gelu(gate, approximate="tanh")
        inner = act * up
    else:
        inner = x @ params["w_in"]
        if "b_in" in params:
            inner = inner + params["b_in"].to(dt)
        inner = _pointwise_activation(inner, activation)
    out = (inner @ params["w_out"]).to(dt)
    if "b_out" in params:
        out = out + params["b_out"].to(dt)
    return out
