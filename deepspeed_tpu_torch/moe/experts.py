"""Dense and stacked expert FFNs (``deepspeed_tpu/moe/experts.py``).

``apply_dense_ffn`` is the single source of activation semantics for the
decoder's MLP and the PR-MoE residual. ``apply_expert_ffn`` runs every
expert on its capacity slice ``[E, C, H]`` as one batched product over the
stacked ``[E, ...]`` weights (no loop over experts). Every projection goes
through ``compression.int8.qmatmul``, as in JAX: ``h @ w.to(h.dtype)`` for a
plain weight, the codes and scales of a ``QuantizedTensor`` for an int8
serving weight (an expert stack keeps its scales as ``[E, 1, I]``, which
broadcast over the capacity rows). ``init_dense_ffn`` / ``init_expert_ffn``
draw numpy trees with the JAX init's distributions (weights enter the port
as the JAX tree).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
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


def _ffn_shapes(lead: tuple, H: int, I: int, activation: str, use_bias: bool) -> Dict[str, tuple]:
    s: Dict[str, tuple] = {}
    if activation in ("swiglu", "geglu"):
        s["w_gate"] = lead + (H, I)
        s["w_up"] = lead + (H, I)
    else:
        s["w_in"] = lead + (H, I)
        if use_bias:
            s["b_in"] = lead + (I,)
    s["w_out"] = lead + (I, H)
    if use_bias:
        s["b_out"] = lead + (H,)
    return s


def _draw(shapes: Dict[str, tuple], rng: np.random.Generator, std: float, out_std: Optional[float]):
    out_std = std if out_std is None else out_std
    tree = {}
    for name, shape in shapes.items():
        if name.startswith("b"):
            tree[name] = np.zeros(shape, np.float32)
        else:
            tree[name] = rng.standard_normal(shape, dtype=np.float32) * np.float32(
                out_std if name == "w_out" else std)
    return tree


def dense_ffn_shapes(hidden_size: int, intermediate_size: int, activation: str = "gelu",
                     use_bias: bool = True) -> Dict[str, tuple]:
    """The leaves of one dense FFN (JAX ``init_dense_ffn``'s tree)."""
    return _ffn_shapes((), hidden_size, intermediate_size, activation, use_bias)


def expert_ffn_shapes(num_experts: int, hidden_size: int, intermediate_size: int, activation: str = "gelu",
                      use_bias: bool = True) -> Dict[str, tuple]:
    """The leaves of a stacked expert FFN, each leading with ``[E, ...]``
    (JAX ``init_expert_ffn``'s tree)."""
    return _ffn_shapes((num_experts,), hidden_size, intermediate_size, activation, use_bias)


def init_dense_ffn(rng: np.random.Generator, hidden_size: int, intermediate_size: int, activation: str = "gelu",
                   use_bias: bool = True, std: float = 0.02, out_std: Optional[float] = None) -> Dict[str, Any]:
    """One dense FFN as numpy: normal(std) weights (``out_std`` for
    ``w_out``), zero biases."""
    return _draw(dense_ffn_shapes(hidden_size, intermediate_size, activation, use_bias), rng, std, out_std)


def init_expert_ffn(rng: np.random.Generator, num_experts: int, hidden_size: int, intermediate_size: int,
                    activation: str = "gelu", use_bias: bool = True, std: float = 0.02,
                    out_std: Optional[float] = None) -> Dict[str, Any]:
    """A stacked expert FFN as numpy, every leaf ``[E, ...]``."""
    return _draw(expert_ffn_shapes(num_experts, hidden_size, intermediate_size, activation, use_bias), rng, std,
                 out_std)


def apply_expert_ffn(params: Dict[str, Any], x: torch.Tensor, activation: str = "gelu") -> torch.Tensor:
    """``[E, C, H] -> [E, C, H]``: each expert's FFN on its capacity slice,
    one batched ``x @ w`` per projection (JAX ``einsum("ech,ehi->eci")``);
    biases ``[E, ...]`` broadcast over the capacity rows."""
    dt = x.dtype
    if activation in ("swiglu", "geglu"):
        gate = qmatmul(x, params["w_gate"])
        up = qmatmul(x, params["w_up"])
        act = F.silu(gate) if activation == "swiglu" else F.gelu(gate, approximate="tanh")
        inner = act * up
    else:
        inner = qmatmul(x, params["w_in"])
        if "b_in" in params:
            inner = inner + params["b_in"][:, None, :].to(dt)
        inner = _pointwise_activation(inner, activation)
    out = qmatmul(inner, params["w_out"]).to(dt)
    if "b_out" in params:
        out = out + params["b_out"][:, None, :].to(dt)
    return out


def expert_partition_rules(params: Dict[str, Any]) -> Dict[str, Any]:
    """The stacked expert dim on the ``expert`` mesh axis (JAX's
    ``PartitionSpec("expert", None, ...)`` as a tuple of entries, the
    port's spec form, ``runtime/zero/partition.py``)."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return ("expert",) + (None,) * (len(tree.shape) - 1)
    return walk(params)
