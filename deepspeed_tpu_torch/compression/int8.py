"""Int8 serving weights: per-output-channel symmetric quantization.

Counterpart of ``deepspeed_tpu/compression/int8.py`` (no JAX; the port
keeps its own copy). A weight ``[..., in, out]`` is stored as a
``QuantizedTensor``: int8 codes in the weight's own shape plus fp32 scales
with the contraction axis (-2) kept as 1, so a stacked ``[L, in, out]``
layer weight slices per layer exactly like its unquantized form.

* ``scale = max|w| / 127`` per output channel (floored at 1e-30),
  ``q = clip(round(w / scale), -127, 127)``, rounding half to even as
  ``jnp.round`` does; the round trip is within ``scale / 2 =
  max|w_channel| / 254`` elementwise;
* ``qmatmul`` is ``(h @ q.to(h.dtype)) * scale.to(h.dtype)``: the codes cast
  to the activation dtype, the product, then the scales in the activation
  dtype, op for op as JAX computes it (JAX's XLA fuses the cast into the
  matmul; the port's plain version materialises the cast copy of the
  codes). Plain weights take ``h @ w.to(h.dtype)``.

``quantize_params_int8`` quantizes the named matmul weights of a serving
tree (``DEFAULT_QUANT_LEAVES``); embeddings, norms and biases stay exact.
"""

from __future__ import annotations

from typing import Any, Dict, FrozenSet, NamedTuple

import numpy as np
import torch

# the matmul weights of the serving layout (models/transformer.py names): attention projections, FFN and
# the LM head. Embeddings stay exact: their use is a gather, and a tied head would quantize the logits twice.
DEFAULT_QUANT_LEAVES: FrozenSet[str] = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_in", "w_out", "lm_head"}
)

_SCALE_FLOOR = 1e-30  # an all-zero channel must not divide by zero


class QuantizedTensor(NamedTuple):
    """Int8 codes and per-output-channel fp32 scales. ``q`` has the weight's
    shape; ``scale`` keeps axis -2 as 1, so both slice alike under a
    leading layer axis."""

    q: torch.Tensor  # int8, the weight's shape
    scale: torch.Tensor  # float32, the weight's shape with axis -2 reduced to 1

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.ndim

    def nbytes(self) -> int:
        """Device bytes of the codes and the scales."""
        return self.q.numel() * self.q.element_size() + self.scale.numel() * self.scale.element_size()


def quantize_weight_int8(w) -> QuantizedTensor:
    """Per-output-channel symmetric int8 quantization of a matmul weight
    ``[..., in, out]`` (a tensor, on its own device, or a numpy array)."""
    w = torch.as_tensor(w)
    if w.ndim < 2:
        raise ValueError(f"quantize_weight_int8 needs a matmul weight, got ndim {w.ndim}")
    w32 = w.to(torch.float32)
    amax = torch.amax(torch.abs(w32), dim=-2, keepdim=True)
    # a tensor divisor: on a CUDA tensor PyTorch turns division by a Python scalar into a multiply by
    # its reciprocal, which can land an ulp away from JAX's division
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.clamp_min(scale, _SCALE_FLOOR)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale)


def dequantize(w: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    return (w.q.to(torch.float32) * w.scale).to(dtype)


def qmatmul(h: torch.Tensor, w) -> torch.Tensor:
    """``h @ w``, every serving projection's one entry: a quantized ``w``
    multiplies its codes in ``h``'s dtype and scales the product in that
    dtype; a plain ``w`` is cast to ``h``'s dtype."""
    if isinstance(w, QuantizedTensor):
        out = h @ w.q.to(h.dtype)
        # the scale is [..., 1, out] and the product lost the contraction axis; a batched weight stack
        # ([E, H, I]) keeps the size-1 axis so the scale broadcasts over its rows
        scale = w.scale.to(h.dtype)
        if w.q.ndim == 2:
            scale = scale[..., 0, :]
        return out * scale
    return h @ w.to(h.dtype)


def slice_out_channels(w, start: int, size: int):
    """A weight's output channels ``[start, start + size)`` (the last
    axis); a quantized weight slices its codes and scales together."""
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(q=w.q[..., start:start + size], scale=w.scale[..., start:start + size])
    return w[..., start:start + size]


def _is_float_matrix(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.ndim >= 2 and v.is_floating_point()
    if isinstance(v, np.ndarray):
        return v.ndim >= 2 and np.issubdtype(v.dtype, np.floating)
    return False


def quantize_params_int8(params: Any, leaves: FrozenSet[str] = DEFAULT_QUANT_LEAVES) -> Any:
    """A copy of the serving tree with its named matmul weights (floating,
    rank >= 2) as ``QuantizedTensor`` leaves on their own devices; every
    other leaf is the caller's, unchanged."""

    def walk(tree):
        if isinstance(tree, QuantizedTensor):
            return tree  # already quantized
        if isinstance(tree, dict):
            out: Dict[str, Any] = {}
            for k, v in tree.items():
                out[k] = quantize_weight_int8(v) if k in leaves and _is_float_matrix(v) else walk(v)
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree

    return walk(params)


def tree_nbytes(params: Any) -> int:
    """Device bytes of a serving tree's leaves (codes and scales of the
    quantized ones)."""
    if isinstance(params, QuantizedTensor):
        return params.nbytes()
    if isinstance(params, dict):
        return sum(tree_nbytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_nbytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0
