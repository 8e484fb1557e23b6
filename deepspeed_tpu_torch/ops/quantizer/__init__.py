"""Block quantization ops.

Counterpart of ``deepspeed_tpu/ops/quantizer/__init__.py`` (no JAX; the port
keeps its own copy): symmetric and asymmetric per-group quantization to
int8 (or fewer bits), the quantize-dequantize round trip with a
straight-through gradient (``fake_quantize``, the engine's
``quant.enabled`` path), and the object API. A tensor is flattened and
viewed as ``[num_groups, group_size]`` of contiguous elements; each group
carries its own scale (and minimum, asymmetric). The arithmetic is in fp32,
op for op as the JAX functions compute it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _grouped(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    flat = x.reshape(-1)
    if flat.shape[0] % num_groups != 0:
        raise ValueError(f"{flat.shape[0]} elements not divisible into {num_groups} groups")
    return flat.reshape(num_groups, -1)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as IEEE division: on a CUDA tensor PyTorch turns
    division by a Python scalar into a multiply by its reciprocal, which
    can land an ulp away from JAX's quotient."""
    return x / torch.full_like(x, c)


def quantize(x: torch.Tensor, num_groups: int, num_bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-group quantization: ``(q [num_groups, group_size]
    int8, scales [num_groups] fp32)``."""
    g = _grouped(x, num_groups).to(torch.float32)
    qmax = float(2 ** (num_bits - 1) - 1)
    absmax = torch.amax(torch.abs(g), dim=1, keepdim=True)
    scale = torch.where(absmax > 0, _div(absmax, qmax), torch.ones_like(absmax))
    q = torch.clamp(torch.round(g / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale[:, 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape=None, dtype=torch.float32) -> torch.Tensor:
    out = q.to(torch.float32) * scale[:, None]
    if shape is not None:
        out = out.reshape(shape)
    return out.to(dtype)


def quantize_asymmetric(x: torch.Tensor, num_groups: int,
                        num_bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric per-group quantization (minimum and scale): ``(q, scale,
    minv)``, the codes unsigned (uint8; int32 past 8 bits, where JAX takes
    uint16, which torch lacks as a tensor type on every device)."""
    g = _grouped(x, num_groups).to(torch.float32)
    levels = float(2**num_bits - 1)
    minv = torch.amin(g, dim=1, keepdim=True)
    maxv = torch.amax(g, dim=1, keepdim=True)
    scale = torch.where(maxv > minv, _div(maxv - minv, levels), torch.ones_like(maxv))
    q = torch.clamp(torch.round((g - minv) / scale), 0, levels).to(torch.int32 if num_bits > 8 else torch.uint8)
    return q, scale[:, 0], minv[:, 0]


def dequantize_asymmetric(q, scale, minv, shape=None, dtype=torch.float32) -> torch.Tensor:
    out = q.to(torch.float32) * scale[:, None] + minv[:, None]
    if shape is not None:
        out = out.reshape(shape)
    return out.to(dtype)


class _FakeQuantize(torch.autograd.Function):
    """The round trip forward, the gradient straight through backward."""

    @staticmethod
    def forward(ctx, x, num_groups, num_bits):  # noqa: ARG004
        q, s = quantize(x, num_groups, num_bits)
        return dequantize(q, s, shape=x.shape, dtype=x.dtype)

    @staticmethod
    def backward(ctx, grad):  # noqa: ARG004
        return grad, None, None


def fake_quantize(x: torch.Tensor, num_groups: int, num_bits: int = 8) -> torch.Tensor:
    """Quantize-dequantize round trip with a straight-through gradient (the
    reference's ``fake_quantizer.cu`` for QAT)."""
    return _FakeQuantize.apply(x, int(num_groups), int(num_bits))


def swizzle_quant(x: torch.Tensor, num_groups: int, num_bits: int = 8):
    """The reference's ``swizzled_quantize`` reorders groups for coalesced
    reads; the groups' values are plain ``quantize``'s, as in JAX."""
    return quantize(x, num_groups, num_bits)


class Quantizer:
    """Object API of the compression code paths."""

    def __init__(self, q_bits: int = 8, q_groups: int = 1):
        self.q_bits = q_bits
        self.q_groups = q_groups

    def quantize(self, x):
        return quantize(x, self.q_groups, self.q_bits)

    def dequantize(self, q, scale, shape=None, dtype=torch.float32):
        return dequantize(q, scale, shape, dtype)
