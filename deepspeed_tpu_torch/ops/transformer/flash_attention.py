"""Flash attention for training: the forward (K1) and backward (K2, K3).

Counterpart of ``deepspeed_tpu/ops/transformer/flash_attention.py``. The
three Pallas kernels there become three CUDA kernels in
``csrc/flash_attention.cu``, built with ``nvcc`` on first use and bound
through ``ctypes`` (``ops/native.py``):

* K1 ``_fwd_kernel`` (``:63``): O and the fp32 log-sum-exp of each row;
* K2 ``_dq_kernel`` (``:165``): dQ from LSE and Δ = rowsum(dO∘O);
* K3 ``_dkv_kernel`` (``:196``): dK and dV.

``flash_attention(q, k, v, causal, scale)`` takes ``[B, T, N, D]`` with
equal head counts (GQA is expanded by the caller) and is differentiable: a
``torch.autograd.Function`` whose forward runs K1 and saves
``(q, k, v, o, lse)``, and whose backward computes Δ in fp32 with plain
torch ops (JAX computes it in XLA outside the kernels, ``:236``) and runs
K2 and K3. Unlike JAX the sequence is not padded to a block: the kernels
mask the ragged edge themselves. LSE is a plain ``[B·N, T]`` fp32 array.

Each kernel has a plain PyTorch version here (``flash_fwd_plain``,
``flash_dq_plain``, ``flash_dkv_plain``) that keeps the Pallas kernel's
math and casts: operands in their dtype multiplied with fp32 accumulation,
scores scaled after the product, finite ``NEG_INF`` masking, and P → v's
dtype before P·V, dS → k's dtype before dS·K, P → dO's dtype before Pᵀ·dO
and dS → q's dtype before dSᵀ·Q. A CPU tensor takes the plain versions; a
CUDA tensor launches the kernels or raises (``impl="plain"`` asks for the
plain versions on the card, as the comparison arm).

K1 and K3 have two variants in the CUDA source, chosen by dtype: bf16 and
fp16 run on the tensor cores (``mma.sync``), fp32 keeps the FMA kernels as
the card's parity path. ``launches_fwd``, ``launches_dq`` and
``launches_dkv`` count the kernels' launches and nothing else;
``launches_fwd_tc`` and ``launches_dkv_tc`` count the K1 and K3 launches
that the CUDA entry reports as the tensor-core variant.
Nothing CUDA is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128)

launches_fwd = 0  # K1 launches since the caller last set it to 0
launches_fwd_tc = 0  # of those, launches of the tensor-core variant (bf16, fp16)
launches_dq = 0  # K2
launches_dkv = 0  # K3
launches_dkv_tc = 0  # of those, launches of the tensor-core variant (bf16, fp16)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_entries = {}


# --- plain versions ----------------------------------------------------------
def _scores(q, k, causal: bool, scale: float):
    """fp32 ``[B, N, T, T]`` scaled scores, masked to ``NEG_INF`` above the
    diagonal when causal."""
    s = torch.einsum("btnd,bsnd->bnts", q.float(), k.float()) * scale
    if causal:
        T = q.shape[1]
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def flash_fwd_plain(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """K1's function: ``(o [B, T, N, D] in q's dtype, lse [B·N, T] fp32)``."""
    B, T, N, D = q.shape
    scale = _default_scale(D, scale)
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    acc = torch.einsum("bnts,bsnd->btnd", p.to(v.dtype).float(), v.float())
    o = (acc / safe_l.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(safe_l))[..., 0].reshape(B * N, T)
    return o, lse


def _probs(q, k, lse, causal, scale):
    """Recomputed fp32 probabilities ``exp(s - lse)``, ``[B, N, T, T]``."""
    B, T, N, _ = q.shape
    return torch.exp(_scores(q, k, causal, scale) - lse.reshape(B, N, T, 1))


def _dscores(p, do, v, delta, scale):
    """fp32 dS = P ∘ (dO·Vᵀ − Δ) · scale, before any cast."""
    B, T, N, _ = do.shape
    dp = torch.einsum("btnd,bsnd->bnts", do.float(), v.float())
    return p * (dp - delta.reshape(B, N, T, 1)) * scale


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool = True, scale: Optional[float] = None):
    """K2's function: dQ in q's dtype. ``lse`` and ``delta`` are ``[B·N, T]``
    fp32."""
    scale = _default_scale(q.shape[-1], scale)
    p = _probs(q, k, lse, causal, scale)
    ds = _dscores(p, do, v, delta, scale).to(k.dtype)
    return torch.einsum("bnts,bsnd->btnd", ds.float(), k.float()).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool = True, scale: Optional[float] = None):
    """K3's function: ``(dK, dV)`` in k's and v's dtypes."""
    scale = _default_scale(q.shape[-1], scale)
    p = _probs(q, k, lse, causal, scale)
    dv = torch.einsum("bnts,btnd->bsnd", p.to(do.dtype).float(), do.float())
    ds = _dscores(p, do, v, delta, scale).to(q.dtype)
    dk = torch.einsum("bnts,btnd->bsnd", ds.float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_delta(o, do):
    """Δ = rowsum(dO∘O) in fp32, as ``[B·N, T]`` (``flash_attention.py:236``)."""
    B, T, N, _ = o.shape
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(B * N, T).contiguous()


# --- the CUDA kernels --------------------------------------------------------
def _entry(name: str):
    fn = _entries.get(name)
    if fn is None:
        from deepspeed_tpu_torch.ops import native

        fn = getattr(native.load("flash_attention"), name)
        fn.restype = ctypes.c_int
        n_ptrs = {"flash_fwd": 5, "flash_dq": 7, "flash_dkv": 8}[name]
        fn.argtypes = (
            [ctypes.c_int]  # dtype code
            + [ctypes.c_void_p] * n_ptrs
            + [ctypes.c_int] * 5  # B, T, N, D, causal
            + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
            + ([ctypes.POINTER(ctypes.c_int)] if name in ("flash_fwd", "flash_dkv") else [])  # the variant
        )
        _entries[name] = fn
    return fn


def _check(q, k, v, *more):
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA flash attention kernels take CUDA tensors, got q on {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16, float16)")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, N, D], got {tuple(q.shape)}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not supported by the kernels (supported: {HEAD_DIMS})")
    for name, t in (("k", k), ("v", v)) + tuple(more):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must match q {tuple(q.shape)} (expand GQA first)")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} must match q's {q.dtype}")


def _launch(name: str, q, ptrs, causal: bool, scale: float, *out) -> None:
    B, T, N, D = q.shape
    fn = _entry(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], *ptrs, B, T, N, D, int(bool(causal)), float(scale), stream, *out)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def flash_fwd_kernel(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Launch K1 on the current stream: ``(o, lse)`` as ``flash_fwd_plain``."""
    global launches_fwd, launches_fwd_tc
    _check(q, k, v)
    B, T, N, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B * N, T, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    variant = ctypes.c_int(-1)
    _launch("flash_fwd", q, (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr()),
            causal, _default_scale(D, scale), ctypes.byref(variant))
    launches_fwd += 1
    launches_fwd_tc += int(variant.value == 1)
    return o, lse


def _check_residuals(q, do, lse, delta):
    B, T, N, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B * N, T) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 [B*N, T] = {(B * N, T)}, got {tuple(t.shape)} {t.dtype}")


def flash_dq_kernel(q, k, v, do, lse, delta, causal: bool = True, scale: Optional[float] = None):
    """Launch K2: dQ as ``flash_dq_plain``."""
    global launches_dq
    _check(q, k, v, ("do", do), ("lse", lse), ("delta", delta))
    _check_residuals(q, do, lse, delta)
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    _launch("flash_dq", q, (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                            delta.data_ptr(), dq.data_ptr()), causal, _default_scale(q.shape[-1], scale))
    launches_dq += 1
    return dq


def flash_dkv_kernel(q, k, v, do, lse, delta, causal: bool = True, scale: Optional[float] = None):
    """Launch K3: ``(dK, dV)`` as ``flash_dkv_plain``."""
    global launches_dkv, launches_dkv_tc
    _check(q, k, v, ("do", do), ("lse", lse), ("delta", delta))
    _check_residuals(q, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    variant = ctypes.c_int(-1)
    _launch("flash_dkv", q, (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                             delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            causal, _default_scale(q.shape[-1], scale), ctypes.byref(variant))
    launches_dkv += 1
    launches_dkv_tc += int(variant.value == 1)
    return dk, dv


# --- dispatch and autograd -----------------------------------------------------
def _default_scale(D: int, scale: Optional[float]) -> float:
    return float(1.0 / np.sqrt(D)) if scale is None else float(scale)


def _use_kernel(x: torch.Tensor, impl: Optional[str]) -> bool:
    """``None``/``"auto"``/``"kernel"``: the kernel for a CUDA tensor, the
    plain version for a CPU one; ``"plain"``: the plain version anywhere."""
    if impl not in (None, "auto", "kernel", "plain"):
        raise ValueError(f"unknown attention impl {impl!r} (auto, kernel, plain)")
    if impl == "plain" or x.device.type == "cpu":
        return False
    return True


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, impl: Optional[str]):
        kernel = _use_kernel(q, impl)
        o, lse = (flash_fwd_kernel if kernel else flash_fwd_plain)(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.kernel = causal, scale, kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_delta(o, do)
        if ctx.kernel:
            dq = flash_dq_kernel(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
            dk, dv = flash_dkv_kernel(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        else:
            dq = flash_dq_plain(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
            dk, dv = flash_dkv_plain(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Fused attention over ``[B, T, N, D]`` (heads-last, as the model lays
    them out), differentiable in q, k and v. Equal head counts only (GQA
    is expanded by the caller); any T (the kernels mask the ragged edge);
    D in ``HEAD_DIMS`` on the card."""
    B, T, N, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention requires equal q/kv shapes, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), bool(causal),
                                 _default_scale(D, scale), impl)

