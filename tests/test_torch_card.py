"""The CUDA kernels against their plain versions, on the card: the ragged
paged attention (K4) and the flash attention forward and backward (K1-K3).

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX: ``python -m pytest --noconftest
tests/test_torch_card.py -q`` (``--noconftest``: the suite's conftest sets
up JAX). Without a card every test here skips.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.transformer import paged_attention as torch_pa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode (run on the card)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, dtype, monkeypatch):
    """On the card: the CUDA kernel against the plain version in fp32 on the
    same inputs (TF32 off, restored afterwards). fp32 within 1e-4; bf16
    within 2e-2 (bf16 output rounding: 2^-8 relative on values of order 1)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rs = np.random.RandomState(11)
    R, W, NH, NKV, D, P, NP, maxp = 4, 8, 16, 2, 64, 16, 40, 8
    q = torch.from_numpy(rs.randn(R, W, NH, D).astype(np.float32)).to(cuda_device)
    kp = torch.from_numpy(rs.randn(NP, NKV, P, D).astype(np.float32)).to(cuda_device)
    vp = torch.from_numpy(rs.randn(NP, NKV, P, D).astype(np.float32)).to(cuda_device)
    pt = np.full((R, maxp), -1, np.int32)
    pt[0, :6] = [3, 9, 1, 30, 12, 7]
    pt[1, :2] = [22, 5]
    pt[2, :1] = [17]
    kv_lens = np.array([90, 20, 8, 0], np.int32)
    q_lens = np.array([1, 8, 8, 0], np.int32)
    pt_d, kl_d, ql_d = (torch.from_numpy(a).to(cuda_device) for a in (pt, kv_lens, q_lens))
    args = (q.to(dtype), kp.to(dtype), vp.to(dtype))
    out = torch_pa.ragged_paged_attention(*args, pt_d, kl_d, ql_d, impl="kernel").float().cpu().numpy()
    ref = torch_pa.ragged_paged_attention(*(a.float() for a in args), pt_d, kl_d, ql_d,
                                          impl="plain").cpu().numpy()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for r, ql in enumerate(q_lens):
        np.testing.assert_allclose(out[r, :ql], ref[r, :ql], atol=tol, rtol=0, err_msg=f"row {r}")
    assert (out[3] == 0).all()


FLASH_CASES = {  # (B, T, N, D, causal)
    "T=200 causal": (2, 200, 3, 64, True),
    "T=256 full": (2, 256, 2, 64, False),
    "D=128 T=130 causal": (1, 130, 2, 128, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain_on_card(cuda_device, case, dtype, monkeypatch):
    """On the card: K1, K2 and K3 against their plain versions in fp32 on
    the same (cast) inputs, TF32 off. fp32: O and LSE within 1e-4, each
    gradient within 1e-3 of the reference's largest magnitude; bf16/fp16:
    O within 2e-2 and each gradient within 3e-2 of that magnitude (the
    kernels round P and dS to the input type before their products, as the
    TPU kernels do, and write their outputs in it)."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    B, T, N, D, causal = FLASH_CASES[case]
    rs = np.random.RandomState(3)
    q, k, v, do = (torch.from_numpy(rs.randn(B, T, N, D).astype(np.float32)).to(cuda_device).to(dtype)
                   for _ in range(4))
    o, lse = fa.flash_fwd_kernel(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q.float(), k.float(), v.float(), causal)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_dq_kernel(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_dkv_kernel(q, k, v, do, lse, delta, causal)
    f = lambda t: t.float()  # noqa: E731
    dq_ref = fa.flash_dq_plain(f(q), f(k), f(v), f(do), lse, delta, causal)
    dk_ref, dv_ref = fa.flash_dkv_plain(f(q), f(k), f(v), f(do), lse, delta, causal)
    torch.cuda.synchronize()
    exact = dtype == torch.float32
    assert (o.float() - o_ref).abs().max().item() <= (1e-4 if exact else 2e-2)
    assert (lse - lse_ref).abs().max().item() <= (1e-4 if exact else 2e-2)
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        rel = ((got.float() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= (1e-3 if exact else 3e-2), (case, dtype, rel)


def test_flash_attention_autograd_launches_kernels(cuda_device):
    """A CUDA tensor through ``flash_attention`` launches K1 forward and K2,
    K3 backward, once each."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    q, k, v = (torch.randn(1, 128, 2, 64, device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    fa.flash_attention(q, k, v).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == tuple(n + 1 for n in before)
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in (q, k, v))
