"""The CUDA kernels against their plain versions, on the card: the ragged
paged attention (K4), the flash attention forward and backward (K1-K3),
and the decode attention over a contiguous cache (K6) and over pages (K5).
A CPU tensor handed straight to a kernel entry raises (that test needs no
card).

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


DECODE_CASES = {  # (B, NH, NKV, D, S, lens)
    "GQA D=64": (3, 8, 2, 64, 512, [0, 200, 512]),
    "MHA D=128": (2, 4, 4, 128, 256, [77, 256]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_kernel_matches_plain_on_card(cuda_device, case, dtype, monkeypatch):
    """K6 against its plain version in fp32 on the same (cast) inputs, TF32
    off: fp32 within 1e-4, bf16 within 2e-2 (bf16 output rounding); rows
    of length 0 exact zeros."""
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    B, NH, NKV, D, S, lens = DECODE_CASES[case]
    rs = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda_device).to(dtype)
               for shape in ((B, NH, D), (B, S, NKV, D), (B, S, NKV, D)))
    lens_d = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = da.launches_decode
    out = da.decode_attention(q, k, v, lens_d)
    ref = da.decode_attention_plain(q.float(), k.float(), v.float(), lens_d)
    torch.cuda.synchronize()
    assert da.launches_decode == before + 1
    assert (out.float() - ref).abs().max().item() <= (1e-4 if dtype == torch.float32 else 2e-2)
    assert (out[lens_d == 0] == 0).all()


PAGED_CASES = {  # (NH, NKV, D, P, NP, tables, lens)
    "Hg=8 D=64 P=16": (32, 4, 64, 16, 40, [[3, 9, 1, 30, 12, 7], [22, 5], [], [17]], [90, 20, 0, 1]),
    "Hg=7 D=128 P=64": (28, 4, 128, 64, 12, [[3, 9], [5], []], [100, 64, 0]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_decode_kernel_matches_plain_on_card(cuda_device, case, dtype, monkeypatch):
    """K5 against the plain version in fp32 on the same (cast) inputs, TF32
    off, tables ending in -1 sentinels: fp32 within 1e-4, bf16 within
    2e-2; dead rows exact zeros."""
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    NH, NKV, D, P, NP, tables, lens = PAGED_CASES[case]
    B = len(lens)
    rs = np.random.RandomState(6)
    q = torch.from_numpy(rs.randn(B, NH, D).astype(np.float32)).to(cuda_device).to(dtype)
    kp, vp = (torch.from_numpy(rs.randn(NP, NKV, P, D).astype(np.float32)).to(cuda_device).to(dtype)
              for _ in range(2))
    pt = np.full((B, 8), -1, np.int32)
    for b, ids in enumerate(tables):
        pt[b, : len(ids)] = ids
    pt_d = torch.from_numpy(pt).to(cuda_device)
    lens_d = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = da.launches_paged
    out = torch_pa.paged_decode_attention(q, kp, vp, pt_d, lens_d, impl="kernel")
    ref = torch_pa.paged_decode_attention(q.float(), kp.float(), vp.float(), pt_d, lens_d, impl="plain")
    torch.cuda.synchronize()
    assert da.launches_paged == before + 1
    assert (out.float() - ref).abs().max().item() <= (1e-4 if dtype == torch.float32 else 2e-2)
    assert (out[lens_d == 0] == 0).all()


def test_kernel_entries_reject_cpu_tensors():
    """The bare launches take CUDA tensors only: a CPU tensor raises before
    any library is built or any count moves."""
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da

    q = torch.zeros(2, 8, 64)
    cache = torch.zeros(2, 256, 2, 64)
    pages = torch.zeros(4, 2, 16, 64)
    table = torch.zeros(2, 4, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    counts = (da.launches, da.launches_decode, da.launches_paged)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_kernel(q, cache, cache, lens, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        da.paged_decode_attention_kernel(q, pages, pages, table, lens, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        da.ragged_paged_attention(q[:, None], pages, pages, table, lens, lens, 0.125)
    assert (da.launches, da.launches_decode, da.launches_paged) == counts
