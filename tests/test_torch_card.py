"""The CUDA kernels against their plain versions, on the card: the ragged
paged attention (K4, split-KV: kv_len on and past split boundaries,
bitwise-equal repeated calls), the flash attention forward and backward
(K1-K3), the decode attention over a contiguous cache (K6, split-KV:
fp32/bf16/fp16, a group of 7, S = 100, kv_len on and past split boundaries
and past S, bitwise-equal repeated calls) and over pages (K5, split-KV:
buckets 1/2/4/8, split boundaries, bitwise-equal repeated calls), and the block-sparse attention forward and backward (K7-K9), with
K1-K3 and K7-K9 on their tensor-core variants in bf16 and fp16 and on FMA
in fp32 (the variant counters, K7's and K8's split rows and dead rows,
K9's split columns and dead keys, bitwise-equal repeated calls, K8's dS
kept in fp32 on keys where rounding it would show); K4 at the speculative
verify shape (width 5), fp32 speculation equal to speculation-off (ragged
on K4, bucketed with K5 rounds), a journaled server killed at a chaos
point and recovered with its streams unchanged; a window graph replaying
after the pool defrags under it, int8 codes and ``qmatmul`` on the card
against the CPU, an int8 tree in a window graph, and a two-replica fleet
with a migration and a replica kill; a training checkpoint saved on the
card loaded into a CPU engine (every state leaf equal), and an async
snapshot that two in-place steps on the card do not reach; a captured
fused training step bitwise the eager step, a `safe_set_full_fp32_param`
that the next replay trains from, and a batch resize that returns the graph
pool.
A CPU tensor handed straight to a kernel entry raises (those tests need no
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


def _ragged_case(rs, rows, W, NH, NKV, D, P, maxp, dev):
    """q [R, W, NH, D] and pools whose every slot is large garbage except
    the live positions of each row's distinct pages; tables end in -1
    sentinels. ``rows`` is a list of (kv_len, q_len)."""
    NP = 1 + sum(-(-kv // P) for kv, _ in rows)
    kp = np.full((NP, NKV, P, D), 3.0e4, np.float32)
    vp = -kp
    pt = np.full((len(rows), maxp), -1, np.int32)
    free = rs.permutation(np.arange(1, NP))
    used = 0
    for r, (kv_len, _) in enumerate(rows):
        n = -(-kv_len // P)
        pt[r, :n] = free[used : used + n]
        used += n
        for i in range(n):
            live = min(P, kv_len - i * P)
            kp[pt[r, i], :, :live] = rs.randn(NKV, live, D)
            vp[pt[r, i], :, :live] = rs.randn(NKV, live, D)
    q = rs.randn(len(rows), W, NH, D).astype(np.float32)
    kv_lens = np.array([r[0] for r in rows], np.int32)
    q_lens = np.array([r[1] for r in rows], np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (q, kp, vp, pt, kv_lens, q_lens))


# tables of 32 pages of 16 keys: 512 keys, four splits of 128. kv_len on a split boundary and one
# past it (decode rows and chunks crossing the boundary), a row with one key in its last split, a
# full row, a partial chunk, a dead row
RAGGED_SPLIT_ROWS = [(128, 1), (129, 1), (256, 8), (257, 8), (385, 1), (512, 8), (5, 3), (0, 0)]
RAGGED_SPLIT_SHAPES = {"D=64 Hg=4 P=16": (8, 16, 4, 64, 16, 32), "D=128 Hg=7 P=64": (8, 28, 4, 128, 64, 8)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", sorted(RAGGED_SPLIT_SHAPES))
def test_ragged_split_boundaries_match_plain_on_card(cuda_device, shape, dtype, monkeypatch):
    """K4's split-KV kernel and combine against the plain version in fp32
    on the same (cast) inputs, TF32 off, with kv_len on and one past split
    boundaries: fp32 within 1e-4, bf16/fp16 within 2e-2 (output rounding;
    P.V runs as hi + lo products, about 2^-16 of P); dead rows and window
    slots past q_len exact zeros; one split-KV call counted."""
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    W, NH, NKV, D, P, maxp = RAGGED_SPLIT_SHAPES[shape]
    q, kp, vp, pt, kv_lens, q_lens = _ragged_case(np.random.RandomState(12), RAGGED_SPLIT_ROWS, W, NH, NKV,
                                                  D, P, maxp, cuda_device)
    args = (q.to(dtype), kp.to(dtype), vp.to(dtype))
    before = (da.launches, da.launches_ragged_split)
    out = torch_pa.ragged_paged_attention(*args, pt, kv_lens, q_lens, impl="kernel")
    ref = torch_pa.ragged_paged_attention(*(a.float() for a in args), pt, kv_lens, q_lens, impl="plain")
    torch.cuda.synchronize()
    assert (da.launches, da.launches_ragged_split) == (before[0] + 1, before[1] + 1)
    assert da.ragged_splits(maxp, P) == 4
    live = torch.arange(W, device=cuda_device)[None, :] < q_lens[:, None]
    err = (out.float() - ref).abs()[live].max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2), err
    assert (out[~live] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_bitwise_deterministic_on_card(cuda_device, dtype):
    """Two K4 calls on the same inputs are bitwise equal: the partials are
    merged in split order, with no atomics."""
    W, NH, NKV, D, P, maxp = RAGGED_SPLIT_SHAPES["D=64 Hg=4 P=16"]
    q, kp, vp, pt, kv_lens, q_lens = _ragged_case(np.random.RandomState(13), RAGGED_SPLIT_ROWS, W, NH, NKV,
                                                  D, P, maxp, cuda_device)
    args = (q.to(dtype), kp.to(dtype), vp.to(dtype), pt, kv_lens, q_lens)
    first = torch_pa.ragged_paged_attention(*args, impl="kernel")
    second = torch_pa.ragged_paged_attention(*args, impl="kernel")
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       second.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


FLASH_CASES = {  # (B, T, N, D, causal)
    "T=200 causal": (2, 200, 3, 64, True),
    "T=256 full": (2, 256, 2, 64, False),
    "D=128 T=130 causal": (1, 130, 2, 128, True),
    "D=80 T=200 causal": (2, 200, 3, 80, True),
    "D=80 T=130 full": (1, 130, 2, 80, False),
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
    before = (fa.launches_fwd, fa.launches_fwd_tc)
    o, lse = fa.flash_fwd_kernel(q, k, v, causal)
    # bf16 and fp16 take K1's tensor-core variant, fp32 the FMA variant
    assert (fa.launches_fwd - before[0], fa.launches_fwd_tc - before[1]) == (1, int(dtype != torch.float32))
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


DKV_TC_CASES = {  # chip_smoke's four flash shapes and D=128 at T=130; (B, T, N, D, causal)
    "train B=8 T=1024 N=12 D=64 causal": (8, 1024, 12, 64, True),
    "ragged B=2 T=200 N=12 D=64 causal": (2, 200, 12, 64, True),
    "full B=2 T=256 N=12 D=64": (2, 256, 12, 64, False),
    "D=128 B=1 T=2048 N=32 causal": (1, 2048, 32, 128, True),
    "D=128 B=1 T=130 N=2 full": (1, 130, 2, 128, False),
    "D=80 B=2 T=1024 N=4 causal": (2, 1024, 4, 80, True),
    "D=80 B=1 T=130 N=2 full": (1, 130, 2, 80, False),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(DKV_TC_CASES))
def test_flash_dkv_tensor_cores_match_plain_on_card(cuda_device, case, dtype):
    """K3's tensor-core variant against the plain version in fp32 on the
    same (cast) inputs and the kernel forward's LSE and delta: dK and dV
    each within 3e-2 of the reference's largest magnitude (P and dS are
    rounded to the input type before their products, as the TPU kernel
    does); one launch, counted as the tensor-core variant."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    B, T, N, D, causal = DKV_TC_CASES[case]
    rs = np.random.RandomState(9)
    q, k, v, do = (torch.from_numpy(rs.randn(B, T, N, D).astype(np.float32)).to(cuda_device).to(dtype)
                   for _ in range(4))
    o, lse = fa.flash_fwd_kernel(q, k, v, causal)
    delta = fa.flash_delta(o, do)
    before = (fa.launches_dkv, fa.launches_dkv_tc)
    dk, dv = fa.flash_dkv_kernel(q, k, v, do, lse, delta, causal)
    assert (fa.launches_dkv - before[0], fa.launches_dkv_tc - before[1]) == (1, 1)
    dk_ref, dv_ref = fa.flash_dkv_plain(q.float(), k.float(), v.float(), do.float(), lse, delta, causal)
    torch.cuda.synchronize()
    for got, ref in ((dk, dk_ref), (dv, dv_ref)):
        assert torch.isfinite(got.float()).all()
        rel = ((got.float() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 3e-2, (case, dtype, rel)


def test_flash_attention_autograd_takes_dkv_tensor_cores(cuda_device):
    """The autograd backward of a bf16 ``flash_attention`` launches K3's
    tensor-core variant; fp32 takes the FMA variant."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    for dtype, tc in ((torch.bfloat16, 1), (torch.float32, 0)):
        q, k, v = (torch.randn(2, 192, 2, 64, device=cuda_device, dtype=dtype, requires_grad=True)
                   for _ in range(3))
        before = (fa.launches_dkv, fa.launches_dkv_tc)
        fa.flash_attention(q, k, v).float().square().sum().backward()
        torch.cuda.synchronize()
        assert (fa.launches_dkv - before[0], fa.launches_dkv_tc - before[1]) == (1, tc)
        assert all(torch.isfinite(t.grad.float()).all() for t in (k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(DKV_TC_CASES))
def test_flash_dq_tensor_cores_match_plain_on_card(cuda_device, case, dtype):
    """K2's tensor-core variant against the plain version in fp32 on the
    same (cast) inputs and the kernel forward's LSE and delta: dQ within
    3e-2 of the reference's largest magnitude (dS is rounded to the input
    type before dS K, as the TPU kernel does); one launch, counted as the
    tensor-core variant."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    B, T, N, D, causal = DKV_TC_CASES[case]
    rs = np.random.RandomState(10)
    q, k, v, do = (torch.from_numpy(rs.randn(B, T, N, D).astype(np.float32)).to(cuda_device).to(dtype)
                   for _ in range(4))
    o, lse = fa.flash_fwd_kernel(q, k, v, causal)
    delta = fa.flash_delta(o, do)
    before = (fa.launches_dq, fa.launches_dq_tc)
    dq = fa.flash_dq_kernel(q, k, v, do, lse, delta, causal)
    assert (fa.launches_dq - before[0], fa.launches_dq_tc - before[1]) == (1, 1)
    ref = fa.flash_dq_plain(q.float(), k.float(), v.float(), do.float(), lse, delta, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(dq.float()).all()
    rel = ((dq.float() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 3e-2, (case, dtype, rel)


@pytest.mark.parametrize("D", [64, 80, 128])
def test_flash_dq_fp32_on_fma_and_bitwise_repeat_on_card(cuda_device, D):
    """fp32 K2 stays on the FMA kernel (the tensor-core count does not
    move); two bf16 calls on the same inputs give a bitwise-equal dQ (each
    block owns its rows: no atomics)."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    q, k, v, do = (torch.randn(2, 300, 3, D, device=cuda_device) for _ in range(4))
    o, lse = fa.flash_fwd_kernel(q, k, v, True)
    before = (fa.launches_dq, fa.launches_dq_tc)
    fa.flash_dq_kernel(q, k, v, do, lse, fa.flash_delta(o, do), True)
    assert (fa.launches_dq - before[0], fa.launches_dq_tc - before[1]) == (1, 0)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    o, lse = fa.flash_fwd_kernel(q, k, v, True)
    delta = fa.flash_delta(o, do)
    first, second = (fa.flash_dq_kernel(q, k, v, do, lse, delta, True) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


DECODE_CASES = {  # (B, NH, NKV, D, S, lens): kv_len 0, on a 64-key split boundary and one past it, S, past S
    "GQA D=64": (3, 8, 2, 64, 512, [0, 200, 512]),
    "MHA D=128": (2, 4, 4, 128, 256, [77, 256]),
    "Hg=7 D=128": (4, 28, 4, 128, 256, [1, 64, 65, 256]),
    "S=100 kv_len>S": (4, 8, 2, 64, 100, [0, 64, 65, 150]),
}


def _decode_case(case, dtype, dev):
    B, NH, NKV, D, S, lens = DECODE_CASES[case]
    rs = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev).to(dtype)
               for shape in ((B, NH, D), (B, S, NKV, D), (B, S, NKV, D)))
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_kernel_matches_plain_on_card(cuda_device, case, dtype, monkeypatch):
    """K6 (split kernel and combine) against its plain version in fp32 on
    the same (cast) inputs, TF32 off: fp32 within 1e-4, bf16/fp16 within
    2e-2 (output rounding); rows of length 0 exact zeros; every call on the
    split path."""
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v, lens_d = _decode_case(case, dtype, cuda_device)
    before = (da.launches_decode, da.launches_decode_split)
    out = da.decode_attention(q, k, v, lens_d)
    ref = da.decode_attention_plain(q.float(), k.float(), v.float(), lens_d)
    torch.cuda.synchronize()
    assert (da.launches_decode - before[0], da.launches_decode_split - before[1]) == (1, 1)
    assert da.dense_splits(k.shape[1]) == -(-k.shape[1] // 64)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref).abs().max().item() <= (1e-4 if dtype == torch.float32 else 2e-2)
    assert (out[lens_d == 0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_kernel_bitwise_deterministic_on_card(cuda_device, case, dtype):
    """Two K6 calls on the same inputs are bitwise equal: the combine merges
    the partials in split order, without atomics."""
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da

    q, k, v, lens_d = _decode_case(case, dtype, cuda_device)
    first, second = (da.decode_attention(q, k, v, lens_d) for _ in range(2))
    torch.cuda.synchronize()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(first.view(bits), second.view(bits))


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
    before = (da.launches_paged, da.launches_paged_split)
    out = torch_pa.paged_decode_attention(q, kp, vp, pt_d, lens_d, impl="kernel")
    ref = torch_pa.paged_decode_attention(q.float(), kp.float(), vp.float(), pt_d, lens_d, impl="plain")
    torch.cuda.synchronize()
    assert (da.launches_paged, da.launches_paged_split) == (before[0] + 1, before[1] + 1)
    assert (out.float() - ref).abs().max().item() <= (1e-4 if dtype == torch.float32 else 2e-2)
    assert (out[lens_d == 0] == 0).all()


PAGED_SPLIT_SHAPES = {  # (NH, NKV, D, P, maxp): llama-1B's serving heads, and D=128 with a group of 7
    "Hg=8 D=64 P=16": (32, 4, 64, 16, 128),
    "Hg=7 D=128 P=64": (28, 4, 128, 64, 8),
}
# kv_len per row for each bucket: one key, on and one past split boundaries, the full table (MAXP·P = 2048
# or 512), a dead row
PAGED_SPLIT_LENS = {1: [1], 2: [64, 0], 4: [65, 128, 129, 1], 8: [0, 63, 64, 65, 300, 511, 512, 512]}


def _paged_case(rs, lens, NH, NKV, D, P, maxp, dev):
    """Pools whose every slot is large garbage except the live positions of
    each row's distinct pages; tables end in -1 sentinels."""
    lens = [min(n, maxp * P) for n in lens]
    NP = 1 + sum(-(-n // P) for n in lens)
    kp = np.full((NP, NKV, P, D), 3.0e4, np.float32)
    vp = -kp
    pt = np.full((len(lens), maxp), -1, np.int32)
    free = rs.permutation(np.arange(1, NP))
    used = 0
    for r, n in enumerate(lens):
        pages = -(-n // P)
        pt[r, :pages] = free[used: used + pages]
        used += pages
        for i in range(pages):
            live = min(P, n - i * P)
            kp[pt[r, i], :, :live] = rs.randn(NKV, live, D)
            vp[pt[r, i], :, :live] = rs.randn(NKV, live, D)
    q = rs.randn(len(lens), NH, D).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(q), t(kp), t(vp), t(pt), torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bucket", sorted(PAGED_SPLIT_LENS))
@pytest.mark.parametrize("shape", sorted(PAGED_SPLIT_SHAPES))
def test_paged_decode_split_matches_plain_on_card(cuda_device, shape, bucket, dtype, monkeypatch):
    """K5's split kernel and combine at buckets 1/2/4/8, kv_len on and one
    past split boundaries, against the plain version in fp32 on the same
    (cast) inputs, TF32 off: fp32 within 1e-4, bf16/fp16 within 2e-2; dead
    rows exact zeros; every call on the split path."""
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    NH, NKV, D, P, maxp = PAGED_SPLIT_SHAPES[shape]
    q, kp, vp, pt, lens = _paged_case(np.random.RandomState(bucket), PAGED_SPLIT_LENS[bucket], NH, NKV, D, P, maxp,
                                      cuda_device)
    args = (q.to(dtype), kp.to(dtype), vp.to(dtype))
    before = (da.launches_paged, da.launches_paged_split)
    out = torch_pa.paged_decode_attention(*args, pt, lens, impl="kernel")
    ref = torch_pa.paged_decode_attention(*(a.float() for a in args), pt, lens, impl="plain")
    torch.cuda.synchronize()
    assert (da.launches_paged - before[0], da.launches_paged_split - before[1]) == (1, 1)
    assert da.paged_splits(maxp, P) == -(-maxp * P // 64)
    live = lens > 0
    assert torch.isfinite(out.float()).all() and (out[~live] == 0).all()
    if live.any():
        assert (out.float() - ref)[live].abs().max().item() <= (1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_split_bitwise_deterministic_on_card(cuda_device, dtype):
    """Two K5 calls on the same inputs are bitwise equal: the combine merges
    the partials in split order, without atomics."""
    NH, NKV, D, P, maxp = PAGED_SPLIT_SHAPES["Hg=8 D=64 P=16"]
    q, kp, vp, pt, lens = _paged_case(np.random.RandomState(2), PAGED_SPLIT_LENS[8], NH, NKV, D, P, maxp,
                                      cuda_device)
    args = (q.to(dtype), kp.to(dtype), vp.to(dtype), pt, lens)
    first = torch_pa.paged_decode_attention(*args, impl="kernel")
    second = torch_pa.paged_decode_attention(*args, impl="kernel")
    torch.cuda.synchronize()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(first.view(bits), second.view(bits))


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


SPARSE_CASES = {  # (BN, T, D, block, layout config, causal)
    "Fixed blk=16 D=64": (4, 256, 64, 16, ("fixed", {}), False),
    "Fixed uni blk=16 D=64 causal": (3, 256, 64, 16, ("fixed", {"attention": "unidirectional"}), True),
    "Longformer blk=64 D=128 causal": (2, 512, 128, 64, ("longformer", {}), True),
    "BigBird blk=24 D=64 causal": (2, 192, 64, 24, ("bigbird", {}), True),
    "BigBird blk=128 D=64": (2, 512, 64, 128, ("bigbird", {}), False),
    "BigBird blk=8 D=64 causal": (2, 256, 64, 8, ("bigbird", {}), True),
    # the global column lists all 64 q blocks, past K9's cap: its chunks are summed by the reduction
    "Longformer blk=16 T=1024 D=128 causal split": (2, 1024, 128, 16, ("longformer", {}), True),
    "Fixed blk=64 T=2048 D=64 split": (2, 2048, 64, 64, ("fixed", {}), False),
}


def _sparse_layout(kind, kw, T, block):
    from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc

    cls = {"fixed": sc.FixedSparsityConfig, "longformer": sc.BSLongformerSparsityConfig,
           "bigbird": sc.BigBirdSparsityConfig}[kind]
    return cls(num_heads=1, block=block, **kw).make_layout(T)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_block_sparse_kernels_match_plain_on_card(cuda_device, case, dtype, monkeypatch):
    """K7, K8 and K9 against their plain versions in fp32 on the same (cast)
    inputs, TF32 off, the backward pair on the kernel forward's LSE and
    delta. fp32: O and LSE within 1e-4, each gradient within 1e-3 of the
    reference's largest magnitude; bf16/fp16: O within 2e-2 and each
    gradient within 3e-2 of that magnitude (only the outputs are rounded to
    the input type: the kernels compute in fp32, as the TPU kernels do)."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    BN, T, D, block, (kind, kw), causal = SPARSE_CASES[case]
    layout_h = _sparse_layout(kind, kw, T, block)
    row_idx, row_cnt, col_idx, col_cnt = bs.block_tables(layout_h, cuda_device)
    units = bs.dkv_units(layout_h, block, cuda_device)
    f_units = bs.fwd_units(layout_h, block, cuda_device)
    assert units.n_slots > 0 or "split" not in case
    rs = np.random.RandomState(8)
    q, k, v, do = (torch.from_numpy(rs.randn(BN, T, D).astype(np.float32)).to(cuda_device).to(dtype)
                   for _ in range(4))
    scale = 1.0 / np.sqrt(D)
    args = (scale, block, causal)
    before = (bs.launches_fwd, bs.launches_dq, bs.launches_dkv)
    before_tc = (bs.launches_fwd_tc, bs.launches_dq_tc, bs.launches_dkv_tc)
    o, lse = bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, f_units, *args)
    delta = bs.sparse_delta(o, do)
    dq = bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, f_units, *args)
    dk, dv = bs.sparse_dkv_kernel(q, k, v, do, lse, delta, col_idx, col_cnt, units, *args)
    # bf16 and fp16 take K7's, K8's and K9's tensor-core variants, fp32 the FMA variants
    tc = int(dtype != torch.float32)
    assert (bs.launches_fwd_tc - before_tc[0], bs.launches_dq_tc - before_tc[1],
            bs.launches_dkv_tc - before_tc[2]) == (tc, tc, tc)
    f = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = bs.sparse_fwd_plain(*f[:3], row_idx, row_cnt, *args)
    dq_ref = bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args)
    dk_ref, dv_ref = bs.sparse_dkv_plain(*f, lse, delta, col_idx, col_cnt, *args)
    torch.cuda.synchronize()
    assert (bs.launches_fwd, bs.launches_dq, bs.launches_dkv) == tuple(n + 1 for n in before)
    exact = dtype == torch.float32
    assert (o.float() - o_ref).abs().max().item() <= (1e-4 if exact else 2e-2)
    assert (lse - lse_ref).abs().max().item() <= (1e-4 if exact else 2e-2)
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert torch.isfinite(got.float()).all()
        rel = ((got.float() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= (1e-3 if exact else 3e-2), (case, dtype, rel)


def _dead_rows_blocks(n):
    """A local window of three blocks, a global q block 1 (it lists every
    key block: split past the cap), and q block 2 listing only the future
    block n - 1: under the causal mask its rows have no live score."""
    layout = np.zeros((n, n), bool)
    for i in range(n):
        layout[i, max(0, i - 2): i + 1] = True
    layout[1] = True
    layout[2] = False
    layout[2, n - 1] = True
    return layout


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [8, 16, 24, 64, 128])
def test_block_sparse_fwd_tensor_cores_match_plain_on_card(cuda_device, block, causal, dtype):
    """K7's tensor-core variant (a split global row, dead rows under the
    causal mask) against the plain version in fp32 on the same (cast)
    inputs: O and LSE within 2e-2 on live rows; dead rows exact zeros in O
    with LSE = NEG_INF; the variant counter moves once a call."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    n = 12
    layout_h = _dead_rows_blocks(n)
    T, D = n * block, 64 if block != 24 else 128
    row_idx, row_cnt, _, _ = bs.block_tables(layout_h, cuda_device)
    units = bs.fwd_units(layout_h, block, cuda_device)
    assert units.n_slots > 0
    rs = np.random.RandomState(block)
    q, k, v = (torch.from_numpy(rs.randn(3, T, D).astype(np.float32)).to(cuda_device).to(dtype) for _ in range(3))
    args = (1.0 / np.sqrt(D), block, causal)
    before = (bs.launches_fwd, bs.launches_fwd_tc)
    o, lse = bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, units, *args)
    o_ref, lse_ref = bs.sparse_fwd_plain(q.float(), k.float(), v.float(), row_idx, row_cnt, *args)
    torch.cuda.synchronize()
    assert (bs.launches_fwd - before[0], bs.launches_fwd_tc - before[1]) == (1, 1)
    dead = lse_ref <= bs.NEG_INF / 2
    assert bool(dead.any()) == causal
    assert (o[dead] == 0).all() and (lse[dead] == bs.NEG_INF).all()
    assert torch.isfinite(o.float()).all()
    assert (o.float() - o_ref).abs().max().item() <= 2e-2
    assert (lse - lse_ref)[~dead].abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_block_sparse_fwd_per_head_bigbird_on_card(cuda_device, dtype):
    """A per-head BigBird layout through the fused path: one K7 call a head,
    each on the tensor cores with its own unit table, against the plain
    version (2e-2)."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import BigBirdSparsityConfig

    layout = BigBirdSparsityConfig(num_heads=4, block=32, different_layout_per_head=True,
                                   num_random_blocks=1).make_layout(1024)
    rs = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rs.randn(2, 4, 1024, 128).astype(np.float32)).to(cuda_device).to(dtype)
               for _ in range(3))
    before = (bs.launches_fwd, bs.launches_fwd_tc)
    with torch.no_grad():
        o = bs.fused_block_sparse_attention(q, k, v, layout, 32)
        ref = bs.fused_block_sparse_attention(q.float(), k.float(), v.float(), layout, 32, impl="plain")
    torch.cuda.synchronize()
    assert (bs.launches_fwd - before[0], bs.launches_fwd_tc - before[1]) == (4, 4)
    assert (o.float() - ref).abs().max().item() <= 2e-2


def test_block_sparse_fwd_fp32_stays_on_fma_on_card(cuda_device):
    """fp32 K7 runs the FMA kernel (the parity path): the call counts, the
    tensor-core count does not move, and it matches plain within 1e-4."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    layout_h = _dead_rows_blocks(8)
    row_idx, row_cnt, _, _ = bs.block_tables(layout_h, cuda_device)
    q, k, v = (torch.randn(2, 128, 64, device=cuda_device) for _ in range(3))
    before = (bs.launches_fwd, bs.launches_fwd_tc)
    o, lse = bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, bs.fwd_units(layout_h, 16, cuda_device), 0.125, 16, True)
    o_ref, _ = bs.sparse_fwd_plain(q, k, v, row_idx, row_cnt, 0.125, 16, True)
    torch.cuda.synchronize()
    assert (bs.launches_fwd - before[0], bs.launches_fwd_tc - before[1]) == (1, 0)
    assert (o - o_ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("block", [16, 64])
def test_block_sparse_fwd_bitwise_deterministic_on_card(cuda_device, block):
    """Two K7 calls on a layout with a split global row are bitwise equal:
    the chunks' partials are merged in chunk order, with no atomics."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    layout_h = _dead_rows_blocks(16)
    row_idx, row_cnt, _, _ = bs.block_tables(layout_h, cuda_device)
    units = bs.fwd_units(layout_h, block, cuda_device)
    assert units.n_slots > 0
    q, k, v = (torch.randn(4, 16 * block, 64, device=cuda_device, dtype=torch.bfloat16) for _ in range(3))
    runs = [bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, units, 0.125, block, False) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0].view(torch.int16), runs[1][0].view(torch.int16))
    assert torch.equal(runs[0][1].view(torch.int32), runs[1][1].view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [8, 16, 24, 64, 128])
def test_block_sparse_dq_tensor_cores_match_plain_on_card(cuda_device, block, causal, dtype):
    """K8's tensor-core variant over K7's unit table (a split global row,
    dead rows under the causal mask) against the plain version in fp32 on
    the same (cast) inputs and the kernel forward's LSE and delta: dQ within
    3e-2 of the reference's largest magnitude; dead rows exact zeros; the
    variant counter moves once a call."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    n = 12
    layout_h = _dead_rows_blocks(n)
    T, D = n * block, 64 if block != 24 else 128
    row_idx, row_cnt, _, _ = bs.block_tables(layout_h, cuda_device)
    units = bs.fwd_units(layout_h, block, cuda_device)
    assert units.n_slots > 0
    rs = np.random.RandomState(block + 1)
    q, k, v, do = (torch.from_numpy(rs.randn(3, T, D).astype(np.float32)).to(cuda_device).to(dtype)
                   for _ in range(4))
    args = (1.0 / np.sqrt(D), block, causal)
    o, lse = bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, units, *args)
    delta = bs.sparse_delta(o, do)
    before = (bs.launches_dq, bs.launches_dq_tc)
    dq = bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, units, *args)
    ref = bs.sparse_dq_plain(q.float(), k.float(), v.float(), do.float(), lse, delta, row_idx, row_cnt, *args)
    torch.cuda.synchronize()
    assert (bs.launches_dq - before[0], bs.launches_dq_tc - before[1]) == (1, 1)
    dead = lse <= bs.NEG_INF / 2
    assert bool(dead.any()) == causal
    assert (dq[dead] == 0).all() and torch.isfinite(dq.float()).all()
    rel = ((dq.float() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 3e-2, (block, causal, dtype, rel)


def _ds_cancel_case(rs, BN, T, D, dtype, dev, eta=0.03):
    """q, v, dO random and each head's keys within ``eta`` of one shared
    vector c: Σ_k dS_k = 0 (delta = Σ_k P_k·dP_k), so c's part of dQ = Σ_k
    dS_k·k_k cancels and dQ is small beside its terms. Rounding dS to the
    operand dtype then moves dQ by some 30 times the output rounding."""
    q, v, do = (torch.from_numpy(rs.randn(BN, T, D).astype(np.float32)).to(dev).to(dtype) for _ in range(3))
    c = rs.randn(BN, 1, D).astype(np.float32)
    k = torch.from_numpy(c + eta * rs.randn(BN, T, D).astype(np.float32)).to(dev).to(dtype)
    return q, k, v, do


# dQ's error bound on ``_ds_cancel_case``, relative to its largest magnitude: above the output rounding
# with dS in fp32 (at most 3.3e-3 in bf16 and 9.6e-4 in fp16 with dS as hi + lo, emulated in plain torch)
# and below the error of dS rounded to the operand dtype (at least 8.5e-2 and 1.1e-2)
DS_FP32_TOL = {torch.bfloat16: 1.5e-2, torch.float16: 3e-3}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("block", [16, 64])
def test_block_sparse_dq_keeps_ds_in_fp32_on_card(cuda_device, block, dtype):
    """K8 multiplies dS·K with dS in fp32 (hi + lo in the operand dtype), as
    Pallas keeps it, and does not round dS to k's dtype as K2 does: on keys
    where that rounding shows, dQ is within ``DS_FP32_TOL`` of the plain
    version with fp32 dS, and the plain version with dS rounded is not."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    n = 16 if block == 16 else 8
    layout_h = np.ones((n, n), np.int64)
    row_idx, row_cnt, _, _ = bs.block_tables(layout_h, cuda_device)
    units = bs.fwd_units(layout_h, block, cuda_device)
    q, k, v, do = _ds_cancel_case(np.random.RandomState(block), 3, n * block, 64, dtype, cuda_device)
    args = (0.125, block, False)
    f = [t.float() for t in (q, k, v, do)]
    o, lse = bs.sparse_fwd_plain(*f[:3], row_idx, row_cnt, *args)  # fp32 O, so delta = Σ P·dP to fp32
    delta = bs.sparse_delta(o, f[3])
    before = bs.launches_dq_tc
    dq = bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, units, *args)
    ref = bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args)
    foil = bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args, ds_dtype=dtype)
    torch.cuda.synchronize()
    assert bs.launches_dq_tc - before == 1
    scale = ref.abs().max()
    err, foil_err = ((x.float() - ref).abs().max().item() / scale.item() for x in (dq, foil))
    assert foil_err > DS_FP32_TOL[dtype], (block, dtype, foil_err)
    assert err <= DS_FP32_TOL[dtype], (block, dtype, err, foil_err)


def test_block_sparse_dq_fp32_stays_on_fma_on_card(cuda_device):
    """fp32 K8 runs the FMA kernel (the parity path): the call counts, the
    tensor-core count does not move, and it matches plain within 1e-3 of the
    reference's largest magnitude."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    layout_h = _dead_rows_blocks(8)
    row_idx, row_cnt, _, _ = bs.block_tables(layout_h, cuda_device)
    units = bs.fwd_units(layout_h, 16, cuda_device)
    q, k, v, do = (torch.randn(2, 128, 64, device=cuda_device) for _ in range(4))
    o, lse = bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, units, 0.125, 16, True)
    delta = bs.sparse_delta(o, do)
    before = (bs.launches_dq, bs.launches_dq_tc)
    dq = bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, units, 0.125, 16, True)
    ref = bs.sparse_dq_plain(q, k, v, do, lse, delta, row_idx, row_cnt, 0.125, 16, True)
    torch.cuda.synchronize()
    assert (bs.launches_dq - before[0], bs.launches_dq_tc - before[1]) == (1, 0)
    assert ((dq - ref).abs().max() / ref.abs().max()).item() <= 1e-3


@pytest.mark.parametrize("block", [16, 64])
def test_block_sparse_dq_bitwise_deterministic_on_card(cuda_device, block):
    """Two K8 calls on a layout with a split global row are bitwise equal:
    the chunks' dQ partials are summed in chunk order, with no atomics."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    layout_h = _dead_rows_blocks(16)
    row_idx, row_cnt, _, _ = bs.block_tables(layout_h, cuda_device)
    units = bs.fwd_units(layout_h, block, cuda_device)
    assert units.n_slots > 0
    q, k, v, do = (torch.randn(4, 16 * block, 64, device=cuda_device, dtype=torch.bfloat16) for _ in range(4))
    o, lse = bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, units, 0.125, block, False)
    delta = bs.sparse_delta(o, do)
    runs = [bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, units, 0.125, block, False)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0].view(torch.int16), runs[1].view(torch.int16))


def test_block_sparse_dead_rows_exact_zeros_on_card(cuda_device):
    """The layout of tests/unit/ops/test_pallas_block_sparse.py: q block 0
    lists only a future kv block under the causal mask, so its rows have no
    live score: O and dQ are exact zeros there, LSE is NEG_INF."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    layout = np.zeros((1, 4, 4), bool)
    layout[0, 0, 3] = layout[0, 1, 1] = layout[0, 2, 2] = layout[0, 2, 0] = layout[0, 3, 3] = True
    q, k, v = (torch.randn(2, 2, 64, 64, device=cuda_device, requires_grad=True) for _ in range(3))
    o = bs.fused_block_sparse_attention(q, k, v, layout, 16, causal=True)
    (o * o.cos()).sum().backward()
    torch.cuda.synchronize()
    assert (o[:, :, :16] == 0).all() and (q.grad[:, :, :16] == 0).all()
    assert torch.isfinite(o).all() and all(torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_block_sparse_dkv_dead_keys_exact_zeros_on_card(cuda_device, dtype):
    """K9's tensor-core variant writes exact zeros for a key block whose
    only listed q block lies wholly before it under the causal mask, and
    K7/K8 exact zeros for that q block's rows (no live score)."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    layout = np.zeros((1, 4, 4), bool)  # key block 3 is listed only by q block 0
    layout[0, 0, 3] = layout[0, 1, 1] = layout[0, 2, 0] = layout[0, 2, 2] = layout[0, 3, 1] = layout[0, 3, 2] = True
    q, k, v = (torch.randn(2, 2, 64, 64, device=cuda_device, dtype=dtype, requires_grad=True) for _ in range(3))
    before = bs.launches_dkv_tc
    o = bs.fused_block_sparse_attention(q, k, v, layout, 16, causal=True)
    (o.float() * o.float().cos()).sum().backward()
    torch.cuda.synchronize()
    assert bs.launches_dkv_tc == before + 1
    assert (o[:, :, :16] == 0).all() and (q.grad[:, :, :16] == 0).all()
    assert (k.grad[:, :, 48:] == 0).all() and (v.grad[:, :, 48:] == 0).all()
    assert (k.grad[:, :, :48] != 0).any() and (v.grad[:, :, :48] != 0).any()
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))


@pytest.mark.parametrize("case", ["Longformer blk=16 T=1024 D=128 causal split", "Fixed blk=64 T=2048 D=64 split",
                                  "BigBird blk=24 D=64 causal"])
def test_block_sparse_dkv_bitwise_deterministic_on_card(cuda_device, case):
    """Two K9 calls on the same inputs give bitwise-equal dK and dV: the
    split columns' partials are summed in chunk order, with no atomics."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    BN, T, D, block, (kind, kw), causal = SPARSE_CASES[case]
    layout_h = _sparse_layout(kind, kw, T, block)
    row_idx, row_cnt, col_idx, col_cnt = bs.block_tables(layout_h, cuda_device)
    units = bs.dkv_units(layout_h, block, cuda_device)
    assert units.n_slots > 0 or "split" not in case
    rs = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rs.randn(BN, T, D).astype(np.float32)).to(cuda_device).to(torch.bfloat16)
                   for _ in range(4))
    args = (1.0 / np.sqrt(D), block, causal)
    o, lse = bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, bs.fwd_units(layout_h, block, cuda_device), *args)
    delta = bs.sparse_delta(o, do)
    first = bs.sparse_dkv_kernel(q, k, v, do, lse, delta, col_idx, col_cnt, units, *args)
    second = bs.sparse_dkv_kernel(q, k, v, do, lse, delta, col_idx, col_cnt, units, *args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_block_sparse_per_head_layout_on_card(cuda_device):
    """A per-head BigBird layout (one K7-K9 call per head, each with its own
    K9 units) through the fused autograd path in bf16 against the plain
    versions on the same inputs: output within 2e-2, each gradient within
    3e-2 of the reference's largest magnitude."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import BigBirdSparsityConfig

    layout = BigBirdSparsityConfig(num_heads=3, block=32, different_layout_per_head=True).make_layout(512)
    rs = np.random.RandomState(6)
    base = [torch.from_numpy(rs.randn(2, 3, 512, 128).astype(np.float32)).to(cuda_device).to(torch.bfloat16)
            for _ in range(4)]
    grads = {}
    for impl in ("kernel", "plain"):
        q, k, v = (t.clone().requires_grad_(True) for t in base[:3])
        before = (bs.launches_fwd, bs.launches_dkv_tc)
        o = bs.fused_block_sparse_attention(q, k, v, layout, 32, causal=True, impl=impl)
        o.backward(base[3])
        torch.cuda.synchronize()
        moved = (bs.launches_fwd - before[0], bs.launches_dkv_tc - before[1])
        assert moved == ((3, 3) if impl == "kernel" else (0, 0))
        grads[impl] = [o.detach()] + [t.grad for t in (q, k, v)]
    assert (grads["kernel"][0].float() - grads["plain"][0].float()).abs().max().item() <= 2e-2
    for got, ref in zip(grads["kernel"][1:], grads["plain"][1:]):
        rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        assert rel <= 3e-2, rel


def test_block_sparse_autograd_launches_kernels(cuda_device):
    """A CUDA tensor through ``fused_block_sparse_attention`` launches K7
    forward and K8, K9 backward once for a shared layout, once per head for
    per-head layouts."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import BigBirdSparsityConfig

    q, k, v = (torch.randn(1, 3, 128, 64, device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    layout = BigBirdSparsityConfig(num_heads=3, block=16, different_layout_per_head=True).make_layout(128)
    for lay, n in ((layout[:1], 1), (layout, 3)):
        before = (bs.launches_fwd, bs.launches_dq, bs.launches_dkv)
        bs.fused_block_sparse_attention(q, k, v, lay, 16).float().square().sum().backward()
        torch.cuda.synchronize()
        assert (bs.launches_fwd, bs.launches_dq, bs.launches_dkv) == tuple(c + n for c in before)
        assert all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in (q, k, v))


@pytest.mark.parametrize("D,block", [(32, 16), (80, 16), (64, 136)])
def test_block_sparse_unsupported_sizes_raise_on_card(cuda_device, D, block):
    """Sizes the kernels do not take raise ``NotImplementedError`` on a CUDA
    tensor: no quiet fallback to the plain version."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    T = 2 * block
    q = torch.randn(1, 2, T, D, device=cuda_device)
    layout = np.ones((1, 2, 2), bool)
    before = bs.launches_fwd
    with pytest.raises(NotImplementedError, match="block-sparse kernels"):
        bs.fused_block_sparse_attention(q, q, q, layout, block)
    assert bs.launches_fwd == before


def test_block_sparse_entries_reject_cpu_tensors():
    """The bare block-sparse launches take CUDA tensors only: a CPU tensor
    raises before any library is built or any count moves."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    q = torch.zeros(2, 64, 64)
    lse = torch.zeros(2, 64)
    row_idx, row_cnt, col_idx, col_cnt = bs.block_tables(np.eye(4, dtype=bool), "cpu")
    units = bs.dkv_units(np.eye(4, dtype=bool), 16, "cpu")
    f_units = bs.fwd_units(np.eye(4, dtype=bool), 16, "cpu")
    counts = (bs.launches_fwd, bs.launches_dq, bs.launches_dkv)
    with pytest.raises(ValueError, match="CUDA"):
        bs.sparse_fwd_kernel(q, q, q, row_idx, row_cnt, f_units, 0.125, 16, False)
    with pytest.raises(ValueError, match="CUDA"):
        bs.sparse_dq_kernel(q, q, q, q, lse, lse, row_idx, row_cnt, f_units, 0.125, 16, False)
    with pytest.raises(ValueError, match="CUDA"):
        bs.sparse_dkv_kernel(q, q, q, q, lse, lse, col_idx, col_cnt, units, 0.125, 16, False)
    assert (bs.launches_fwd, bs.launches_dq, bs.launches_dkv) == counts


WINDOW_CFG = dict(vocab_size=128, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
                  norm="rmsnorm", position="rope", activation="swiglu", use_bias=False, tie_embeddings=False,
                  flash_attention=False, dtype="float32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_graph_streams_match_single_step_on_card(cuda_device, dtype, monkeypatch):
    """Multi-step windows replayed as one captured CUDA graph give the same
    greedy streams as the eager single-step ragged server, byte for byte;
    one graph is captured per server and every window is a replay; K4's
    counter moves by layers x ragged steps, plus layers x horizon twice per
    capture (the warm-up's launches and the capture's)."""
    from deepspeed_tpu_torch.inference.scheduler import PagedServer
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = TransformerConfig(**WINDOW_CFG)
    params = load_jax_params(TransformerLM(cfg), init_params(cfg, 3), device=cuda_device, dtype=dtype).param_tree()
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (5, 17, 30, 9)]
    budgets = [40, 33, 25, 37]
    H = 4
    streams, stats = {}, {}
    for ms in (None, {"enable": True, "horizon": H}):
        server = PagedServer(cfg, params, page_size=8, max_slots=4, prefill_chunk=8, dtype=dtype,
                             device=cuda_device, multi_step=ms)
        before = da.launches
        streams[ms is not None] = server.serve(prompts, max_new_tokens=budgets)
        torch.cuda.synchronize()
        stats[ms is not None] = (server.serve_stats(), da.launches - before)
    for a, b in zip(streams[True], streams[False]):
        np.testing.assert_array_equal(a, b)
    st, k4 = stats[True]
    assert st["window_steps"] >= 2 and st["window_captures"] == 1, st
    assert st["window_device_ms"]["count"] == st["window_steps"] and st["window_device_ms"]["p50"] > 0
    L = cfg.num_layers
    assert k4 == L * st["ragged_steps"] + 2 * L * H * st["window_captures"]
    assert stats[False][1] == L * stats[False][0]["ragged_steps"]


def test_window_replays_launch_k4_each_round_on_card(cuda_device):
    """Counted on the device by the profiler (the wrappers' counters do not
    see a replay): once the window graph exists, a serve runs K4's split and
    combine kernels once a layer per single step and once a layer and round
    per window replay."""
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.inference.scheduler import PagedServer
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params

    cfg = TransformerConfig(**WINDOW_CFG)
    params = load_jax_params(TransformerLM(cfg), init_params(cfg, 3), device=cuda_device,
                             dtype=torch.bfloat16).param_tree()
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (5, 17, 30, 9)]
    H = 4
    server = PagedServer(cfg, params, page_size=8, max_slots=4, prefill_chunk=8, dtype=torch.bfloat16,
                         device=cuda_device, multi_step={"enable": True, "horizon": H})
    first = server.serve(prompts, max_new_tokens=[40, 33, 25, 37])
    before = server.serve_stats()
    assert before["window_captures"] == 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = server.serve(prompts, max_new_tokens=[40, 33, 25, 37])
        torch.cuda.synchronize()
    after = server.serve_stats()
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    windows = after["window_steps"] - before["window_steps"]
    assert windows >= 2 and after["window_captures"] == 1
    want = cfg.num_layers * (after["ragged_steps"] - before["ragged_steps"] + H * windows)
    for name in ("ragged_split_kernel", "ragged_combine_kernel"):
        got = sum(e.count for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA") and name in e.key)
        assert got == want, (name, got, want)


# --- speculative decoding and crash recovery on the card ----------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_ragged_verify_shape_matches_plain_on_card(cuda_device, dtype, monkeypatch):
    """K4 at the speculative verify shape (8 rows in a width-5 window,
    q_lens 1, 2, 3, 4, 5, 5, 1, 0; llama-1B heads) against the plain version
    in fp32 on the same (cast) inputs, TF32 off: fp32 within 1e-4, bf16 and
    fp16 within 2e-2; the dead row and slots past q_len exact zeros; two
    calls bitwise equal."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rows = [(129, 1), (300, 2), (511, 3), (700, 4), (1024, 5), (1500, 5), (2048, 1), (0, 0)]
    q, kp, vp, pt, kv_lens, q_lens = _ragged_case(np.random.RandomState(14), rows, 5, 32, 4, 64, 16, 128,
                                                  cuda_device)
    args = (q.to(dtype), kp.to(dtype), vp.to(dtype))
    out = torch_pa.ragged_paged_attention(*args, pt, kv_lens, q_lens, impl="kernel")
    again = torch_pa.ragged_paged_attention(*args, pt, kv_lens, q_lens, impl="kernel")
    ref = torch_pa.ragged_paged_attention(*(a.float() for a in args), pt, kv_lens, q_lens, impl="plain")
    torch.cuda.synchronize()
    live = torch.arange(5, device=cuda_device)[None, :] < q_lens[:, None]
    err = (out.float() - ref).abs()[live].max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2), err
    assert (out[~live] == 0).all()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(out.view(bits), again.view(bits))


def _serving_model(dtype, device):
    from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = TransformerConfig(**WINDOW_CFG)
    return cfg, load_jax_params(TransformerLM(cfg), init_params(cfg, 3), device=device, dtype=dtype).param_tree()


class _Oracle:
    """Drafts each request's known future, but nothing in every third round
    of the server's (so the bucketed server also runs plain K5 rounds)."""

    def __init__(self, futures):
        self.futures, self.server = futures, None

    def propose(self, uid, context, k):
        st = self.server.stats
        if (st["spec_rounds"] + st["decode_steps"]) % 3 == 2:
            return np.zeros(0, np.int32)
        return self.futures[uid][context.size : context.size + k].astype(np.int32)

    def drop(self, uid):
        pass


@pytest.mark.parametrize("ragged", [True, False])
def test_spec_server_fp32_equals_spec_off_on_card(cuda_device, ragged, monkeypatch):
    """fp32 (TF32 off) speculation with an oracle of the speculation-off
    streams: ragged verify rows through K4 and the bucketed oracle's plain
    verify rounds give the speculation-off streams, every draft accepted;
    K4 = layers x ragged steps, K5 = layers x plain bucketed rounds."""
    from deepspeed_tpu_torch.inference.scheduler import PagedServer
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, params = _serving_model(torch.float32, cuda_device)
    rs = np.random.RandomState(10)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (5, 17, 30, 9)]
    budgets = [40, 33, 25, 37]
    kw = dict(page_size=8, max_slots=4, prefill_chunk=8, dtype=torch.float32, device=cuda_device)
    ref = PagedServer(cfg, params, **kw).serve(prompts, max_new_tokens=budgets)
    drafter = _Oracle(dict(enumerate(ref)))
    server = drafter.server = PagedServer(cfg, params, ragged=ragged, drafter=drafter, spec_decode={"max_draft": 4},
                                          **kw)
    before = (da.launches, da.launches_paged)
    outs = server.serve(prompts, max_new_tokens=budgets)
    torch.cuda.synchronize()
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, b)
    st = server.serve_stats()
    assert st["spec_rounds"] >= 2 and st["spec_accept_rate"] == 1.0 and st["decode_steps"] >= 1, st
    L = cfg.num_layers
    assert (da.launches - before[0], da.launches_paged - before[1]) == (
        (L * st["ragged_steps"], 0) if ragged else (0, L * st["decode_steps"]))
    assert server.pool.used_pages() == 0


@pytest.mark.parametrize("point,hit", [("serve.mid_step", 9), ("serve.mid_window", 2)])
def test_recover_on_card(cuda_device, tmp_path, point, hit, monkeypatch):
    """A journaled fp32 server (windows on: CUDA graph replays) killed at a
    chaos point and a fresh server recovering from the replayed journal:
    the streams equal the uncrashed run's, every page back."""
    from deepspeed_tpu_torch.inference.journal import RequestJournal
    from deepspeed_tpu_torch.inference.scheduler import PagedServer
    from deepspeed_tpu_torch.utils import chaos

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, params = _serving_model(torch.float32, cuda_device)
    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (5, 17, 30, 9)]
    budgets = [40, 33, 25, 37]
    kw = dict(page_size=8, max_slots=4, prefill_chunk=8, dtype=torch.float32, device=cuda_device,
              multi_step={"enable": True, "horizon": 4})
    ref = PagedServer(cfg, params, **kw).serve(prompts, max_new_tokens=budgets)
    server = PagedServer(cfg, params, journal=RequestJournal(str(tmp_path)), **kw)
    uids = [server.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    chaos.install(chaos.ChaosSchedule([chaos.ChaosRule(point, hit=hit)]))
    try:
        with pytest.raises(chaos.ChaosKilled):
            server.run()
    finally:
        chaos.uninstall()
    live = len(server._queue) + len(server._active)
    del server
    states, next_uid = RequestJournal.replay(str(tmp_path))
    fresh = PagedServer(cfg, params, journal=RequestJournal(str(tmp_path)), **kw)
    assert fresh.recover(states, next_uid) == live > 0
    fresh.run()
    for uid, want in zip(uids, ref):
        np.testing.assert_array_equal(fresh.take_result(uid), want)
    assert fresh.pool.used_pages() == 0


# --- the pool's defrag, int8 weights and the fleet on the card ----------------------------------
def _window_params(dtype, device, seed=3):
    from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = TransformerConfig(**WINDOW_CFG)
    return cfg, load_jax_params(TransformerLM(cfg), init_params(cfg, seed), device=device, dtype=dtype).param_tree()


def _stepped(server, prompts, budgets, defrag=False):
    uids = [server.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    moved = 0
    while server.has_work():
        server.step()
        if defrag:
            moved += server.pool.defrag()
            server.pool.integrity_check()
    return [server.take_result(u) for u in uids], moved


def test_window_graph_replays_after_defrag_on_card(cuda_device, monkeypatch):
    """A window server whose pool defrags after every step: the captured
    graph keeps replaying into the pools (defrag gathers in place, so their
    storage never moves) and the streams equal the single-step server's
    without defrag, fp32, TF32 off."""
    from deepspeed_tpu_torch.inference.scheduler import PagedServer

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, params = _window_params(torch.float32, cuda_device)
    rs = np.random.RandomState(10)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (5, 17, 30, 9, 12, 21)]
    budgets = [40, 12, 25, 37, 9, 30]
    kw = dict(page_size=8, max_slots=4, prefill_chunk=8, dtype=torch.float32, device=cuda_device, prefix_cache=True)
    ref, _ = _stepped(PagedServer(cfg, params, **kw), prompts, budgets)
    server = PagedServer(cfg, params, multi_step={"enable": True, "horizon": 4}, **kw)
    ptr = (server.pool.cache.k_pages.data_ptr(), server.pool.cache.v_pages.data_ptr())
    outs, moved = _stepped(server, prompts, budgets, defrag=True)
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, b)
    st = server.serve_stats()
    assert moved > 0 and st["window_steps"] >= 2 and st["window_captures"] == 1, (moved, st["window_steps"])
    assert (server.pool.cache.k_pages.data_ptr(), server.pool.cache.v_pages.data_ptr()) == ptr


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_qmatmul_matches_cpu_on_card(cuda_device, dtype, monkeypatch):
    """``quantize_weight_int8`` gives the same codes and scales on the card
    as on the CPU; ``qmatmul`` on the card matches its CPU result (fp32
    within 1e-5 with TF32 off, bf16 within 2e-2 of the output's largest
    magnitude)."""
    from deepspeed_tpu_torch.compression import int8

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rs = np.random.RandomState(12)
    w = torch.from_numpy((0.02 * rs.randn(3, 256, 192)).astype(np.float32)).to(dtype)
    h = torch.from_numpy(rs.randn(8, 256).astype(np.float32)).to(dtype)
    cpu = int8.quantize_weight_int8(w)
    card = int8.quantize_weight_int8(w.to(cuda_device))
    np.testing.assert_array_equal(card.q.cpu().numpy(), cpu.q.numpy())
    np.testing.assert_array_equal(card.scale.cpu().numpy(), cpu.scale.numpy())
    layer = int8.QuantizedTensor(card.q[1], card.scale[1])
    got = int8.qmatmul(h.to(cuda_device), layer).float().cpu()
    want = int8.qmatmul(h, int8.QuantizedTensor(cpu.q[1], cpu.scale[1])).float()
    tol = 1e-5 if dtype == torch.float32 else 2e-2 * want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=0)


def test_int8_window_server_matches_int8_single_step_on_card(cuda_device, monkeypatch):
    """An int8 serving tree in a window server (its codes and scales held by
    the captured graph) gives the int8 single-step server's streams, fp32,
    TF32 off; K4's counter follows the window accounting."""
    from deepspeed_tpu_torch.compression.int8 import QuantizedTensor, quantize_params_int8
    from deepspeed_tpu_torch.inference.scheduler import PagedServer
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, params = _window_params(torch.float32, cuda_device)
    qparams = quantize_params_int8(params)
    assert isinstance(qparams["layers"]["wq"], QuantizedTensor) and qparams["layers"]["wq"].q.is_cuda
    rs = np.random.RandomState(13)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (5, 17, 30, 9)]
    budgets = [40, 33, 25, 37]
    H = 4
    streams = {}
    for ms in (None, {"enable": True, "horizon": H}):
        server = PagedServer(cfg, qparams, page_size=8, max_slots=4, prefill_chunk=8, dtype=torch.float32,
                             device=cuda_device, multi_step=ms)
        before = da.launches
        streams[ms is not None] = server.serve(prompts, max_new_tokens=budgets)
        st = server.serve_stats()
        L = cfg.num_layers
        assert da.launches - before == L * st["ragged_steps"] + 2 * L * H * st["window_captures"]
    for a, b in zip(streams[True], streams[False]):
        np.testing.assert_array_equal(a, b)
    assert st["window_steps"] >= 2 and st["window_captures"] == 1


def test_fleet_streams_match_single_server_on_card(cuda_device, tmp_path, monkeypatch):
    """Two replicas on the card behind a ``FleetRouter``, fp32 with TF32
    off: a migration mid-stream and a replica killed at
    ``fleet.replica_kill`` re-routed from its journal leave every stream
    equal to one server's, and ``migrated_token_divergence`` 0."""
    from deepspeed_tpu_torch.inference.fleet import FleetRouter, ReplicaHandle
    from deepspeed_tpu_torch.inference.journal import RequestJournal
    from deepspeed_tpu_torch.inference.scheduler import PagedServer
    from deepspeed_tpu_torch.utils import chaos

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, params = _window_params(torch.float32, cuda_device)
    kw = dict(page_size=8, max_slots=4, prefill_chunk=8, dtype=torch.float32, device=cuda_device, prefix_cache=True)
    rs = np.random.RandomState(14)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (5, 17, 30, 9, 12, 21)]
    budgets = [20, 12, 25, 17, 9, 30]
    ref = PagedServer(cfg, params, **kw).serve(prompts, max_new_tokens=budgets)
    router = FleetRouter([ReplicaHandle(name=f"r{i}", journal_dir=str(tmp_path / f"r{i}"),
                                        server=PagedServer(cfg, params, journal=RequestJournal(str(tmp_path / f"r{i}")),
                                                           **kw)) for i in range(2)])
    uids = [router.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    mid = None
    while mid is None:
        router.step()
        mid = next((r.uid for h in router.replicas.values() for r in h.inner._active
                    if len(r.generated) >= 2 and not r.done), None)
    assert router.migrate(mid)
    chaos.install(chaos.ChaosSchedule([chaos.ChaosRule("fleet.replica_kill", hit=4)]))
    try:
        router.run()
    finally:
        chaos.uninstall()
    fs = router.fleet_stats()
    assert fs["replica_kills"] == 1 and fs["migrations"] == 1 and fs["migrated_token_divergence"] == 0
    for u, want in zip(uids, ref):
        np.testing.assert_array_equal(router.take_result(u), want)


# --- tensor parallelism (S9): the kernels at a rank's head counts, gloo ranks on the card ------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tp_local_head_kernels_on_card(cuda_device, dtype, monkeypatch):
    """K4, K6 and K1 at llama-1B's per-rank head counts under tp = 2 (16
    query heads over 2 kv heads, D 64) against their plain versions in
    fp32 on the same inputs: fp32 within 1e-4, bf16 within 2e-2."""
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    rs = np.random.RandomState(21)
    NH, NKV, D = 16, 2, 64
    q, kp, vp, pt, kl, ql = _ragged_case(rs, [(300, 1), (17, 1), (0, 0), (1024, 1)], 1, NH, NKV, D, 16, 64,
                                         cuda_device)
    args = (q.to(dtype), kp.to(dtype), vp.to(dtype))
    out = torch_pa.ragged_paged_attention(*args, pt, kl, ql, impl="kernel").float()
    ref = torch_pa.ragged_paged_attention(*(a.float() for a in args), pt, kl, ql, impl="plain")
    assert (out - ref)[ql > 0].abs().max().item() <= tol
    q6 = torch.from_numpy(rs.randn(4, NH, D).astype(np.float32)).to(cuda_device).to(dtype)
    k6, v6 = (torch.from_numpy(rs.randn(4, 256, NKV, D).astype(np.float32)).to(cuda_device).to(dtype)
              for _ in range(2))
    lens = torch.tensor([0, 1, 130, 256], dtype=torch.int32, device=cuda_device)
    got = da.decode_attention_kernel(q6, k6, v6, lens, 0.125).float()
    want = da.decode_attention_plain(q6.float(), k6.float(), v6.float(), lens, 0.125)
    assert (got - want).abs().max().item() <= tol
    q1, k1, v1 = (torch.from_numpy(rs.randn(2, 256, NH, D).astype(np.float32)).to(cuda_device).to(dtype)
                  for _ in range(3))
    o, lse = fa.flash_fwd_kernel(q1, k1, v1, True)
    o_ref, lse_ref = fa.flash_fwd_plain(q1.float(), k1.float(), v1.float(), True)
    assert (o.float() - o_ref).abs().max().item() <= tol and (lse - lse_ref).abs().max().item() <= tol


def _tp_card_rank(rank, world):
    """One gloo rank on ``cuda:0``: the collectives on CUDA tensors, the
    quantized exchange, and a tensor-parallel fp32 serve."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference.scheduler import PagedServer
    from deepspeed_tpu_torch.inference.tp import TPServing, quantized_all_reduce

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.arange(24, device=dev).reshape(4, 6) * (rank + 1)).to(dt)
        out[f"all_reduce {dt}"] = comm.all_reduce(x).float().cpu().numpy()
    a = (torch.arange(3 * world, device=dev) + 10 * rank).to(torch.int8)
    out["all_to_all_single int8"] = comm.all_to_all_single(torch.empty_like(a), a).cpu().numpy()
    mine = torch.full((2, 3), float(rank), device=dev)
    out["all_gather"] = torch.cat(comm.all_gather(None, mine)).cpu().numpy()
    out["all_gather_into_tensor"] = comm.all_gather_into_tensor(torch.empty(2 * world, 3, device=dev),
                                                                mine).cpu().numpy()
    out["broadcast"] = comm.broadcast(mine.clone(), src=0).cpu().numpy()
    partial = torch.from_numpy(np.random.RandomState(rank).randn(3, 8).astype(np.float32))
    out["qar_cuda"] = quantized_all_reduce(partial.to(dev)).cpu().numpy()
    out["qar_partial"] = partial.numpy()
    cfg, params = _window_params(torch.float32, dev)
    kw = dict(page_size=8, max_slots=4, prefill_chunk=8, dtype=torch.float32, device=dev)
    rs = np.random.RandomState(31)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (5, 17, 30, 9)]
    server = PagedServer(cfg, params, tp=TPServing(degree=world), **kw)
    out["tp_streams"] = [o.tolist() for o in server.serve(prompts, max_new_tokens=[20, 12, 25, 17])]
    out["fingerprint"] = server.serve_stats()["step_fingerprint"]
    if rank == 0:
        ref = PagedServer(cfg, params, **kw).serve(prompts, max_new_tokens=[20, 12, 25, 17])
        out["tp1_streams"] = [o.tolist() for o in ref]
    return out


@pytest.fixture(scope="module")
def tp_card_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: two gloo ranks share cuda:0")
    from torch_rank_group import join_ranks, start_ranks

    return join_ranks(start_ranks(_tp_card_rank, 2, str(tmp_path_factory.mktemp("tp_card"))))


def test_tp_gloo_collectives_on_card(tp_card_ranks):
    """Two gloo ranks on ``cuda:0``: all-reduce in fp32 and bf16, int8
    all-to-all, all-gather (list and into one tensor) and broadcast on CUDA
    tensors, every value as the collective defines it; the quantized
    all-reduce on CUDA equal to its arithmetic on the CPU."""
    from deepspeed_tpu_torch.inference.tp import quantized_all_reduce_local

    base = np.arange(24, dtype=np.float32).reshape(4, 6)
    for rank, res in enumerate(tp_card_ranks):
        for dt in (torch.float32, torch.bfloat16):
            np.testing.assert_array_equal(res[f"all_reduce {dt}"], base * 3)
        np.testing.assert_array_equal(res["all_to_all_single int8"], [3 * rank + i + 10 * src
                                                                      for src in range(2) for i in range(3)])
        want = np.repeat(np.arange(2, dtype=np.float32), 2)[:, None] * np.ones((1, 3), np.float32)
        np.testing.assert_array_equal(res["all_gather"], want)
        np.testing.assert_array_equal(res["all_gather_into_tensor"], want)
        np.testing.assert_array_equal(res["broadcast"], np.zeros((2, 3), np.float32))
    local = quantized_all_reduce_local([torch.from_numpy(r["qar_partial"]) for r in tp_card_ranks])[0].numpy()
    for res in tp_card_ranks:
        np.testing.assert_allclose(res["qar_cuda"], local, rtol=0, atol=1e-6)


def test_tp_serve_equals_single_rank_on_card(tp_card_ranks):
    """A tp = 2 fp32 serve on the card (K4 at each rank's heads, TF32 off)
    gives the single-rank server's streams on both ranks, with equal step
    fingerprints."""
    ref = tp_card_ranks[0]["tp1_streams"]
    for res in tp_card_ranks:
        assert res["tp_streams"] == ref
    assert tp_card_ranks[0]["fingerprint"] == tp_card_ranks[1]["fingerprint"]


# --- training checkpoints on the card ----------------------------------------------------------
def _card_train_engine(device, checkpoint=None):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.jax_params import unflatten_tree
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = TransformerConfig(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2, max_seq_len=64,
                            dtype="bfloat16", remat=False, attn_dropout=0.1)
    config = {"train_micro_batch_size_per_gpu": 4, "bf16": {"enabled": True}, "gradient_clipping": 1.0,
              "optimizer": {"type": "adam", "params": {"lr": 1e-3, "weight_decay": 0.01}}}
    if checkpoint:
        config["checkpoint"] = checkpoint
    engine, *_ = dst.initialize(model=TransformerLM(cfg), config=config,
                                model_parameters=unflatten_tree(init_params(cfg, 0)), device=device)
    return engine


def _card_steps(engine, n):
    for _ in range(n):
        toks = np.random.RandomState(engine.global_steps).randint(0, 256, (4, 65))
        loss = engine({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
        engine.backward(loss)
        engine.step()


def _flat_state(engine):
    from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree

    st = engine._opt_state
    return (flatten_tree(engine.get_master_params()), flatten_tree(engine.get_params()),
            {k: v.cpu().numpy() for k, v in st.exp_avg.items()}, {k: v.cpu().numpy() for k, v in st.exp_avg_sq.items()})


def test_card_checkpoint_loads_into_cpu_engine(cuda_device, tmp_path):
    """A bf16 checkpoint saved from the card loads into a CPU engine: the
    master, the bf16 module, both moments, the counters and the dropout
    generator are equal."""
    card = _card_train_engine(cuda_device)
    _card_steps(card, 2)
    card.save_checkpoint(str(tmp_path))
    cpu = _card_train_engine("cpu")
    path, _ = cpu.load_checkpoint(str(tmp_path), auto_resume=True)
    assert path.endswith("global_step2") and cpu.global_steps == 2 and cpu._opt_state.step == 2
    for want, got in zip(_flat_state(card), _flat_state(cpu)):
        assert set(want) == set(got) and all(np.array_equal(want[k], got[k]) for k in want)
    assert cpu._dropout_rng.bit_generator.state == card._dropout_rng.bit_generator.state


def test_async_snapshot_untouched_by_next_steps_on_card(cuda_device, tmp_path, monkeypatch):
    """An async save holds the state of its step: the writer is held until
    two more in-place steps have run on the card, and the committed
    checkpoint still equals the state at the save, bitwise."""
    import threading

    from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_checkpoint_engine import TorchCheckpointEngine

    engine = _card_train_engine(cuda_device, checkpoint={"async_snapshot": True})
    _card_steps(engine, 2)
    at_save = _flat_state(engine)
    gate = threading.Event()
    save = engine.checkpoint_engine.save

    def held_save(state, path):
        assert gate.wait(timeout=120)
        save(state, path)

    monkeypatch.setattr(engine.checkpoint_engine, "save", held_save)
    engine.save_checkpoint(str(tmp_path))
    assert engine.checkpoint_stats()["pending"] == 1
    _card_steps(engine, 2)
    torch.cuda.synchronize()
    gate.set()
    engine.wait_pending_checkpoint()
    state = TorchCheckpointEngine().load(str(tmp_path / "global_step2"))
    from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree

    saved = flatten_tree(state["master"])
    assert all(np.array_equal(at_save[0][k], saved[k].numpy()) for k in saved)
    assert not all(np.array_equal(at_save[0][k], v) for k, v in _flat_state(engine)[0].items())
    moments = flatten_tree(state["optimizer"]["exp_avg"])
    assert all(np.array_equal(at_save[2][k], moments[k].numpy()) for k in moments)


# --- offload (T2's second half) ------------------------------------------------------------
def _offload_card_engine(device, zero, dtype="bfloat16"):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.jax_params import unflatten_tree
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = TransformerConfig(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2, max_seq_len=64, dtype=dtype,
                            remat=False)
    config = {"train_micro_batch_size_per_gpu": 4, "gradient_clipping": 1.0, "zero_optimization": zero,
              "optimizer": {"type": "adam", "params": {"lr": 1e-3, "weight_decay": 0.01}}}
    if dtype == "bfloat16":
        config["bf16"] = {"enabled": True}
    return dst.initialize(model=TransformerLM(cfg), config=config, model_parameters=unflatten_tree(init_params(cfg, 0)),
                          device=device)[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_offload_bitwise_on_device_on_card(cuda_device, dtype, monkeypatch):
    """The streamed buckets (H2D on a side stream, the update on the
    compute stream, D2H into pinned host tensors, small buckets so several
    are in flight) give the on-device engine's losses, norms and master bit
    for bit over 4 steps."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree

    ref = _offload_card_engine(cuda_device, {"stage": 1}, dtype)
    off = _offload_card_engine(cuda_device, {"stage": 1, "offload_optimizer": {
        "device": "cpu", "pipeline_read": True, "pipeline_write": True, "pin_memory": True, "bucket_size": 40000}}, dtype)
    assert off._host_offload.memory_report()["pinned"] and off._host_offload.num_buckets > 3
    rec = []
    for engine in (ref, off):
        rec.append([])
        for i in range(4):
            toks = np.random.RandomState(i).randint(0, 256, (4, 65))
            loss = engine({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
            engine.backward(loss)
            engine.step()
            rec[-1].append((loss.item(), engine.get_global_grad_norm()))
    assert rec[0] == rec[1]
    a, b = flatten_tree(ref.get_master_params()), flatten_tree(off.get_master_params())
    assert all(np.array_equal(a[k], b[k]) for k in a)
    stats = off.offload_stream_stats()
    assert stats["h2d_ms"] > 0 and stats["d2h_ms"] > 0 and stats["steps"] == 4


def test_host_adam_on_pinned_buffers_on_card(cuda_device):
    """The host Adam on the numpy views of pinned tensors, fed by a
    ``non_blocking`` copy from the card and waited on by its event, equals
    the same update on pageable copies."""
    from deepspeed_tpu_torch.ops.adam.cpu_adam_native import NativeCPUAdam

    n = 3 * 2**20 + 5
    g_dev = torch.randn(n, device=cuda_device)
    pinned = torch.empty(n, pin_memory=True)
    pinned.copy_(g_dev, non_blocking=True)
    landed = torch.cuda.Event()
    landed.record()
    p = np.random.RandomState(0).randn(n).astype(np.float32)
    state = [p.copy(), np.zeros(n, np.float32), np.zeros(n, np.float32)]
    ref = [p.copy(), np.zeros(n, np.float32), np.zeros(n, np.float32)]
    master = torch.from_numpy(state[0]).pin_memory()
    landed.synchronize()
    adam = NativeCPUAdam(lr=1e-3, weight_decay=0.01)
    adam.step(master.numpy(), pinned.numpy(), state[1], state[2], step=1)
    adam.step(ref[0], g_dev.cpu().numpy(), ref[1], ref[2], step=1)
    assert master.numpy().tobytes() == ref[0].tobytes() and state[1].tobytes() == ref[1].tobytes()
    back = master.to(cuda_device, non_blocking=True)
    assert torch.equal(back.cpu(), torch.from_numpy(ref[0]))


def test_param_offload_launches_on_card(cuda_device):
    """``offload_param`` in bf16: K1 twice a layer a step (forward and the
    recompute), K2 and K3 once, all on the tensor-core variants."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    engine = _offload_card_engine(cuda_device, {"stage": 3, "offload_param": {"device": "cpu"}})
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv, fa.launches_fwd_tc, fa.launches_dq_tc,
              fa.launches_dkv_tc)
    for i in range(2):
        toks = np.random.RandomState(i).randint(0, 256, (4, 65))
        loss = engine({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
        engine.backward(loss)
        engine.step()
    after = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv, fa.launches_fwd_tc, fa.launches_dq_tc,
             fa.launches_dkv_tc)
    d = [a - b for a, b in zip(after, before)]
    assert d == [8, 4, 4, 8, 4, 4]
    assert np.isfinite(engine.get_global_grad_norm())


# --- captured training step programs ------------------------------------------------------------
def _step_engine(device, fuse=False, multi_step=False, gas=2, model=None):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.jax_params import unflatten_tree
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = TransformerConfig(**(model or dict(vocab_size=512, hidden_size=320, num_layers=2, num_heads=4,
                                             max_seq_len=128, dtype="bfloat16", remat=True)))
    config = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": gas, "bf16": {"enabled": True},
              "gradient_clipping": 1.0, "optimizer": {"type": "adam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
              "compile": {"fuse_grad_accum": fuse, "multi_step": {"enable": multi_step, "horizon": 2}}}
    engine, *_ = dst.initialize(model=TransformerLM(cfg), config=config,
                                model_parameters=unflatten_tree(init_params(cfg, 0)), device=device)
    return engine


def _step_batches(n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rs.randint(0, 512, (4, 129))
        out.append({"input_ids": t[:, :-1], "labels": t[:, 1:]})
    return out


def test_captured_fused_step_bitwise_the_eager_step_on_card(cuda_device):
    """``compile.fuse_grad_accum`` at gas 2, bf16, remat, head_dim 80: the
    third and later steps replay one captured CUDA graph (the first is the
    warm-up, the second captures); losses, grad norms and the master equal
    the eager engine's bit for bit."""
    from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree

    data = _step_batches(8)
    runs = []
    for fuse in (False, True):
        e = _step_engine(cuda_device, fuse=fuse)
        it = iter(data)
        rec = [(float(e.train_batch(data_iter=it)), e.get_global_grad_norm()) for _ in range(4)]
        runs.append((rec, {k: np.asarray(v) for k, v in flatten_tree(e.get_master_params()).items()},
                     e.window_stats()["graphs"]))
    assert runs[1][0] == runs[0][0]
    assert all(runs[1][1][k].tobytes() == runs[0][1][k].tobytes() for k in runs[0][1])
    assert runs[1][2] == {"captures": 1, "replays": 3, "warmups": 1, "uncaptured": 0}
    assert runs[0][2]["replays"] == 0


def test_safe_set_full_fp32_param_is_seen_by_the_next_replay_on_card(cuda_device):
    """A set on a captured path writes into the graph's own state: the next
    replay trains from it, as the eager engine given the same set does."""
    from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree
    from deepspeed_tpu_torch.utils import tensor_fragment as tf

    data = _step_batches(12, seed=1)
    finals = []
    for fuse in (False, True):
        e = _step_engine(cuda_device, fuse=fuse)
        it = iter(data)
        for _ in range(3):  # on the fused engine: warm-up, capture, replay
            e.train_batch(data_iter=it)
        value = tf.safe_get_full_fp32_param(e, "layers/wq") * 0.5
        tf.safe_set_full_fp32_param(e, "layers/wq", value)
        tf.safe_set_full_optimizer_state(e, "layers/wq", "exp_avg", np.zeros_like(value))
        loss = float(e.train_batch(data_iter=it))
        finals.append((loss, {k: np.asarray(v) for k, v in flatten_tree(e.get_master_params()).items()}))
        if fuse:
            assert e.window_stats()["graphs"]["replays"] == 3
    assert finals[1][0] == finals[0][0]
    assert all(finals[1][1][k].tobytes() == finals[0][1][k].tobytes() for k in finals[0][1])


def test_set_train_batch_size_releases_the_graph_pool_on_card(cuda_device):
    """A resize drops the captured step program and returns its graph pool
    to the card (the reserved bytes fall back); the next steps capture
    anew at the new gas and equal an engine built at it."""
    data = _step_batches(16, seed=2)
    e = _step_engine(cuda_device, fuse=True)
    it = iter(data)
    for _ in range(3):  # warm-up, capture, replay
        e.train_batch(data_iter=it)
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved(cuda_device)
    e.set_train_batch_size(16)  # micro 4 x gas 4
    after = torch.cuda.memory_reserved(cuda_device)
    assert after < before and e.gradient_accumulation_steps() == 4 and not e._graphs
    rest = [float(e.train_batch(data_iter=it)) for _ in range(2)]  # a new warm-up, then a new capture
    assert e.window_stats()["graphs"]["captures"] == 2 and all(np.isfinite(rest))


def test_second_sequence_length_shares_the_graph_pool_on_card(cuda_device):
    """Every step program captures into the engine's one graph pool: a
    second sequence length (128, then 120) reuses the first one's memory
    instead of reserving a pool of its own, and both shapes keep replaying
    bitwise an eager engine fed the same batches."""
    def batches(T, n, seed):
        rs = np.random.RandomState(seed)
        return [{"input_ids": t[:, :-1], "labels": t[:, 1:]} for t in (rs.randint(0, 512, (4, T + 1))
                                                                         for _ in range(n))]

    data = batches(128, 6, 3) + batches(120, 6, 4) + batches(128, 2, 5)
    runs = []
    for fuse in (False, True):
        e = _step_engine(cuda_device, fuse=fuse)
        it = iter(data)
        torch.cuda.synchronize()
        r0 = torch.cuda.memory_reserved(cuda_device)
        losses = [float(e.train_batch(data_iter=it)) for _ in range(3)]  # T 128: warm-up, capture, replay
        torch.cuda.synchronize()
        r1 = torch.cuda.memory_reserved(cuda_device)
        losses += [float(e.train_batch(data_iter=it)) for _ in range(3)]  # T 120: the same
        torch.cuda.synchronize()
        r2 = torch.cuda.memory_reserved(cuda_device)
        losses += [float(e.train_batch(data_iter=it))]  # T 128 again: a replay
        runs.append(losses)
        if fuse:
            assert e.window_stats()["graphs"] == {"captures": 2, "replays": 5, "warmups": 2, "uncaptured": 0}
            assert r2 - r1 <= 0.25 * (r1 - r0), (r0, r1, r2)
        del e
        torch.cuda.empty_cache()
    assert runs[1] == runs[0]


def test_streamed_offload_window_frees_its_card_state_on_card(cuda_device):
    """Windows over the streamed offload hold the gathered master and
    moments on the card only while the window runs: after three windows (a
    warm-up, then two captures over fresh state, each into a new graph
    pool) the card holds what the sequential streamed engine holds after
    the same steps, and the host state is bitwise that engine's."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.jax_params import unflatten_tree
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = TransformerConfig(vocab_size=512, hidden_size=320, num_layers=2, num_heads=4, max_seq_len=128,
                            dtype="bfloat16", remat=False)
    data = _step_batches(6, seed=6)
    held, hosts = [], []
    for horizon in (0, 2):
        config = {"train_micro_batch_size_per_gpu": 4, "bf16": {"enabled": True}, "gradient_clipping": 1.0,
                  "optimizer": {"type": "adam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
                  "zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu", "pipeline_read": True}},
                  "compile": {"multi_step": {"enable": horizon > 0, "horizon": max(horizon, 1)}}}
        e, *_ = dst.initialize(model=TransformerLM(cfg), config=config,
                               model_parameters=unflatten_tree(init_params(cfg, 0)), device=cuda_device)
        it = iter(data)
        for _ in range(6):
            e.train_batch(data_iter=it)
        e.flush_loss_drain()
        e._host_offload.materialize_writes()
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()  # cuBLAS's per-stream workspaces: a process cache, not the engine's
        torch.cuda.empty_cache()  # and the frees held back for other streams' events
        held.append(torch.cuda.memory_allocated(cuda_device))
        hosts.append([[leaf[f].clone() for f in ("master", "exp_avg", "exp_avg_sq")]
                      for leaf in e._host_offload.state_dict()["leaves"]])
        if horizon:
            assert e.window_stats()["window_steps"] == 3 and e.window_stats()["graphs"]["captures"] == 2
        del e, it
        torch.cuda.empty_cache()
    state_bytes = sum(t.numel() * 4 for leaf in hosts[0] for t in leaf)
    assert held[1] <= held[0] + state_bytes // 8, (held, state_bytes)
    assert all(torch.equal(a, b) for x, y in zip(hosts[0], hosts[1]) for a, b in zip(x, y))
