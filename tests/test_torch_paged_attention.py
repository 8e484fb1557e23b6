"""The port's ragged paged attention against the JAX package's.

The same numpy inputs go through ``deepspeed_tpu``'s
``ragged_paged_attention`` (the Pallas kernel in interpret mode, and the
XLA path) and ``deepspeed_tpu_torch``'s plain version, which is what a CPU
tensor runs and what the CUDA kernel is held against on the card.

Tolerance: 2e-5 absolute and relative on live window slots, in fp32 — the
same bound the JAX package's own tests use between its two paths; the
three implementations sum the same products in different orders (online
softmax in the Pallas kernel), which moves results by a few fp32 ulps.
Dead rows (kv_len 0) must be exact zeros. Window slots past q_len carry no
contract and are not compared.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer.paged_attention import ragged_paged_attention as jax_ragged
from deepspeed_tpu_torch.ops.transformer import paged_attention as torch_pa

ATOL = RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast and leaves the cores to
    the JAX tests running in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fixture(rs, R=3, W=6, NH=4, NKV=2, D=16, P=8, NP=12, maxp=4):
    """``_ragged_fixture`` of tests/unit/ops/test_paged_attention.py: row 0
    decodes (q_len 1), row 1 is a prefill chunk filling its window, row 2
    is dead padding."""
    q = rs.randn(R, W, NH, D).astype(np.float32)
    kp = rs.randn(NP, NKV, P, D).astype(np.float32)
    vp = rs.randn(NP, NKV, P, D).astype(np.float32)
    pt = np.full((R, maxp), -1, np.int32)
    pt[0, :3] = [3, 7, 1]
    pt[1, :1] = [5]
    kv_lens = np.array([18, W, 0], np.int32)
    q_lens = np.array([1, W, 0], np.int32)
    return q, kp, vp, pt, kv_lens, q_lens


def _verify_fixture(rs):
    """A verify-shaped row: q_len 3 starting mid-sequence at position 5, with
    garbage in the tabled page past the live length."""
    q = rs.randn(1, 4, 4, 8).astype(np.float32)
    kp = rs.randn(8, 2, 4, 8).astype(np.float32)
    vp = rs.randn(8, 2, 4, 8).astype(np.float32)
    kp[1] = 1e4  # table slot 2 = positions 8..11, all >= kv_len 8
    vp[1] = -1e4
    pt = np.array([[2, 5, 1, -1]], np.int32)
    return q, kp, vp, pt, np.array([8], np.int32), np.array([3], np.int32)


def _gqa4_fixture(rs):
    """A GQA group of 4 (8 query heads over 2 kv heads), decode, chunk
    mid-sequence and dead rows, page ids up to NP-1 and -1 sentinels."""
    R, W, NH, NKV, D, P, NP, maxp = 4, 5, 8, 2, 16, 4, 16, 6
    q = rs.randn(R, W, NH, D).astype(np.float32)
    kp = rs.randn(NP, NKV, P, D).astype(np.float32)
    vp = rs.randn(NP, NKV, P, D).astype(np.float32)
    pt = np.full((R, maxp), -1, np.int32)
    pt[0, :5] = [15, 2, 9, 4, 11]
    pt[1, :3] = [6, 1, 13]
    pt[2, :2] = [8, 3]
    kv_lens = np.array([19, 12, 5, 0], np.int32)
    q_lens = np.array([1, 5, 2, 0], np.int32)
    return q, kp, vp, pt, kv_lens, q_lens


FIXTURES = {"mixed": (_fixture, 4), "verify_mid_sequence": (_verify_fixture, 6), "gqa_group4": (_gqa4_fixture, 7)}


def _torch_plain(q, kp, vp, pt, kv_lens, q_lens, impl="auto"):
    t = torch.from_numpy
    out = torch_pa.ragged_paged_attention(t(q), t(kp), t(vp), t(pt), t(kv_lens), t(q_lens), impl=impl)
    return out.numpy()


@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_plain_matches_jax(name, jax_impl):
    make, seed = FIXTURES[name]
    q, kp, vp, pt, kv_lens, q_lens = make(np.random.RandomState(seed))
    ref = np.asarray(jax_ragged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
                                jnp.asarray(kv_lens), jnp.asarray(q_lens), impl=jax_impl))
    out = _torch_plain(q, kp, vp, pt, kv_lens, q_lens)
    for r, ql in enumerate(q_lens):
        np.testing.assert_allclose(out[r, :ql], ref[r, :ql], rtol=RTOL, atol=ATOL, err_msg=f"row {r}")
        if kv_lens[r] == 0:
            assert (out[r] == 0).all(), f"dead row {r} is not exact zeros"


@pytest.mark.parametrize("impl", ["auto", "kernel", "plain", "pallas", "xla"])
def test_cpu_tensor_takes_the_plain_version(impl):
    """Every impl name runs the plain version for a CPU tensor, bit for bit."""
    q, kp, vp, pt, kv_lens, q_lens = _fixture(np.random.RandomState(4))
    base = _torch_plain(q, kp, vp, pt, kv_lens, q_lens, impl="plain")
    np.testing.assert_array_equal(_torch_plain(q, kp, vp, pt, kv_lens, q_lens, impl=impl), base)


def test_unknown_impl_raises():
    q, kp, vp, pt, kv_lens, q_lens = _fixture(np.random.RandomState(4))
    with pytest.raises(ValueError, match="attn_impl"):
        _torch_plain(q, kp, vp, pt, kv_lens, q_lens, impl="flash")


def test_garbage_past_kv_len_is_inert():
    """Huge values in tabled pages past kv_len, and in the trash page, do
    not reach live slots."""
    q, kp, vp, pt, kv_lens, q_lens = _verify_fixture(np.random.RandomState(6))
    clean_k, clean_v = kp.copy(), vp.copy()
    clean_k[1], clean_v[1] = 0.0, 0.0
    a = _torch_plain(q, kp, vp, pt, kv_lens, q_lens)
    b = _torch_plain(q, clean_k, clean_v, pt, kv_lens, q_lens)
    np.testing.assert_allclose(a[:, :3], b[:, :3], rtol=1e-6, atol=1e-6)


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper never runs on a CPU tensor (the dispatch sends those
    to the plain version); called directly it raises before building."""
    from deepspeed_tpu_torch.ops.transformer import decode_attention

    q, kp, vp, pt, kv_lens, q_lens = (torch.from_numpy(a) for a in _fixture(np.random.RandomState(4)))
    before = decode_attention.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_attention.ragged_paged_attention(q, kp, vp, pt, kv_lens, q_lens, scale=0.25)
    assert decode_attention.launches == before
