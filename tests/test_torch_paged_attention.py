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

K4's split-KV arithmetic (``decode_attention.ragged_split_partials_plain``
and ``ragged_combine_plain``, the formula of the CUDA combine kernel): the
partials of several split lengths, merged in split order, against the
unsplit plain version at 1e-6 in fp32, with kv_len on and one past split
boundaries, empty splits, dead rows and slots past q_len (exact zeros
after the combine), and against the Pallas kernel in interpret mode at one
shape.
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


# --- K4's split-KV arithmetic: partials per key split, merged in split order ----------
def _boundary_fixture(rs):
    """Tables of 8 pages of 4 keys (32 keys): kv_len on a boundary of 8-key
    splits and one key past it (decode rows, and 4-token chunks that end on
    or cross one), a row with one key in its last split, a full row, a
    partial chunk, a dead row; distinct pages ending in -1 sentinels."""
    rows = [(8, 1), (9, 1), (16, 4), (17, 4), (25, 1), (32, 4), (3, 2), (0, 0)]
    R, W, NH, NKV, D, P, maxp = len(rows), 4, 6, 2, 16, 4, 8
    NP = 1 + sum(-(-kv // P) for kv, _ in rows)
    pt = np.full((R, maxp), -1, np.int32)
    free = rs.permutation(np.arange(1, NP))
    used = 0
    for r, (kv, _) in enumerate(rows):
        n = -(-kv // P)
        pt[r, :n] = free[used : used + n]
        used += n
    q = rs.randn(R, W, NH, D).astype(np.float32)
    kp = rs.randn(NP, NKV, P, D).astype(np.float32)
    vp = rs.randn(NP, NKV, P, D).astype(np.float32)
    kv_lens = np.array([r[0] for r in rows], np.int32)
    q_lens = np.array([r[1] for r in rows], np.int32)
    return q, kp, vp, pt, kv_lens, q_lens


SPLIT_FIXTURES = dict(FIXTURES, boundaries=(_boundary_fixture, 8))


def _split_then_combine(q, kp, vp, pt, kv_lens, q_lens, split_keys):
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da

    t = [torch.from_numpy(a) for a in (q, kp, vp, pt, kv_lens, q_lens)]
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    m, l, acc = da.ragged_split_partials_plain(*t, split_keys=split_keys, scale=scale)
    return da.ragged_combine_plain(m, l, acc, t[4], t[5], torch.float32).numpy(), l.numpy()


@pytest.mark.parametrize("split_keys", [1, 3, 4, 8, 16, 1000])
@pytest.mark.parametrize("name", sorted(SPLIT_FIXTURES))
def test_split_then_combine_matches_unsplit_plain(name, split_keys):
    """The combine's merge of per-split partials equals the unsplit plain
    version to 1e-6 in fp32 on live slots (the same exponentials, summed
    in another order); dead rows and slots past q_len are exact zeros."""
    make, seed = SPLIT_FIXTURES[name]
    q, kp, vp, pt, kv_lens, q_lens = make(np.random.RandomState(seed))
    out, l = _split_then_combine(q, kp, vp, pt, kv_lens, q_lens, split_keys)
    ref = _torch_plain(q, kp, vp, pt, kv_lens, q_lens)
    for r, ql in enumerate(q_lens):
        np.testing.assert_allclose(out[r, :ql], ref[r, :ql], rtol=1e-6, atol=1e-6, err_msg=f"row {r}")
        assert (out[r, ql:] == 0).all(), f"row {r}: slots past q_len are not exact zeros"
    if name == "boundaries" and split_keys == 8:
        # four splits; a row ending on a boundary leaves the next split empty
        assert l.shape[-1] == 4
        assert (l[0, 0, :, 1:] == 0).all() and (l[1, 0, :, 1] > 0).all() and (l[1, 0, :, 2:] == 0).all()
        assert (l[4, 0, :, 3] > 0).all()


def test_split_then_combine_matches_pallas_interpret():
    """At one small shape the JAX Pallas kernel in interpret mode is the
    outer reference for split-then-combine (2e-5, the JAX package's own
    bound between its paths)."""
    q, kp, vp, pt, kv_lens, q_lens = _boundary_fixture(np.random.RandomState(8))
    ref = np.asarray(jax_ragged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
                                jnp.asarray(kv_lens), jnp.asarray(q_lens), impl="pallas"))
    out, _ = _split_then_combine(q, kp, vp, pt, kv_lens, q_lens, 8)
    for r, ql in enumerate(q_lens):
        np.testing.assert_allclose(out[r, :ql], ref[r, :ql], rtol=RTOL, atol=ATOL, err_msg=f"row {r}")
