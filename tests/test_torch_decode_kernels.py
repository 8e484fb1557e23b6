"""The plain versions of the decode kernels K5 and K6, and the sampling
filters, against the JAX package on the CPU.

* K6: ``decode_attention_plain`` (the CPU side of ``decode_attention``)
  against the Pallas ``decode_attention`` in interpret mode, at
  tests/unit/ops/test_decode_attention.py's shapes (B 3, NH 8, D 64,
  S 512, block_k 128) for MHA, GQA and MQA, ragged lengths including 0
  and S. Within 2e-5: both run the softmax and P·V in fp32, in another
  order (online over blocks against all at once).
* K5: ``paged_decode_attention`` on CPU tensors against the JAX
  ``paged_decode_attention`` with ``impl="pallas"`` (interpret) and
  ``impl="xla"``, at tests/unit/ops/test_paged_attention.py's shapes, with
  ``-1`` sentinel ids and a dead row: within 2e-5, dead rows exactly 0.
* The argument checks raise ``ValueError`` as JAX's do.
* ``apply_filters`` / ``top_k_filter`` / ``top_p_filter`` bit-exact against
  JAX on seeded logits with ties, ``top_p = 0`` and ``top_k > V``; the
  Gumbel-max draw with JAX's own noise picks the ids
  ``jax.random.categorical`` picks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import sampling as jax_sampling
from deepspeed_tpu.ops.transformer import decode_attention as jax_da
from deepspeed_tpu.ops.transformer import paged_attention as jax_pa
from deepspeed_tpu_torch.inference import sampling
from deepspeed_tpu_torch.ops.transformer import decode_attention as da
from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

TOL = 2e-5


@functools.lru_cache(maxsize=None)
def _jit(fn, **static):
    """The JAX function jitted with its static arguments bound: one compile
    per shape instead of one dispatch per primitive."""
    return jax.jit(functools.partial(fn, **static))


@pytest.mark.parametrize("nkv", [8, 2, 1])  # MHA, GQA, MQA
def test_plain_decode_matches_pallas(nkv):
    B, NH, D, S = 3, 8, 64, 512
    rs = np.random.RandomState(0)
    q = rs.randn(B, NH, D).astype(np.float32)
    k = rs.randn(B, S, nkv, D).astype(np.float32)
    v = rs.randn(B, S, nkv, D).astype(np.float32)
    lens = np.array([0, 200, 512], np.int32)
    ref = np.asarray(jax_da.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lens, block_k=128))
    t = torch.from_numpy
    out = da.decode_attention(t(q), t(k), t(v), t(lens), block_k=128).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    assert (out[0] == 0).all() and (ref[0] == 0).all()


def test_plain_decode_scalar_length_and_scale():
    B, NH, D, S = 2, 4, 32, 256
    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(*shape).astype(np.float32) for shape in ((B, NH, D), (B, S, NH, D), (B, S, NH, D)))
    ref = np.asarray(jax_da.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 77, scale=1.0))
    out = da.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 77, scale=1.0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def _pool(rs, B, NH, nkv, D, P, NP, maxp, tables, lens):
    q = rs.randn(B, NH, D).astype(np.float32)
    kp = rs.randn(NP, nkv, P, D).astype(np.float32)
    vp = rs.randn(NP, nkv, P, D).astype(np.float32)
    pt = np.full((B, maxp), -1, np.int32)
    for b, ids in enumerate(tables):
        pt[b, : len(ids)] = ids
    return q, kp, vp, pt, np.asarray(lens, np.int32)


PAGED_CASES = {  # tests/unit/ops/test_paged_attention.py shapes, plus a dead row
    "mha": dict(B=3, NH=4, nkv=4, D=16, P=8, NP=12, maxp=4, tables=[[3, 7, 1], [], [2, 9, 4, 8]], lens=[20, 0, 32]),
    "gqa": dict(B=3, NH=4, nkv=2, D=16, P=8, NP=12, maxp=4, tables=[[3, 7, 1], [5], [2, 9, 4, 8]], lens=[20, 8, 32]),
    "mqa": dict(B=3, NH=4, nkv=1, D=16, P=8, NP=12, maxp=4, tables=[[3, 7, 1], [], [2, 9, 4, 8]], lens=[20, 0, 32]),
    "pallas_xla": dict(B=2, NH=4, nkv=2, D=16, P=8, NP=10, maxp=3, tables=[[4, 2], [7, 1, 9]], lens=[13, 24]),
    "dead_rows": dict(B=2, NH=2, nkv=2, D=8, P=4, NP=6, maxp=2, tables=[[3], []], lens=[4, 0]),
}


@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_plain_paged_decode_matches_jax(case, jax_impl):
    q, kp, vp, pt, lens = _pool(np.random.RandomState(1), **PAGED_CASES[case])
    ref = np.asarray(_jit(jax_pa.paged_decode_attention, impl=jax_impl)(q, kp, vp, pt, lens))
    t = torch.from_numpy
    out = da.paged_decode_attention(t(q), t(kp), t(vp), t(pt), t(lens)).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    # the serving dispatch (JAX names accepted) gives the same plain result
    out_d = pa.paged_decode_attention(t(q), t(kp), t(vp), t(pt), t(lens), impl=jax_impl).numpy()
    np.testing.assert_array_equal(out_d, out)
    dead = lens == 0
    assert (out[dead] == 0).all() and (ref[dead] == 0).all()


def test_argument_checks_raise():
    q = torch.zeros(1, 6, 8)
    kv = torch.zeros(1, 256, 4, 8)
    with pytest.raises(ValueError, match="multiple"):
        da.decode_attention(q, kv, kv, 10)
    kv3 = torch.zeros(1, 384, 2, 8)
    with pytest.raises(ValueError, match="divisible"):
        da.decode_attention(q, kv3, kv3, 10)  # S 384 % block 256
    pages = torch.zeros(5, 4, 8, 8)
    with pytest.raises(ValueError, match="multiple"):
        da.paged_decode_attention(q, pages, pages, torch.zeros(1, 2, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="multiple"):
        pa.paged_decode_attention(q, pages, pages, torch.zeros(1, 2, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="multiple"):
        jax_da.decode_attention(jnp.zeros((1, 6, 8)), jnp.zeros((1, 256, 4, 8)), jnp.zeros((1, 256, 4, 8)), 10)


def _logits(seed, B=4, V=64):
    """Seeded logits rounded to one decimal, so rows carry ties."""
    return np.round(np.random.RandomState(seed).randn(B, V) * 2, 1).astype(np.float32)


FILTERS = [(0, 1.0), (1, 1.0), (5, 1.0), (200, 1.0), (0, 0.0), (0, 0.5), (0, 0.9), (5, 0.5), (200, 0.9)]


@pytest.mark.parametrize("top_k,top_p", FILTERS)
def test_filters_bit_exact(top_k, top_p):
    x = _logits(top_k * 7 + int(top_p * 10))
    ref = np.asarray(_jit(jax_sampling.apply_filters, top_k=top_k, top_p=top_p)(x))
    out = sampling.apply_filters(torch.from_numpy(x), top_k=top_k, top_p=top_p).numpy()
    np.testing.assert_array_equal(out, ref)
    if top_p == 1.0 and top_k:
        np.testing.assert_array_equal(sampling.top_k_filter(torch.from_numpy(x), top_k).numpy(),
                                      np.asarray(_jit(jax_sampling.top_k_filter, k=top_k)(x)))
    if top_k == 0 and top_p < 1.0:
        np.testing.assert_array_equal(sampling.top_p_filter(torch.from_numpy(x), top_p).numpy(),
                                      np.asarray(_jit(jax_sampling.top_p_filter, p=top_p)(x)))


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.9, 10, 0.9)])
def test_gumbel_max_with_jax_noise(temperature, top_k, top_p):
    """The draw given JAX's own Gumbel noise: the port's
    ``argmax(filtered + noise)`` picks the ids ``jax.random.categorical``
    picks with the same key."""
    x = np.random.RandomState(3).randn(8, 64).astype(np.float32)
    key = jax.random.PRNGKey(11)
    filtered = _jit(jax_sampling.apply_filters, top_k=top_k, top_p=top_p)(x / np.float32(temperature))
    ref = np.asarray(_jit(jax.random.categorical, axis=-1)(key, filtered))
    noise = np.asarray(jax.random.gumbel(key, filtered.shape, filtered.dtype))
    mine = sampling.apply_filters(torch.from_numpy(x) / temperature, top_k, top_p)
    got = sampling._gumbel_argmax(mine, torch.from_numpy(noise.copy())).numpy()
    np.testing.assert_array_equal(got, ref)


def test_sample_logits_greedy_and_seeded():
    x = torch.from_numpy(np.random.RandomState(4).randn(3, 50).astype(np.float32))
    greedy = torch.argmax(x, dim=-1)
    assert torch.equal(sampling.sample_logits(x, None, temperature=1.0), greedy)
    assert torch.equal(sampling.sample_logits(x, torch.Generator().manual_seed(0), temperature=0.0), greedy)
    draws = [sampling.sample_logits(x, torch.Generator().manual_seed(5), temperature=1.0, top_k=4) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    top4 = torch.topk(x, 4, dim=-1).indices
    assert all(int(d) in top4[i].tolist() for i, d in enumerate(draws[0]))
