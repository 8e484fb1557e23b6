"""The port's flash attention against the JAX package's Pallas kernels.

The port's three plain functions (K1's forward, K2's dQ, K3's dK/dV) and
its autograd path are held against ``_flash_fwd`` / ``_flash_bwd`` /
``flash_attention`` of ``deepspeed_tpu/ops/transformer/flash_attention.py``
run in interpret mode on the CPU, at the shapes and tolerances of
``tests/unit/ops/test_flash_attention.py`` (B=2, T=256, N=4, D=64, blocks
of 128; fp32; O and LSE within 2e-5, dQ, dK and dV within 5e-4). Inputs are
made with numpy from a seed and fed to both packages. The CUDA kernels
themselves are held against these plain functions on the card
(``tests/test_torch_card.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

# the JAX package's ops.transformer re-exports the function under the module's name
jax_fa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")

B, N, D, BLK = 2, 4, 64, 128
SCALE = 1.0 / np.sqrt(D)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(T, seed=0):
    """q, k, v, dO as ``[B, T, N, D]`` fp32 numpy."""
    rs = np.random.RandomState(seed)
    return [rs.randn(B, T, N, D).astype(np.float32) for _ in range(4)]


def _to_bn(x):
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * N, x.shape[1], D)


def _from_bn(x, T):
    return np.asarray(x).reshape(B, N, T, D).transpose(0, 2, 1, 3)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _jax_residuals(q, k, v, do, causal):
    """The Pallas forward's O and LSE, and the backward's dQ, dK, dV, in
    the port's layouts."""
    T = q.shape[1]
    qb, kb, vb, dob = (_to_bn(x) for x in (q, k, v, do))
    o, lse = jax_fa._flash_fwd(qb, kb, vb, SCALE, causal, BLK, BLK, True)
    dq, dk, dv = jax_fa._flash_bwd((qb, kb, vb, o, lse), dob, SCALE, causal, BLK, BLK, True)
    return _from_bn(o, T), np.asarray(lse), [_from_bn(g, T) for g in (dq, dk, dv)]


@pytest.fixture(scope="module", params=[True, False], ids=["causal", "full"])
def case(request):
    causal = request.param
    q, k, v, do = _inputs(256)
    o, lse, grads = _jax_residuals(q, k, v, do, causal)
    return causal, (q, k, v, do), o, lse, grads


def test_fwd_plain_matches_pallas(case):
    causal, (q, k, v, _), o_ref, lse_ref, _ = case
    o, lse = fa.flash_fwd_plain(_t(q), _t(k), _t(v), causal=causal, scale=SCALE)
    assert lse.shape == (B * N, 256) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), o_ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=2e-5, rtol=0)


def test_dq_plain_matches_pallas(case):
    """K2's function on the Pallas forward's own O and LSE."""
    causal, (q, k, v, do), o_ref, lse_ref, (dq_ref, _, _) = case
    delta = fa.flash_delta(_t(o_ref), _t(do))
    dq = fa.flash_dq_plain(_t(q), _t(k), _t(v), _t(do), _t(lse_ref), delta, causal=causal, scale=SCALE)
    np.testing.assert_allclose(dq.numpy(), dq_ref, atol=5e-4, rtol=0)


def test_dkv_plain_matches_pallas(case):
    """K3's function on the Pallas forward's own O and LSE."""
    causal, (q, k, v, do), o_ref, lse_ref, (_, dk_ref, dv_ref) = case
    delta = fa.flash_delta(_t(o_ref), _t(do))
    dk, dv = fa.flash_dkv_plain(_t(q), _t(k), _t(v), _t(do), _t(lse_ref), delta, causal=causal, scale=SCALE)
    np.testing.assert_allclose(dk.numpy(), dk_ref, atol=5e-4, rtol=0)
    np.testing.assert_allclose(dv.numpy(), dv_ref, atol=5e-4, rtol=0)


@pytest.mark.parametrize("T,causal", [(200, True), (64, True)], ids=["T200-padded", "T64-single-block"])
def test_autograd_matches_pallas(T, causal):
    """The differentiable entry point against JAX's ``flash_attention``
    and its VJP (T=256 causal and full are held above, function by
    function). T=200 is not a multiple of the block: JAX pads it, the port
    masks the ragged edge."""
    q, k, v, do = _inputs(T, seed=T)
    o_ref, vjp = jax.vjp(lambda a, b, c: jax_fa.flash_attention(a, b, c, causal=causal, block_q=BLK,
                                                                block_k=BLK, interpret=True),
                         *(jnp.asarray(x) for x in (q, k, v)))
    grads_ref = vjp(jnp.asarray(do))
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    o = fa.flash_attention(qt, kt, vt, causal=causal)
    o.backward(_t(do))
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == before  # CPU: the plain path
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), atol=2e-5, rtol=0)
    for got, ref in zip((qt.grad, kt.grad, vt.grad), grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4, rtol=0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A CPU tensor never reaches a kernel wrapper through the dispatch;
    given one directly, the wrapper raises instead of computing."""
    q, k, v, do = (_t(x) for x in _inputs(64))
    lse = torch.zeros(B * N, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_kernel(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_dq_kernel(q, k, v, do, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_dkv_kernel(q, k, v, do, lse, lse)
    with pytest.raises(ValueError, match="unknown attention impl"):
        fa.flash_attention(q, k, v, impl="flash")
