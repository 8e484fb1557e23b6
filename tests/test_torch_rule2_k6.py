"""The split arithmetic of the redesigned K6 (dense decode attention as
split-KV) against the plain version and the JAX package on the CPU.

``dense_split_partials_plain`` (K6's split kernel in plain torch: the
contiguous cache read as one page a row, kv_len clamped into ``[0, S]``)
with ``paged_combine_plain`` (the CUDA combine's formula, splits merged in
split order) against ``decode_attention_plain`` at 1e-6 (the same
exponentials, summed in another order) and JAX's ``decode_attention``
(the Pallas kernel in interpret mode) at 2e-5 (the JAX package's own bound
between paths). Cases: kv_len 0, 1, on a 64-key split boundary and one
past it, S and past S; S = 100 (not a multiple of the split); MHA; a GQA
group of 7; head_dim 128. All in fp32, inputs made with numpy from a seed.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import decode_attention as jax_da
from deepspeed_tpu_torch.ops.transformer import decode_attention as da

SPLIT = 64  # the CUDA kernel's split (csrc/decode_attention.cu)
CASES = {  # name: (NH, NKV, D, S); every case runs kv_len 0, 1, 64, 65, S and past S
    "GQA Hg=4 D=64 S=128": (8, 2, 64, 128),
    "GQA Hg=4 D=64 S=100": (8, 2, 64, 100),
    "MHA D=64 S=128": (4, 4, 64, 128),
    "Hg=7 D=128 S=192": (14, 2, 128, 192),
}


def _case(name, seed):
    NH, NKV, D, S = CASES[name]
    lens = np.array([0, 1, 64, 65, S, S + 37], np.int32)
    rs = np.random.RandomState(seed)
    q = rs.randn(lens.size, NH, D).astype(np.float32)
    k, v = (rs.randn(lens.size, S, NKV, D).astype(np.float32) for _ in range(2))
    return q, k, v, lens


def _split_then_combine(q, k, v, lens, split_keys):
    t = [torch.from_numpy(x) for x in (q, k, v, lens)]
    m, l, acc = da.dense_split_partials_plain(*t, split_keys=split_keys, scale=1.0 / np.sqrt(q.shape[-1]))
    return da.paged_combine_plain(m, l, acc, t[3], torch.float32).numpy(), l.numpy()


@pytest.mark.parametrize("split_keys", [16, SPLIT])
@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_split_then_combine_matches_unsplit_plain(name, split_keys):
    """Split-then-combine equals the unsplit plain version to 1e-6; the dead
    row is exact zeros; exactly the splits below the clamped kv_len hold a
    partial (l > 0), so keys past S are never part of one."""
    q, k, v, lens = _case(name, 0)
    out, l = _split_then_combine(q, k, v, lens, split_keys)
    ref = da.decode_attention_plain(*(torch.from_numpy(x) for x in (q, k, v, lens))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    assert (out[0] == 0).all()
    S = k.shape[1]
    assert l.shape[-1] == -(-S // split_keys)
    live_splits = -(-np.minimum(lens, S) // split_keys)
    for r, n in enumerate(live_splits):
        assert (l[r, :, :n] > 0).all() and (l[r, :, n:] == 0).all(), f"row {r}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_split_then_combine_matches_pallas_interpret(name):
    """JAX's ``decode_attention`` (Pallas in interpret mode) is the outer
    reference at the kernel's 64-key splits (2e-5); its dead row is zeros
    too, and kv_len past S reads the whole cache on both sides."""
    q, k, v, lens = _case(name, 1)
    out, _ = _split_then_combine(q, k, v, lens, SPLIT)
    ref = np.asarray(jax_da.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                                             interpret=True))
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    assert (ref[0] == 0).all() and (out[0] == 0).all()
    at_s, _ = _split_then_combine(q, k, v, np.minimum(lens, k.shape[1]), SPLIT)
    np.testing.assert_array_equal(out, at_s)  # kv_len S + 37 clamps to S
