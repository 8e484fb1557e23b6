"""The host side of the redesigned K8 (block-sparse dQ on the tensor cores,
over K7's unit table) and K2 (flash dQ on the tensor cores), against the
plain versions and the JAX package on the CPU.

* K8's chunk-and-sum arithmetic (``sparse_dq_chunked_plain``: one fp32 dQ
  partial per chunk of ``build_fwd_units``, summed in chunk order as
  ``sparse_dq_reduce_kernel`` sums them) on layouts whose global rows are
  split: against ``sparse_dq_plain`` at 1e-6 (the same products, summed in
  another order) and the Pallas ``_sparse_bwd`` in interpret mode at 5e-5
  (the JAX package's own bound between paths); blocks 8, 16, 24 and 64,
  causal or not; a dead row's dQ is exact zeros.
* The autograd hands K7's unit table (``fwd_units``) to the dQ kernel and
  K9's (``dkv_units``) to the dK/dV kernel.
* The card check that K8 keeps dS in fp32 (``test_torch_card.py``) can
  tell: on its inputs the plain dQ with fp32 dS, rounded once to the
  operand dtype, stays within a third of its bound, and the plain dQ with
  dS rounded to the operand dtype (K2's rule) lies past it.
* ``sparse_dq_kernel`` and ``flash_dq_kernel`` reject CPU tensors, and
  ``sparse_dq_kernel`` a unit table that is not this layout's row table at
  this block, before any library is built or any count moves.

In fp32 but for that check, inputs made with numpy from a seed.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import pallas_block_sparse as jax_pbs
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _heavy_rows_layout_h():
    """A local window plus two global q blocks (rows 0 and 5 list every key
    block, past the cap) and a q block whose every listed block is causally
    dead (row 2 lists only block 9)."""
    n = 16
    layout = np.zeros((n, n), bool)
    for i in range(n):
        layout[i, max(0, i - 1): i + 1] = True
    layout[0] = layout[5] = True
    layout[2] = False
    layout[2, 9] = True
    return layout


CASES = {  # name: (layout [nq, nk], block, causal, T)
    "longformer blk=16": (lambda: sc.BSLongformerSparsityConfig(num_heads=1, block=16).make_layout(256)[0], 16,
                          False, 256),
    "longformer blk=16 causal": (lambda: sc.BSLongformerSparsityConfig(num_heads=1, block=16).make_layout(256)[0],
                                 16, True, 256),
    "bigbird blk=24": (lambda: sc.BigBirdSparsityConfig(num_heads=1, block=24).make_layout(384)[0], 24, False, 384),
    "bigbird blk=8 causal": (lambda: sc.BigBirdSparsityConfig(num_heads=1, block=8).make_layout(128)[0], 8, True,
                             128),
    "heavy rows blk=8 causal": (_heavy_rows_layout_h, 8, True, 128),
    "heavy rows blk=64 causal": (_heavy_rows_layout_h, 64, True, 1024),
}
SCALE = 0.125


def _case(name, BN=2, D=64):
    """The layout, its block, causal flag, K7's units, the row tables and
    q, k, v, dO with the plain forward's O and LSE and delta, as torch
    tensors on the CPU and numpy arrays."""
    make, block, causal, T = CASES[name]
    layout_h = make()
    units = bs.build_fwd_units(layout_h, block)
    assert units.n_slots > 0  # the case splits a q block
    rs = np.random.RandomState(17)
    arrs = [rs.randn(BN, T, D).astype(np.float32) for _ in range(4)]
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    row_idx, row_cnt, _, _ = bs.block_tables(layout_h, "cpu")
    o, lse = bs.sparse_fwd_plain(q, k, v, row_idx, row_cnt, SCALE, block, causal)
    delta = bs.sparse_delta(o, do)
    return layout_h, block, causal, units, (row_idx, row_cnt), (q, k, v, do, o, lse, delta), arrs


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunked_dq_matches_plain(name):
    """The chunk-and-sum dQ equals the unchunked plain K8 to 1e-6 in fp32;
    a dead row's dQ is exact zeros in both."""
    layout_h, block, causal, units, (row_idx, row_cnt), (q, k, v, do, o, lse, delta), _ = _case(name)
    dq = bs.sparse_dq_chunked_plain(q, k, v, do, lse, delta, row_idx, row_cnt, units, SCALE, block, causal)
    ref = bs.sparse_dq_plain(q, k, v, do, lse, delta, row_idx, row_cnt, SCALE, block, causal)
    assert dq.dtype == torch.float32 and dq.shape == q.shape
    np.testing.assert_allclose(dq.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    dead = lse.numpy() <= bs.NEG_INF / 2
    if name.startswith("heavy rows"):
        assert dead.any()
    assert (dq.numpy()[dead] == 0).all() and (ref.numpy()[dead] == 0).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunked_dq_matches_pallas_interpret(name):
    """JAX's ``_sparse_bwd`` (the Pallas K8 in interpret mode) on the same O
    and LSE is the outer reference for the chunk-and-sum dQ (5e-5)."""
    layout_h, block, causal, units, (row_idx, row_cnt), (q, k, v, do, o, lse, delta), arrs = _case(name, BN=1)
    dq = bs.sparse_dq_chunked_plain(q, k, v, do, lse, delta, row_idx, row_cnt, units, SCALE, block, causal)
    ri, rc, ci, cc = (jnp.asarray(t) for t in bs.build_block_tables(layout_h))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrs)
    res = (jq, jk, jv, jnp.asarray(o.numpy()), jnp.asarray(lse.numpy()), ri, rc, ci, cc)
    jdq, _, _ = jax_pbs._sparse_bwd(res, jdo, SCALE, block, causal, True)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), rtol=5e-5, atol=5e-5)
    dead = lse.numpy() <= bs.NEG_INF / 2
    assert (np.asarray(jdq)[dead] == 0).all() and (dq.numpy()[dead] == 0).all()


def test_fwd_units_serve_k7_and_k8_and_dkv_units_k9():
    """One row table for K7 and K8 (``side`` "rows"), K9's own column table
    (``side`` "cols")."""
    layout_h = _heavy_rows_layout_h()
    assert bs.build_fwd_units(layout_h, 16).side == "rows"
    assert bs.build_dkv_units(layout_h, 16).side == "cols"
    assert bs.fwd_units(layout_h, 16, "cpu").side == "rows"


def test_autograd_hands_fwd_units_to_the_dq_kernel(monkeypatch):
    """With the kernel path forced on CPU tensors (each kernel entry swapped
    for a recorder that returns the plain version), the backward gives the
    dQ launch K7's unit table of the layout, ``fwd_units(layout, block,
    device)`` itself, and the dK/dV launch K9's; the gradients equal the
    plain path's."""
    layout = sc.BSLongformerSparsityConfig(num_heads=2, block=16).make_layout(128)[:1]
    seen = {}

    def fwd(q, k, v, row_idx, row_cnt, units, *args):
        seen["fwd"] = units
        return bs.sparse_fwd_plain(q, k, v, row_idx, row_cnt, *args)

    def dq(q, k, v, do, lse, delta, row_idx, row_cnt, units, *args):
        seen["dq"] = units
        return bs.sparse_dq_plain(q, k, v, do, lse, delta, row_idx, row_cnt, *args)

    def dkv(q, k, v, do, lse, delta, col_idx, col_cnt, units, *args):
        seen["dkv"] = units
        return bs.sparse_dkv_plain(q, k, v, do, lse, delta, col_idx, col_cnt, *args)

    rs = np.random.RandomState(3)
    base = [torch.from_numpy(rs.randn(1, 2, 128, 64).astype(np.float32)) for _ in range(4)]
    grads = {}
    for forced in (True, False):
        with monkeypatch.context() as m:
            if forced:
                m.setattr(bs, "_use_kernel", lambda x, impl: True)
                m.setattr(bs, "sparse_fwd_kernel", fwd)
                m.setattr(bs, "sparse_dq_kernel", dq)
                m.setattr(bs, "sparse_dkv_kernel", dkv)
            q, k, v = (t.clone().requires_grad_(True) for t in base[:3])
            bs.fused_block_sparse_attention(q, k, v, layout, 16, causal=True).backward(base[3])
            grads[forced] = [t.grad for t in (q, k, v)]
    assert seen["dq"] is bs.fwd_units(layout[0], 16, "cpu") and seen["fwd"] is seen["dq"]
    assert seen["dkv"] is bs.dkv_units(layout[0], 16, "cpu")
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)


def test_dq_kernels_reject_cpu_tensors_and_wrong_unit_tables():
    """``sparse_dq_kernel`` raises on a unit table that is not this layout's
    row table at this block (K9's column table, another block, none) and on
    CPU tensors; ``flash_dq_kernel`` raises on CPU tensors. No count moves."""
    layout_h = _heavy_rows_layout_h()
    q = torch.zeros(2, 256, 64)
    lse = torch.zeros(2, 256)
    row_idx, row_cnt, _, _ = bs.block_tables(layout_h, "cpu")
    counts = (bs.launches_dq, bs.launches_dq_tc, fa.launches_dq, fa.launches_dq_tc)
    for wrong in (bs.dkv_units(layout_h, 16, "cpu"), bs.fwd_units(layout_h, 8, "cpu"), None):
        with pytest.raises(ValueError, match="unit tables"):
            bs.sparse_dq_kernel(q, q, q, q, lse, lse, row_idx, row_cnt, wrong, SCALE, 16, False)
    with pytest.raises(ValueError, match="CUDA"):
        bs.sparse_dq_kernel(q, q, q, q, lse, lse, row_idx, row_cnt, bs.fwd_units(layout_h, 16, "cpu"), SCALE, 16,
                            False)
    fq = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_dq_kernel(fq, fq, fq, fq, torch.zeros(2, 64), torch.zeros(2, 64))
    assert (bs.launches_dq, bs.launches_dq_tc, fa.launches_dq, fa.launches_dq_tc) == counts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("block", [16, 64])
def test_ds_cancel_case_tells_fp32_ds_from_rounded_ds(block, dtype):
    from test_torch_card import DS_FP32_TOL, _ds_cancel_case

    n = 16 if block == 16 else 8
    layout_h = np.ones((n, n), np.int64)
    row_idx, row_cnt, _, _ = bs.block_tables(layout_h, "cpu")
    q, k, v, do = _ds_cancel_case(np.random.RandomState(block), 3, n * block, 64, dtype, "cpu")
    args = (0.125, block, False)
    f = [t.float() for t in (q, k, v, do)]
    o, lse = bs.sparse_fwd_plain(*f[:3], row_idx, row_cnt, *args)
    delta = bs.sparse_delta(o, f[3])
    ref = bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args)
    rounded_out = ref.to(dtype).float()
    foil = bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args, ds_dtype=dtype)
    scale = ref.abs().max().item()
    assert (rounded_out - ref).abs().max().item() / scale <= DS_FP32_TOL[dtype] / 3
    assert (foil - ref).abs().max().item() / scale > 2 * DS_FP32_TOL[dtype]
