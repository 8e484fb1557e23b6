"""The port's block-sparse attention against the JAX package's.

``deepspeed_tpu_torch/ops/sparse_attention/`` against
``deepspeed_tpu/ops/sparse_attention/`` on the CPU, at the sizes of the JAX
package's own tests (B=2, NH=2, D=64, blocks of 16, T=64/128; fp32):

* every ``SparsityConfig`` class builds the same layout element for element,
  and raises the same ``ValueError``s;
* ``build_block_tables`` gives the same tables;
* the plain K7 against ``_sparse_fwd(..., interpret=True)`` (O and LSE within
  2e-5), the plain K8 and K9 against ``_sparse_bwd(..., interpret=True)``
  (within 5e-5), and the autograd path against ``jax.grad`` of
  ``pallas_block_sparse_attention`` (within 5e-5): fp32 sums in another order;
* the dead-rows layout gives exact zeros in O and dQ;
* the dense-gather emulation against JAX's ``block_sparse_attention`` with a
  ``key_padding_mask``, and ``SparseSelfAttention`` (shared and per-head
  layouts) and ``BertSparseSelfAttention`` (hidden 128, 2 heads, T=64)
  against the JAX modules: outputs, and the gradients with respect to ``wq``,
  ``wk`` and ``wv``;
* the modules dispatch by JAX's argument rule, and no kernel is launched on
  the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX
references that run Pallas in interpret mode (three backward passes, each a
few seconds on one core) are computed once per module. The CUDA kernels are
held against these plain functions on the card (``tests/test_torch_card.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import pallas_block_sparse as jax_pbs
from deepspeed_tpu.ops.sparse_attention import sparse_self_attention as jax_ssa
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jax_sc
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ssa
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc

B, NH, D, BLK = 2, 2, 64, 16
SCALE = 1.0 / np.sqrt(D)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    """On the CPU every path takes the plain versions: the kernel counters
    stay where they were."""
    before = (bs.launches_fwd, bs.launches_dq, bs.launches_dkv)
    yield
    assert (bs.launches_fwd, bs.launches_dq, bs.launches_dkv) == before


def _qkv(T, seed, n=3, nh=NH):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, nh, T, D).astype(np.float32) for _ in range(n)]


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)  # a writable copy


def _tables(layout_h):
    return [jnp.asarray(t) for t in jax_pbs.build_block_tables(layout_h)]


# --- layouts ---------------------------------------------------------------------
LAYOUTS = {
    "dense": ("DenseSparsityConfig", dict(num_heads=2, block=8), 64),
    "fixed": ("FixedSparsityConfig", dict(num_heads=4, block=16), 256),
    "fixed_per_head_patterns": ("FixedSparsityConfig", dict(num_heads=4, block=16, different_layout_per_head=True,
                                                            num_local_blocks=4, num_global_blocks=1,
                                                            num_different_global_patterns=3), 256),
    "fixed_unidirectional": ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=2,
                                                         attention="unidirectional"), 128),
    "fixed_horizontal_global": ("FixedSparsityConfig", dict(num_heads=2, block=16, num_global_blocks=2,
                                                            horizontal_global_attention=True), 256),
    "variable": ("VariableSparsityConfig", dict(num_heads=2, block=16), 256),
    "variable_random_windows": ("VariableSparsityConfig", dict(num_heads=3, block=16, different_layout_per_head=True,
                                                               num_random_blocks=2, local_window_blocks=[1, 2, 3],
                                                               global_block_indices=[0, 5],
                                                               global_block_end_indices=[2, 7]), 256),
    "variable_unidirectional_horizontal": ("VariableSparsityConfig", dict(
        num_heads=2, block=16, num_random_blocks=1, attention="unidirectional", horizontal_global_attention=True,
        global_block_indices=[1, 40]), 256),
    "bigbird": ("BigBirdSparsityConfig", dict(num_heads=2, block=16), 256),
    "bigbird_per_head_random": ("BigBirdSparsityConfig", dict(num_heads=4, block=32, different_layout_per_head=True,
                                                              num_random_blocks=2, num_sliding_window_blocks=5,
                                                              num_global_blocks=2), 1024),
    "bigbird_unidirectional": ("BigBirdSparsityConfig", dict(num_heads=2, block=16, attention="unidirectional"), 256),
    "longformer": ("BSLongformerSparsityConfig", dict(num_heads=2, block=64), 2048),
    "longformer_globals": ("BSLongformerSparsityConfig", dict(num_heads=2, block=16, global_block_indices=[0, 6],
                                                              global_block_end_indices=[2, 9],
                                                              attention="unidirectional"), 256),
    "local_unidirectional": ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=16), 256),
    "local_bidirectional": ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=16,
                                                                     num_sliding_window_blocks=5,
                                                                     attention="bidirectional"), 256),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layouts_match_jax(name):
    cls, kw, T = LAYOUTS[name]
    a = getattr(jax_sc, cls)(**kw).make_layout(T)
    b = getattr(sc, cls)(**kw).make_layout(T)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


ERRORS = {
    "local_not_multiple_of_global": ("FixedSparsityConfig", dict(num_heads=2, num_local_blocks=3,
                                                                 num_global_blocks=2), None),
    "bad_attention": ("FixedSparsityConfig", dict(num_heads=2, attention="causal"), None),
    "horizontal_unidirectional": ("FixedSparsityConfig", dict(num_heads=2, attention="unidirectional",
                                                              horizontal_global_attention=True), None),
    "global_ends_misaligned": ("VariableSparsityConfig", dict(num_heads=2, global_block_indices=[0, 3],
                                                              global_block_end_indices=[1]), None),
    "seq_not_divisible": ("DenseSparsityConfig", dict(num_heads=1, block=16), 70),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_config_errors_match_jax(name):
    cls, kw, T = ERRORS[name]
    for module in (jax_sc, sc):
        with pytest.raises(ValueError) as err:
            getattr(module, cls)(**kw).make_layout(T)
        if module is jax_sc:
            message = str(err.value)
    assert str(err.value) == message


@pytest.mark.parametrize("name", ["random_with_empty_rows", "fixed", "bigbird"])
def test_build_block_tables_match_jax(name):
    if name == "random_with_empty_rows":
        layout_h = np.random.RandomState(4).rand(9, 9) < 0.3
        layout_h[2] = False
        layout_h[:, 5] = False
    else:
        cls = {"fixed": sc.FixedSparsityConfig, "bigbird": sc.BigBirdSparsityConfig}[name]
        layout_h = cls(num_heads=1, block=16).make_layout(512)[0]
    for a, b in zip(jax_pbs.build_block_tables(layout_h), bs.build_block_tables(layout_h)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_block_tables_kept_per_layout_and_device():
    layout_h = sc.FixedSparsityConfig(num_heads=1, block=16).make_layout(256)[0]
    first = bs.block_tables(layout_h, "cpu")
    again = bs.block_tables(layout_h.astype(np.int64), torch.device("cpu"))
    assert all(a is b for a, b in zip(first, again))
    assert all(t.dtype == torch.int32 for t in first)
    other = bs.block_tables(np.eye(16, dtype=bool), "cpu")
    assert other[0] is not first[0]


# --- K9's unit tables --------------------------------------------------------------
def _dead_rows_layout_h():
    """tests/unit/ops/test_pallas_block_sparse.py:136-171."""
    layout = np.zeros((4, 4), bool)
    layout[0, 3] = layout[1, 1] = layout[2, 2] = layout[2, 0] = layout[3, 3] = True
    return layout


def _empty_columns_layout_h():
    layout_h = np.random.RandomState(4).rand(9, 9) < 0.3
    layout_h[2] = False
    layout_h[:, 5] = False
    return layout_h


DKV_UNIT_CASES = {  # name: (layout [nq, nk], block)
    "fixed blk=16": (lambda: sc.FixedSparsityConfig(num_heads=1, block=16).make_layout(256)[0], 16),
    "fixed blk=8": (lambda: sc.FixedSparsityConfig(num_heads=1, block=8).make_layout(256)[0], 8),
    "bigbird blk=16": (lambda: sc.BigBirdSparsityConfig(num_heads=1, block=16).make_layout(256)[0], 16),
    "bigbird blk=128": (lambda: sc.BigBirdSparsityConfig(num_heads=1, block=128).make_layout(2048)[0], 128),
    "longformer blk=64": (lambda: sc.BSLongformerSparsityConfig(num_heads=1, block=64).make_layout(2048)[0], 64),
    "longformer blk=16 global": (lambda: sc.BSLongformerSparsityConfig(num_heads=1, block=16).make_layout(1024)[0],
                                 16),
    "dead rows blk=16": (_dead_rows_layout_h, 16),
    "empty columns blk=24": (_empty_columns_layout_h, 24),
}


@pytest.mark.parametrize("name", sorted(DKV_UNIT_CASES))
def test_dkv_units_cover_each_pair_once_capped_heaviest_first(name):
    """Every (key tile, listed q block) pair of ``build_block_tables``'s
    column lists lies in exactly one unit chunk, every key tile has a unit
    (an empty list a chunk of length 0), a unit's key tiles share its list,
    no chunk is longer than the cap, units run longest first, and a split
    key block's chunks own consecutive workspace slots."""
    make, block = DKV_UNIT_CASES[name]
    layout_h = make()
    _, _, col_idx, col_cnt = bs.build_block_tables(layout_h)
    u = bs.build_dkv_units(layout_h, block)
    assert u.units.dtype == np.int32 and u.units.shape[1] == 3 + 2 * bs.UNIT_WARPS
    assert u.cap == bs.list_cap(col_cnt) and u.block == block and u.n_blocks == col_cnt.shape[0]
    lens = u.units[:, 2]
    assert lens.max() <= u.cap and np.all(np.diff(lens) <= 0)
    subs = -(-block // bs.UNIT_TILE)
    want = {(kb * block + bs.UNIT_TILE * s, int(qb)) for kb in range(col_cnt.shape[0]) for s in range(subs)
            for qb in col_idx[kb, : col_cnt[kb]]}
    seen, tiles_seen, slots_seen = {}, set(), []
    chunks_of = {int(kb): (int(s0), int(n)) for kb, s0, n in u.reduce}
    for row in u.units:
        list_kb, start, length = (int(x) for x in row[:3])
        qbs = col_idx[list_kb, start: start + length]
        assert start + length <= col_cnt[list_kb]
        tiles, slots = row[3: 3 + bs.UNIT_WARPS], row[3 + bs.UNIT_WARPS:]
        assert (tiles >= 0).any() and np.all(np.diff(np.flatnonzero(tiles >= 0)) == 1)
        for tile, slot in zip(tiles, slots):
            if tile < 0:
                assert slot == -1
                continue
            kb = int(tile) // block
            assert np.array_equal(col_idx[kb, : col_cnt[kb]], col_idx[list_kb, : col_cnt[list_kb]])
            tiles_seen.add(int(tile))
            if kb in chunks_of:
                s0, n = chunks_of[kb]
                assert s0 <= slot < s0 + n
                slots_seen.append((int(tile), int(slot)))
            else:
                assert slot == -1 and length == col_cnt[kb]
            for qb in qbs:
                seen[(int(tile), int(qb))] = seen.get((int(tile), int(qb)), 0) + 1
    assert set(seen) == want and set(seen.values()) <= {1}
    assert tiles_seen == {kb * block + bs.UNIT_TILE * s for kb in range(col_cnt.shape[0]) for s in range(subs)}
    assert len(set(slots_seen)) == len(slots_seen)  # one chunk a slot for each key tile
    assert u.n_slots == sum(n for _, n in chunks_of.values())
    if name in ("fixed blk=16", "longformer blk=16 global"):
        assert u.n_slots > 0  # lists longer than the cap are split


def test_dkv_units_kept_per_layout_block_and_device():
    layout_h = sc.FixedSparsityConfig(num_heads=1, block=16).make_layout(256)[0]
    first = bs.dkv_units(layout_h, 16, "cpu")
    again = bs.dkv_units(layout_h.astype(np.int64), 16, torch.device("cpu"))
    assert again is first and first.units.dtype == torch.int32 and first.reduce.dtype == torch.int32
    assert np.array_equal(first.units.numpy(), bs.build_dkv_units(layout_h, 16).units)
    assert bs.dkv_units(layout_h, 8, "cpu") is not first


# --- K7-K9 against the Pallas kernels ---------------------------------------------
@pytest.fixture(scope="module")
def kernel_refs():
    """One causal Fixed case at T=128: the Pallas forward, and the Pallas
    backward on its residuals (interpret mode)."""
    T = 128
    layout_h = sc.FixedSparsityConfig(num_heads=NH, block=BLK, attention="unidirectional").make_layout(T)[0]
    q, k, v, do = (x.reshape(B * NH, T, D) for x in _qkv(T, seed=0, n=4))
    ri, rc, ci, cc = _tables(layout_h)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jax_pbs._sparse_fwd(jq, jk, jv, ri, rc, SCALE, BLK, True, True)
    grads = jax_pbs._sparse_bwd((jq, jk, jv, o, lse, ri, rc, ci, cc), jdo, SCALE, BLK, True, True)
    return dict(layout_h=layout_h, inputs=(q, k, v, do), o=np.asarray(o), lse=np.asarray(lse),
                grads=[np.asarray(g) for g in grads])


def test_fwd_plain_matches_pallas(kernel_refs):
    q, k, v, _ = kernel_refs["inputs"]
    row_idx, row_cnt, _, _ = bs.block_tables(kernel_refs["layout_h"], "cpu")
    o, lse = bs.sparse_fwd_plain(_t(q), _t(k), _t(v), row_idx, row_cnt, SCALE, BLK, True)
    assert o.dtype == torch.float32 and lse.shape == (B * NH, 128) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), kernel_refs["o"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), kernel_refs["lse"], rtol=2e-5, atol=2e-5)


def test_bwd_plain_matches_pallas(kernel_refs):
    """The plain K8 and K9 on the Pallas forward's O and LSE, with Δ from
    ``sparse_delta`` (JAX computes it the same way outside its kernels)."""
    q, k, v, do = (_t(x) for x in kernel_refs["inputs"])
    row_idx, row_cnt, col_idx, col_cnt = bs.block_tables(kernel_refs["layout_h"], "cpu")
    lse = _t(kernel_refs["lse"])
    delta = bs.sparse_delta(_t(kernel_refs["o"]), do)
    dq = bs.sparse_dq_plain(q, k, v, do, lse, delta, row_idx, row_cnt, SCALE, BLK, True)
    dk, dv = bs.sparse_dkv_plain(q, k, v, do, lse, delta, col_idx, col_cnt, SCALE, BLK, True)
    for got, ref, name in zip((dq, dk, dv), kernel_refs["grads"], ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), ref, rtol=5e-5, atol=5e-5, err_msg=name)


def test_autograd_matches_jax_grad():
    """``fused_block_sparse_attention`` (the autograd Function over the
    plain versions on the CPU) against ``jax.grad`` of
    ``pallas_block_sparse_attention`` in interpret mode: a bidirectional
    BigBird layout shared by the heads."""
    T = 64
    layout = sc.BigBirdSparsityConfig(num_heads=NH, block=BLK).make_layout(T)[:1]
    q, k, v = _qkv(T, seed=3)

    def jax_loss(q, k, v):
        o = jax_pbs.pallas_block_sparse_attention(q, k, v, layout, BLK, causal=False, interpret=True)
        return jnp.sum(o * jnp.cos(o)), o

    (_, o_ref), g_ref = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x, grad=True) for x in (q, k, v))
    o = bs.fused_block_sparse_attention(tq, tk, tv, layout, BLK, causal=False)
    (o * o.cos()).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), rtol=2e-5, atol=2e-5)
    for t, ref, name in zip((tq, tk, tv), g_ref, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=5e-5, atol=5e-5, err_msg=f"d{name}")


def _dense_oracle(q, k, v, layout, block, causal):
    """Dense masked softmax over the layout's live pairs (fp32 torch), rows
    with no live key zero."""
    T = q.shape[2]
    lay = np.repeat(layout, q.shape[1], axis=0) if layout.shape[0] == 1 else layout
    elem = np.kron(lay.astype(bool), np.ones((block, block), bool))
    if causal:
        elem &= np.tril(np.ones((T, T), bool))[None]
    mask = torch.from_numpy(elem)[None]
    s = (torch.einsum("bhqd,bhkd->bhqk", q, k) * SCALE).masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1) * mask.any(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def test_dead_rows_exact_zeros():
    """The layout of ``tests/unit/ops/test_pallas_block_sparse.py``: q block
    0 lists only the future kv block 3 under the causal mask, so its rows
    have no live score. O and dQ are exact zeros there, LSE is NEG_INF, and
    the rest matches a dense oracle (O 2e-5, gradients 5e-5)."""
    T = 64
    layout = np.zeros((1, 4, 4), bool)
    layout[0, 0, 3] = layout[0, 1, 1] = layout[0, 2, 2] = layout[0, 2, 0] = layout[0, 3, 3] = True
    q, k, v = _qkv(T, seed=7)
    tq, tk, tv = (_t(x, grad=True) for x in (q, k, v))
    o = bs.fused_block_sparse_attention(tq, tk, tv, layout, BLK, causal=True)
    (o * o.cos()).sum().backward()
    assert (o[:, :, :BLK] == 0).all() and (tq.grad[:, :, :BLK] == 0).all()
    row_idx, row_cnt, _, _ = bs.block_tables(layout[0], "cpu")
    _, lse = bs.sparse_fwd_plain(tq.detach().reshape(B * NH, T, D), tk.detach().reshape(B * NH, T, D),
                                 tv.detach().reshape(B * NH, T, D), row_idx, row_cnt, SCALE, BLK, True)
    assert (lse[:, :BLK] == bs.NEG_INF).all() and (lse[:, BLK:] > bs.NEG_INF).all()
    rq, rk, rv = (_t(x, grad=True) for x in (q, k, v))
    ref = _dense_oracle(rq, rk, rv, layout, BLK, True)
    (ref * ref.cos()).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), ref.detach().numpy(), rtol=2e-5, atol=2e-5)
    for got, want, name in ((tq, rq, "q"), (tk, rk, "k"), (tv, rv, "v")):
        assert torch.isfinite(got.grad).all()
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(), rtol=5e-5, atol=5e-5, err_msg=f"d{name}")


# --- the emulation and the modules ----------------------------------------------------
EMULATION_CASES = {
    "shared causal, padded tail": (128, "fixed_unidirectional", True, True),
    "per-head bidirectional, padded tail": (64, "bigbird_per_head", False, True),
    "shared bidirectional, no mask": (64, "fixed", False, False),
}


def _case_layout(name, T):
    if name == "fixed_unidirectional":
        return sc.FixedSparsityConfig(num_heads=NH, block=BLK, attention="unidirectional").make_layout(T)[:1]
    if name == "bigbird_per_head":
        return sc.BigBirdSparsityConfig(num_heads=NH, block=BLK, different_layout_per_head=True).make_layout(T)
    return sc.FixedSparsityConfig(num_heads=NH, block=BLK).make_layout(T)[:1]


def _padding_mask(T):
    mask = np.ones((B, T), bool)
    mask[0, T - 24:] = False
    mask[1, T - 7:] = False
    return mask


@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_emulation_matches_jax(case):
    """The dense-gather emulation against JAX's (XLA) at 2e-5."""
    T, layout_name, causal, padded = EMULATION_CASES[case]
    layout = _case_layout(layout_name, T)
    q, k, v = _qkv(T, seed=11)
    mask = _padding_mask(T) if padded else None
    ref = jax_ssa.block_sparse_attention(*(jnp.asarray(x) for x in (q, k, v)), layout, BLK, causal=causal,
                                         key_padding_mask=None if mask is None else jnp.asarray(mask))
    out = ssa.block_sparse_attention(_t(q), _t(k), _t(v), layout, BLK, causal=causal,
                                     key_padding_mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def _sparse_modules(name):
    if name == "shared":
        kw = dict(num_heads=NH, block=BLK, attention="unidirectional")
        return jax_ssa.SparseSelfAttention(jax_sc.FixedSparsityConfig(**kw)), \
            ssa.SparseSelfAttention(sc.FixedSparsityConfig(**kw)), 128
    kw = dict(num_heads=NH, block=BLK, different_layout_per_head=True, num_random_blocks=1)
    return jax_ssa.SparseSelfAttention(jax_sc.BigBirdSparsityConfig(**kw)), \
        ssa.SparseSelfAttention(sc.BigBirdSparsityConfig(**kw)), 64


@pytest.mark.parametrize("name", ["shared", "per_head"])
def test_sparse_self_attention_matches_jax(name):
    """Without a mask both modules take their fused path (JAX: the Pallas
    kernel in interpret mode, one call per head for per-head layouts)."""
    jax_mod, mod, T = _sparse_modules(name)
    q, k, v = _qkv(T, seed=12)
    ref = jax_mod(*(jnp.asarray(x) for x in (q, k, v)))
    out = mod(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_sparse_self_attention_padding_mask_matches_jax():
    """A float ``key_padding_mask`` (> 0 keeps) sends both modules to the
    emulation."""
    jax_mod, mod, T = _sparse_modules("shared")
    q, k, v = _qkv(T, seed=13)
    mask = _padding_mask(T).astype(np.float32)
    ref = jax_mod(*(jnp.asarray(x) for x in (q, k, v)), key_padding_mask=jnp.asarray(mask))
    out = mod(_t(q), _t(k), _t(v), key_padding_mask=_t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_bert_sparse_self_attention_matches_jax():
    """Hidden 128, 2 heads of 64, T=64, the default ``FixedDefault`` layout:
    the output within 2e-5 and the gradients of ``wq``, ``wk`` and ``wv``
    within 5e-5 of their largest magnitude (fp32 sums in another order)."""
    H, T = 128, 64
    config = types.SimpleNamespace(num_attention_heads=2, hidden_size=H)
    rs = np.random.RandomState(21)
    hidden = rs.randn(B, T, H).astype(np.float32)
    ws = [(0.1 * rs.randn(H, H)).astype(np.float32) for _ in range(3)]
    jax_mod = jax_ssa.BertSparseSelfAttention(config)

    def jax_loss(wq, wk, wv):
        out = jax_mod(jnp.asarray(hidden), wq, wk, wv)
        return jnp.sum(out * jnp.cos(out)), out

    (_, ref), g_ref = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(*(jnp.asarray(w) for w in ws))
    tw = [_t(w, grad=True) for w in ws]
    out = ssa.BertSparseSelfAttention(config)(_t(hidden), *tw)
    (out * out.cos()).sum().backward()
    assert out.shape == (B, T, H)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    for t, r, name in zip(tw, g_ref, ("wq", "wk", "wv")):
        r = np.asarray(r)
        err = np.abs(t.grad.numpy() - r).max() / np.abs(r).max()
        assert err <= 5e-5, (name, err)


DISPATCH = {  # name: (block, T, key padding mask?, fused?)
    "aligned, no mask": (16, 64, False, True),
    "padding mask": (16, 64, True, False),
    "block not a multiple of 8": (12, 48, False, False),
}


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_dispatch_follows_jax_rule(name, monkeypatch):
    """``SparseSelfAttention`` takes the fused path exactly when JAX does
    (``sparse_self_attention.py:156``: no mask, ``T % block == 0``,
    ``block % 8 == 0``), decided from the arguments."""
    block, T, padded, fused = DISPATCH[name]
    calls = []
    for fn in ("fused_block_sparse_attention", "block_sparse_attention"):
        real = getattr(ssa, fn)
        monkeypatch.setattr(ssa, fn, lambda *a, _fn=fn, _real=real, **kw: calls.append(_fn) or _real(*a, **kw))
    mod = ssa.SparseSelfAttention(sc.FixedSparsityConfig(num_heads=NH, block=block, num_local_blocks=2))
    q, k, v = _qkv(T, seed=14)
    mask = _t(_padding_mask(T)) if padded else None
    out = mod(_t(q), _t(k), _t(v), key_padding_mask=mask)
    assert out.shape == (B, NH, T, D) and torch.isfinite(out).all()
    assert calls == ["fused_block_sparse_attention" if fused else "block_sparse_attention"]


@pytest.mark.parametrize("block,T", [(16, 72), (12, 48)])
def test_fused_rejects_what_jax_rejects(block, T):
    q = np.zeros((1, 1, T, D), np.float32)
    layout = np.ones((1, T // block, T // block), bool)
    with pytest.raises(ValueError) as jax_err:
        jax_pbs.pallas_block_sparse_attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), layout, block,
                                              interpret=True)
    with pytest.raises(ValueError) as err:
        bs.fused_block_sparse_attention(_t(q), _t(q), _t(q), layout, block)
    assert str(err.value) == str(jax_err.value)


def test_unknown_impl_rejected():
    q = torch.zeros(1, 1, 32, D)
    with pytest.raises(ValueError, match="impl"):
        bs.fused_block_sparse_attention(q, q, q, np.ones((1, 2, 2), bool), 16, impl="triton")
