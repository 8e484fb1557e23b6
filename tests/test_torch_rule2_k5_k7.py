"""The host-side tables and the split arithmetic of the redesigned K7
(block-sparse forward on the tensor cores) and K5 (paged decode as
split-KV), against the plain versions and the JAX package on the CPU.

* ``build_fwd_units`` (pure numpy): every (q tile, listed key block) pair
  lies in exactly one unit chunk, every q tile has a unit, a unit's tiles
  share one list, no chunk passes the cap, units run longest first, a split
  q block's chunks own consecutive workspace slots; at the main shape
  (``FixedSparsityConfig(16, block=16)``, T=4096) 64 units of 4 tiles a
  head and no split; ``fwd_units`` is kept per (layout, block, device).
* K7's chunk-and-merge arithmetic (``sparse_fwd_chunked_plain``) on layouts
  whose global rows are split: against ``sparse_fwd_plain`` at 1e-6 (the
  same exponentials, merged in another order) and the Pallas ``_sparse_fwd``
  in interpret mode at 2e-5 (the JAX package's own bound between paths);
  dead rows stay exact zeros with LSE = NEG_INF.
* K5's split arithmetic (``paged_split_partials_plain`` +
  ``paged_combine_plain``, the CUDA combine's formula) against
  ``paged_decode_attention_plain`` at 1e-6 and JAX's
  ``paged_decode_attention`` (Pallas in interpret mode) at 2e-5, over
  kv_len 0, 1, on a split boundary and one past it, MAXP·P and past it
  (clamped), with -1 sentinels in the tables.

All in fp32, inputs made with numpy from a seed.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import pallas_block_sparse as jax_pbs
from deepspeed_tpu.ops.transformer import paged_attention as jax_pa
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
from deepspeed_tpu_torch.ops.transformer import decode_attention as da


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- K7's unit tables ---------------------------------------------------------------
def _dead_rows_layout_h():
    """tests/unit/ops/test_pallas_block_sparse.py:136-171."""
    layout = np.zeros((4, 4), bool)
    layout[0, 3] = layout[1, 1] = layout[2, 2] = layout[2, 0] = layout[3, 3] = True
    return layout


def _empty_rows_layout_h():
    layout_h = np.random.RandomState(4).rand(9, 9) < 0.3
    layout_h[2] = False
    layout_h[:, 5] = False
    return layout_h


FWD_UNIT_CASES = {  # name: (layout [nq, nk], block)
    "fixed blk=16": (lambda: sc.FixedSparsityConfig(num_heads=1, block=16).make_layout(256)[0], 16),
    "fixed blk=8": (lambda: sc.FixedSparsityConfig(num_heads=1, block=8).make_layout(256)[0], 8),
    "bigbird blk=24": (lambda: sc.BigBirdSparsityConfig(num_heads=1, block=24).make_layout(480)[0], 24),
    "bigbird blk=128": (lambda: sc.BigBirdSparsityConfig(num_heads=1, block=128).make_layout(2048)[0], 128),
    "longformer blk=64": (lambda: sc.BSLongformerSparsityConfig(num_heads=1, block=64).make_layout(2048)[0], 64),
    "longformer blk=16 global": (lambda: sc.BSLongformerSparsityConfig(num_heads=1, block=16).make_layout(1024)[0],
                                 16),
    "dead rows blk=16": (_dead_rows_layout_h, 16),
    "empty rows blk=24": (_empty_rows_layout_h, 24),
}


@pytest.mark.parametrize("name", sorted(FWD_UNIT_CASES))
def test_fwd_units_cover_each_pair_once_capped_heaviest_first(name):
    """Every (q tile, listed key block) pair of the row lists lies in exactly
    one unit chunk, every q tile has a unit (an empty list a chunk of length
    0), a unit's q tiles share its list, no chunk is longer than the cap,
    units run longest first, and a split q block's chunks own consecutive
    workspace slots."""
    make, block = FWD_UNIT_CASES[name]
    layout_h = make()
    row_idx, row_cnt, _, _ = bs.build_block_tables(layout_h)
    u = bs.build_fwd_units(layout_h, block)
    assert u.units.dtype == np.int32 and u.units.shape[1] == 3 + 2 * bs.UNIT_WARPS
    assert u.cap == bs.list_cap(row_cnt) and u.block == block and u.n_blocks == row_cnt.shape[0]
    lens = u.units[:, 2]
    assert lens.max() <= u.cap and np.all(np.diff(lens) <= 0)
    subs = -(-block // bs.UNIT_TILE)
    tiles_all = {qb * block + bs.UNIT_TILE * s for qb in range(row_cnt.shape[0]) for s in range(subs)}
    want = {(t, int(kb)) for t in tiles_all for kb in row_idx[t // block, : row_cnt[t // block]]}
    seen, tiles_seen, slots_seen = {}, set(), []
    chunks_of = {int(qb): (int(s0), int(n)) for qb, s0, n in u.reduce}
    for row in u.units:
        list_qb, start, length = (int(x) for x in row[:3])
        kbs = row_idx[list_qb, start: start + length]
        assert start + length <= row_cnt[list_qb]
        tiles, slots = row[3: 3 + bs.UNIT_WARPS], row[3 + bs.UNIT_WARPS:]
        assert (tiles >= 0).any() and np.all(np.diff(np.flatnonzero(tiles >= 0)) == 1)
        for tile, slot in zip(tiles, slots):
            if tile < 0:
                assert slot == -1
                continue
            qb = int(tile) // block
            assert np.array_equal(row_idx[qb, : row_cnt[qb]], row_idx[list_qb, : row_cnt[list_qb]])
            tiles_seen.add(int(tile))
            if qb in chunks_of:
                s0, n = chunks_of[qb]
                assert s0 <= slot < s0 + n
                slots_seen.append((int(tile), int(slot)))
            else:
                assert slot == -1 and length == row_cnt[qb]
            for kb in kbs:
                seen[(int(tile), int(kb))] = seen.get((int(tile), int(kb)), 0) + 1
    assert set(seen) == want and set(seen.values()) <= {1}
    assert tiles_seen == tiles_all
    assert len(set(slots_seen)) == len(slots_seen)  # one chunk a slot for each q tile
    assert u.n_slots == sum(n for _, n in chunks_of.values())
    if name == "longformer blk=16 global":
        assert u.n_slots > 0  # the global row lists every key block, past the cap


def test_fwd_units_at_the_main_shape():
    """``FixedSparsityConfig(num_heads=16, block=16)`` at T = 4096: every row
    lists 67 key blocks and the 256 q blocks form 64 groups of four with
    equal lists, so 64 units of 4 tiles (one q block a warp), none split."""
    layout_h = sc.FixedSparsityConfig(num_heads=16, block=16).make_layout(4096)[0]
    u = bs.build_fwd_units(layout_h, 16)
    assert u.units.shape == (64, 3 + 2 * bs.UNIT_WARPS)
    assert (u.units[:, 3: 3 + bs.UNIT_WARPS] >= 0).all() and (u.units[:, 2] == 67).all()
    assert u.n_slots == 0 and u.reduce.shape == (0, 3)


def test_fwd_units_kept_per_layout_block_and_device():
    layout_h = sc.FixedSparsityConfig(num_heads=1, block=16).make_layout(256)[0]
    first = bs.fwd_units(layout_h, 16, "cpu")
    again = bs.fwd_units(layout_h.astype(np.int64), 16, torch.device("cpu"))
    assert again is first and first.units.dtype == torch.int32 and first.reduce.dtype == torch.int32
    assert np.array_equal(first.units.numpy(), bs.build_fwd_units(layout_h, 16).units)
    assert bs.fwd_units(layout_h, 8, "cpu") is not first
    assert bs.fwd_units(layout_h.T.copy(), 16, "cpu") is not first
    assert bs.dkv_units(layout_h, 16, "cpu") is not first  # K9's table of the same layout is its own


# --- K7's chunk-and-merge arithmetic -------------------------------------------------
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


CHUNK_CASES = {  # name: (layout [nq, nk], block, causal, T)
    "longformer blk=16": (lambda: sc.BSLongformerSparsityConfig(num_heads=1, block=16).make_layout(256)[0], 16,
                          False, 256),
    "longformer blk=16 causal": (lambda: sc.BSLongformerSparsityConfig(num_heads=1, block=16).make_layout(256)[0],
                                 16, True, 256),
    "heavy rows blk=8": (_heavy_rows_layout_h, 8, False, 128),
    "heavy rows blk=8 causal": (_heavy_rows_layout_h, 8, True, 128),
}


@pytest.mark.parametrize("name", sorted(CHUNK_CASES))
def test_chunked_fwd_matches_plain_and_pallas(name):
    make, block, causal, T = CHUNK_CASES[name]
    layout_h = make()
    units = bs.build_fwd_units(layout_h, block)
    assert units.n_slots > 0  # the case splits a q block
    rs = np.random.RandomState(7)
    q, k, v = (rs.randn(4, T, 64).astype(np.float32) for _ in range(3))
    row_idx, row_cnt, _, _ = bs.block_tables(layout_h, "cpu")
    t = [torch.from_numpy(x) for x in (q, k, v)]
    scale = 0.125
    o, lse = bs.sparse_fwd_chunked_plain(*t, row_idx, row_cnt, units, scale, block, causal)
    o_ref, lse_ref = bs.sparse_fwd_plain(*t, row_idx, row_cnt, scale, block, causal)
    np.testing.assert_allclose(o.numpy(), o_ref.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), rtol=1e-6, atol=1e-6)
    ri, rc, _, _ = bs.build_block_tables(layout_h)
    jo, jlse = jax_pbs._sparse_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ri), jnp.asarray(rc),
                                   scale, block, causal, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-5, atol=2e-5)
    dead = lse_ref.numpy() <= bs.NEG_INF / 2
    if name.startswith("heavy rows") and causal:
        assert dead.any()
    assert (o.numpy()[dead] == 0).all() and (lse.numpy()[dead] == bs.NEG_INF).all()


# --- K5's split arithmetic ------------------------------------------------------------
def _paged_rows(rs, lens, NH=6, NKV=2, D=16, P=4, maxp=8):
    """q [B, NH, D] and pools for rows of the given kv_lens: distinct random
    pages, tables ending in -1 sentinels (a row past MAXP·P uses every
    slot)."""
    need = [min(maxp, -(-max(n, 0) // P)) for n in lens]
    NP = 1 + sum(need)
    pt = np.full((len(lens), maxp), -1, np.int32)
    free = rs.permutation(np.arange(1, NP))
    used = 0
    for r, n in enumerate(need):
        pt[r, :n] = free[used: used + n]
        used += n
    q = rs.randn(len(lens), NH, D).astype(np.float32)
    kp = rs.randn(NP, NKV, P, D).astype(np.float32)
    vp = rs.randn(NP, NKV, P, D).astype(np.float32)
    return q, kp, vp, pt, np.asarray(lens, np.int32)


# MAXP·P = 32 keys: a dead row, one key, on and one past boundaries of 8-key splits, the full table, and a
# length past it (clamped to MAXP·P)
K5_LENS = [0, 1, 8, 9, 16, 17, 31, 32, 40]


def _split_then_combine(q, kp, vp, pt, lens, split_keys):
    t = [torch.from_numpy(x) for x in (q, kp, vp, pt, lens)]
    m, l, acc = da.paged_split_partials_plain(*t, split_keys=split_keys, scale=1.0 / np.sqrt(q.shape[-1]))
    return da.paged_combine_plain(m, l, acc, t[4], torch.float32).numpy(), l.numpy()


@pytest.mark.parametrize("split_keys", [1, 3, 8, 16, 64])
def test_paged_split_then_combine_matches_unsplit_plain(split_keys):
    """The combine's merge of per-split partials equals the unsplit plain
    version to 1e-6 in fp32 (the same exponentials, summed in another
    order); dead rows are exact zeros; a split at or past kv_len is empty."""
    q, kp, vp, pt, lens = _paged_rows(np.random.RandomState(3), K5_LENS)
    out, l = _split_then_combine(q, kp, vp, pt, lens, split_keys)
    t = [torch.from_numpy(x) for x in (q, kp, vp, pt, lens)]
    ref = da.paged_decode_attention_plain(*t).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    assert (out[0] == 0).all()
    clamped = np.minimum(lens, pt.shape[1] * kp.shape[2])
    live_splits = -(-clamped // split_keys)
    for r, n in enumerate(live_splits):
        assert (l[r, :, :n] > 0).all() and (l[r, :, n:] == 0).all(), f"row {r}"


def test_paged_split_then_combine_matches_pallas_interpret():
    """JAX's ``paged_decode_attention`` (the Pallas kernel in interpret mode)
    is the outer reference for split-then-combine at 8-key splits (2e-5)."""
    q, kp, vp, pt, lens = _paged_rows(np.random.RandomState(5), K5_LENS)
    out, _ = _split_then_combine(q, kp, vp, pt, lens, 8)
    ref = np.asarray(jax_pa.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
                                                   jnp.asarray(lens), impl="pallas"))
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    assert (ref[0] == 0).all() and (out[0] == 0).all()
