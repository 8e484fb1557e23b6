"""The port's page-pool and journal surfaces that JAX has and the port
lacked until now, held against the JAX package on the CPU.

* ``PagePool.cached_pages`` / ``can_admit``: equal to JAX's pool driven by
  the same script of alloc, prefill, publish, free and rollback, with
  prefix sharing and copy-on-write;
* ``PagePool.defrag``: after rollbacks and frees, JAX's move count, page
  tables, refcounts, free list, cached LRU and prefix index, and the bytes
  of every live page read back through the tables; the pools keep their
  storage (a captured window graph holds it); a second defrag moves
  nothing; mirrors tests/unit/inference/test_kv_pool.py's defrag cases;
* a server that defrags after every step (prefix cache on, an undersized
  pool that preempts): streams byte-identical to the JAX server doing the
  same, with equal move counts step by step;
* ``RequestJournal.close``: a segment sealed byte-identically to JAX's
  writer, ``records_written`` equal to JAX's;
* ``PagedServer.result``: peeks; ``take_result`` then removes;
* ``PagePool.set_cache``: JAX's one sanctioned external write; the port
  copies into the pools' own storage (a captured window graph keeps its
  addresses), reads back like JAX's pool through the tables, and refuses a
  shape or dtype other than the pools'.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import journal as jax_journal
from deepspeed_tpu.inference.kv_pool import PagePool as JaxPagePool
from deepspeed_tpu.inference.scheduler import PagedServer as JaxServer
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models.config import TransformerConfig as JaxConfig
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.inference.journal import RequestJournal
from deepspeed_tpu_torch.inference.kv_pool import TRASH_PAGE, PagePool
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

CFG = dict(
    vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=64,
    norm="rmsnorm", position="rope", activation="swiglu", use_bias=False, tie_embeddings=False,
    flash_attention=False, dtype="float32",
)
P = 4  # page size of the allocator scripts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pools(num_pages=16, max_slots=4):
    jcfg, cfg = JaxConfig(**CFG), TransformerConfig(**CFG)
    jp = JaxPagePool(jcfg, num_pages=num_pages, page_size=P, max_slots=max_slots, max_seq_len=32,
                     dtype=jnp.float32)
    tp = PagePool(cfg, num_pages=num_pages, page_size=P, max_slots=max_slots, max_seq_len=32,
                  dtype=torch.float32, device="cpu")
    # the same random bytes in every page of both pools
    rs = np.random.RandomState(3)
    k = rs.standard_normal(tuple(tp.cache.k_pages.shape)).astype(np.float32)
    v = rs.standard_normal(tuple(tp.cache.v_pages.shape)).astype(np.float32)
    jp.set_cache(jnp.asarray(k), jnp.asarray(v))
    tp.cache.k_pages.copy_(torch.from_numpy(k))
    tp.cache.v_pages.copy_(torch.from_numpy(v))
    return jp, tp


def _prefill(pool, slot, tokens):
    """The scheduler's prefill as the pool sees it: write barrier, advance,
    publish the full pages."""
    tokens = np.asarray(tokens, np.int32)
    assert pool.prepare_write(slot, tokens.size)
    pool.advance(slot, tokens.size - int(pool.seq_lens[slot]))
    pool.register_prefix(slot, tokens)


_rs = np.random.RandomState(11)
SYS = _rs.randint(0, 128, (8,)).astype(np.int32)  # two full pages, shared
CTX = [np.concatenate([SYS, _rs.randint(0, 128, (n,)).astype(np.int32)]) for n in (5, 7, 2)]
OTHER = _rs.randint(0, 128, (11,)).astype(np.int32)


def _script(pool):
    """Alloc with prefix attach, prefill, publish, a shared page's
    copy-on-write, rollback and frees: the same calls on either pool.
    Returns ``[(cached_pages, can_admit(n) for n in 4, 16, 40, 64), ...]``
    after each call."""
    seen = []

    def probe():
        seen.append((pool.cached_pages(), tuple(pool.can_admit(n) for n in (4, 16, 40, 64))))

    a = pool.alloc_slot(CTX[0].size + 1, prefix_tokens=CTX[0])
    probe()
    _prefill(pool, a, CTX[0])
    probe()
    b = pool.alloc_slot(CTX[1].size + 1, prefix_tokens=CTX[1])  # attaches the shared pages
    probe()
    _prefill(pool, b, CTX[1])
    c = pool.alloc_slot(OTHER.size + 1, prefix_tokens=OTHER)
    _prefill(pool, c, OTHER)
    probe()
    assert pool.prepare_write(b, 20)  # grows b past its prompt
    pool.advance(b, 20 - int(pool.seq_lens[b]))
    probe()
    pool.rollback(b, 9)  # a rejected speculative tail: 20 -> 11
    probe()
    pool.rollback(b, 5)  # back into the shared system prompt's second page
    assert pool.prepare_write(b, 10)  # writing there copies it (copy-on-write)
    pool.advance(b, 4)
    assert pool.stats["cow_copies"] == 1
    probe()
    pool.free_slot(a)  # a's published pages park on the cached LRU (the shared ones stay with b)
    probe()
    d = pool.alloc_slot(CTX[2].size + 1, prefix_tokens=CTX[2])
    _prefill(pool, d, CTX[2])
    probe()
    pool.free_slot(c)  # holes below d's pages
    probe()
    pool.rollback(d, 3)
    probe()
    return seen


def test_can_admit_and_cached_pages_match_jax():
    jp, tp = _pools()
    assert _script(tp) == _script(jp)
    assert tp.prefix_stats()["cached_pages"] == tp.cached_pages() == jp.cached_pages() > 0
    tp.integrity_check()


def test_can_admit_gates_like_jax_on_a_full_pool():
    """test_kv_pool.py's admission case: a slot-exhausted or page-short
    pool refuses."""
    for pool in _pools(num_pages=6, max_slots=2):
        assert pool.can_admit(8)
        assert pool.alloc_slot(16) is not None  # 4 of 5 pages
        assert not pool.can_admit(8) and pool.alloc_slot(8) is None
        assert pool.can_admit(4)
        assert pool.alloc_slot(2) is not None
        assert not pool.can_admit(1) and pool.alloc_slot(1) is None
        assert not pool.can_admit(33)  # past max_seq_len


def _live_bytes(pool, k, v):
    """Every live page's k/v through the tables, per (slot, index), and the
    cached pages' by prefix key."""
    out = {}
    for s in range(pool.max_slots):
        for i in range(int(pool._owned[s])):
            p = int(pool.page_table[s, i])
            out[("slot", s, i)] = (np.array(k[:, p]), np.array(v[:, p]))  # copies: defrag rewrites the pools
    for p in pool._cached:
        out[("cached", pool._page_hash[int(p)])] = (np.array(k[:, int(p)]), np.array(v[:, int(p)]))
    return out


def _state(pool):
    return (pool.page_table.copy(), pool._refcount.copy(), list(pool._free), [int(p) for p in pool._cached],
            dict(pool._page_hash), dict(pool._hash_index), pool.seq_lens.copy())


def test_defrag_after_rollback_and_frees_matches_jax():
    jp, tp = _pools()
    _script(jp)
    _script(tp)
    ptr = (tp.cache.k_pages.data_ptr(), tp.cache.v_pages.data_ptr())
    before = _live_bytes(tp, tp.cache.k_pages, tp.cache.v_pages)
    j_moves, t_moves = jp.defrag(), tp.defrag()
    assert t_moves == j_moves > 0
    for a, b in zip(_state(tp), _state(jp)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    # the pools' storage stays where it was: a captured window graph replays into it
    assert (tp.cache.k_pages.data_ptr(), tp.cache.v_pages.data_ptr()) == ptr
    after = _live_bytes(tp, tp.cache.k_pages, tp.cache.v_pages)
    jax_after = _live_bytes(jp, jp.cache.k_pages, jp.cache.v_pages)
    assert set(after) == set(before) == set(jax_after)
    for key in before:
        for a, b, c in zip(after[key], before[key], jax_after[key]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    # live pages are the densest prefix after the trash page, the free list the rest
    n_live = len(after)
    live_ids = {int(p) for s in range(tp.max_slots) for p in tp.page_table[s, :int(tp._owned[s])]}
    live_ids |= {int(p) for p in tp._cached}
    assert live_ids == set(range(TRASH_PAGE + 1, TRASH_PAGE + 1 + len(live_ids)))
    assert sorted(tp._free) == list(range(TRASH_PAGE + 1 + len(live_ids), tp.num_pages))
    assert n_live >= len(live_ids)  # shared pages appear once per table
    tp.integrity_check()
    assert tp.defrag() == jp.defrag() == 0  # already compact


def test_defrag_then_the_pool_keeps_serving_like_jax():
    """After a defrag both pools take the same further calls to the same
    states: the prefix index still attaches the shared prompt."""
    jp, tp = _pools()
    for pool in (jp, tp):
        _script(pool)
        pool.defrag()
        s = pool.alloc_slot(CTX[0].size + 1, prefix_tokens=CTX[0])
        assert int(pool.seq_lens[s]) >= 2 * P  # the shared system prompt (and more), attached
        _prefill(pool, s, CTX[0])
    for a, b in zip(_state(tp), _state(jp)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert tp.prefix_stats() == jp.prefix_stats()


# --- a server that defrags between steps ---------------------------------------------------
_MODEL = {}


def _model():
    if not _MODEL:
        jcfg = JaxConfig(**CFG)
        params = JaxLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        tree = jax.tree_util.tree_map(np.asarray, params)
        cfg = TransformerConfig(**CFG)
        _MODEL["m"] = (jcfg, cfg, params, load_jax_params(TransformerLM(cfg), tree, device="cpu").param_tree())
    return _MODEL["m"]


def _serve_defragging(srv, prompts, new):
    uids = [srv.submit(p, max_new_tokens=new) for p in prompts]
    moves = []
    while srv.has_work():
        srv.step()
        moves.append(srv.pool.defrag())
        srv.pool.integrity_check()
    return [srv.take_result(u) for u in uids], moves


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "bucketed"])
def test_server_defragging_between_steps_streams_match_jax(ragged):
    jcfg, cfg, params, tree = _model()
    rs = np.random.RandomState(5)
    sys_prompt = rs.randint(0, 128, (16,)).astype(np.int32)
    prompts = [np.concatenate([sys_prompt, rs.randint(0, 128, (n,)).astype(np.int32)]) for n in (3, 9, 5, 12)]
    kw = dict(page_size=8, max_slots=3, prefill_chunk=8, num_pages=12, prefix_cache=True, ragged=ragged)
    jsrv = JaxServer(jcfg, params, attn_impl="xla", dtype=jnp.float32, **kw)
    tsrv = PagedServer(cfg, tree, device="cpu", dtype=torch.float32, **kw)
    ptr = tsrv.pool.cache.k_pages.data_ptr()
    j_outs, j_moves = _serve_defragging(jsrv, prompts, 14)
    t_outs, t_moves = _serve_defragging(tsrv, prompts, 14)
    for a, b in zip(t_outs, j_outs):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert t_moves == j_moves and sum(t_moves) > 0
    assert tsrv.stats["preempted"] == jsrv.stats["preempted"] > 0
    assert tsrv.pool.cache.k_pages.data_ptr() == ptr


# --- C4: the journal's close and counter, the server's result ------------------------------
def _write(journal):
    journal.append_submit(0, np.asarray([1, 2, 3], np.int32), 8, None, "default", t_submit=1.5)
    journal.append_first_token(0, 2.25)
    journal.append_emit(0, 7)
    journal.sync()
    journal.append_submit(1, np.asarray([4, 5], np.int32), 4, 3, "tenantB", generated=[9])
    journal.append_emit(0, 8)
    journal.append_finish(0)
    journal.append_migrate(1)
    journal.close()


def test_close_seals_byte_identical_to_jax(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jj, tj = jax_journal.RequestJournal(str(jdir)), RequestJournal(str(tdir))
    _write(jj)
    _write(tj)
    assert tj.records_written == jj.records_written == 7
    assert tj.segments_sealed == jj.segments_sealed == 1
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names and all(n.endswith(".jrnl") for n in names)
    for n in names:
        assert (tdir / n).read_bytes() == (jdir / n).read_bytes()
    # nothing is left open; a second close is a no-op, and the journal replays in both packages alike
    tj.close()
    assert sorted(os.listdir(tdir)) == names
    t_states, t_next = RequestJournal.replay(str(tdir))
    j_states, j_next = jax_journal.RequestJournal.replay(str(jdir))
    assert t_next == j_next == 2 and sorted(t_states) == sorted(j_states) == [0]
    assert t_states[0].generated == j_states[0].generated == [7, 8]


def test_records_written_counts_synced_records_like_jax(tmp_path):
    jj = jax_journal.RequestJournal(str(tmp_path / "jax"), segment_bytes=64)
    tj = RequestJournal(str(tmp_path / "port"), segment_bytes=64)
    counts = []
    for j in (jj, tj):
        seen = []
        for uid in range(3):
            j.append_submit(uid, np.arange(uid + 2, dtype=np.int32), 4, None, "default")
            seen.append(j.records_written)  # buffered: not counted yet
            j.append_emit(uid, uid + 10)
            j.sync()
            seen.append(j.records_written)
        j.close()
        seen.append((j.records_written, j.segments_sealed))
        counts.append(seen)
    assert counts[1] == counts[0]
    assert counts[1][-1][0] == 6


def test_result_peeks_then_take_result_removes():
    jcfg, cfg, params, tree = _model()
    prompt = np.arange(1, 10, dtype=np.int32)
    outs = []
    for srv in (JaxServer(jcfg, params, attn_impl="xla", dtype=jnp.float32, page_size=8, max_slots=2),
                PagedServer(cfg, tree, device="cpu", dtype=torch.float32, page_size=8, max_slots=2)):
        uid = srv.submit(prompt, max_new_tokens=5)
        assert srv.result(uid) is None  # not finished
        srv.run()
        first = srv.result(uid)
        np.testing.assert_array_equal(srv.result(uid), first)  # a peek leaves it in place
        np.testing.assert_array_equal(srv.take_result(uid), first)
        assert srv.result(uid) is None and srv.take_result(uid) is None
        outs.append(np.asarray(first))
    np.testing.assert_array_equal(outs[1], outs[0])


def test_set_cache_writes_in_place_like_jax():
    jp, tp = _pools()
    _script(jp)
    _script(tp)
    ptr = (tp.cache.k_pages.data_ptr(), tp.cache.v_pages.data_ptr())
    rs = np.random.RandomState(11)
    k = rs.standard_normal(tuple(tp.cache.k_pages.shape)).astype(np.float32)
    v = rs.standard_normal(tuple(tp.cache.v_pages.shape)).astype(np.float32)
    jp.set_cache(jnp.asarray(k), jnp.asarray(v))
    tp.set_cache(torch.from_numpy(k), torch.from_numpy(v))
    assert (tp.cache.k_pages.data_ptr(), tp.cache.v_pages.data_ptr()) == ptr
    np.testing.assert_array_equal(tp.cache.k_pages.numpy(), k)
    np.testing.assert_array_equal(tp.cache.v_pages.numpy(), v)
    got = _live_bytes(tp, tp.cache.k_pages, tp.cache.v_pages)
    want = _live_bytes(jp, jp.cache.k_pages, jp.cache.v_pages)
    assert set(got) == set(want)
    for key in got:
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)
    tp.set_cache(tp.cache.k_pages, tp.cache.v_pages)  # its own pools: nothing to copy
    with pytest.raises(ValueError, match="set_cache"):
        tp.set_cache(torch.from_numpy(k[:, :-1]), torch.from_numpy(v[:, :-1]))
    with pytest.raises(ValueError, match="set_cache"):
        tp.set_cache(torch.from_numpy(k).double(), torch.from_numpy(v).double())
    np.testing.assert_array_equal(tp.cache.k_pages.numpy(), k)  # a refused call writes nothing
