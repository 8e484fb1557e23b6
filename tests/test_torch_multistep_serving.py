"""The port's multi-step serving windows against its own single-step ragged
path and the JAX package's windows, on the CPU.

Mirrors tests/unit/inference/test_multistep_serving.py where it applies
(speculative decoding, the journal and tensor-parallel serving are not
ported). Two tiny fp32 models, the llama-style GQA ``CFG`` of the JAX file
and a GPT-2-style MHA one; weights from the JAX ``TransformerLM.init``
through ``load_jax_params``. On the CPU a window runs the same body as a
card's captured CUDA graph, eagerly.

* window streams byte-identical to the port's single-step streams and to
  the JAX ``PagedServer``'s window streams, with the same window count and
  break reasons (one JAX server per model; the models are built once a
  module);
* EOS inside a window; every row finishing on a window's edge; the
  ``admission``, ``prefill`` and ``pool`` breaks, a window's reservation
  never preempting; preemption and resume; prefix-cache attach; a
  near-finished row at the sequence cap; steady-state dispatches per token
  at most 1/horizon; the stats block; config validation; the knob through
  ``init_inference``; a copy-on-write keeps the pools' storage (a captured
  graph holds their addresses).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.scheduler import PagedServer as JaxServer
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models.config import TransformerConfig as JaxConfig
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.kv_pool import PagePool
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

CONFIGS = {
    "llama_gqa": dict(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
        max_seq_len=64, norm="rmsnorm", position="rope", activation="swiglu",
        use_bias=False, tie_embeddings=False, flash_attention=False, dtype="float32",
    ),
    "gpt2_mha": dict(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
        norm="layernorm", position="learned", activation="gelu", use_bias=True,
        tie_embeddings=True, flash_attention=False, dtype="float32",
    ),
}
H = 4  # the armed horizon of every window server here
BUDGETS = [13, 9, 17, 12]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_MODELS = {}


def _models(name):
    """(jax cfg, port cfg, jax params, port param tree), built once a module."""
    if name not in _MODELS:
        jcfg = JaxConfig(**CONFIGS[name])
        params = JaxLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        tree = jax.tree_util.tree_map(np.asarray, params)
        cfg = TransformerConfig(**CONFIGS[name])
        _MODELS[name] = (jcfg, cfg, params, load_jax_params(TransformerLM(cfg), tree, device="cpu").param_tree())
    return _MODELS[name]


def _prompts(n, seed=0, lo=3, hi=20):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 128, (int(rs.randint(lo, hi)),)).astype(np.int32) for _ in range(n)]


def _server(cfg, params, multi_step=True, horizon=H, **kw):
    kw.setdefault("page_size", 8)
    kw.setdefault("max_slots", 4)
    kw.setdefault("prefill_chunk", 8)
    ms = {"enable": True, "horizon": horizon} if multi_step else None
    return PagedServer(cfg, params, device="cpu", multi_step=ms, **kw)


def _single(cfg, params, prompts, budgets, eos=None, **kw):
    """The single-step ragged streams (held against JAX in test_torch_serving.py)."""
    return _server(cfg, params, multi_step=False, **kw).serve(prompts, max_new_tokens=budgets, eos_token_id=eos)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_window_streams_match_single_step_and_jax(name):
    """The same mix through the window path, the single-step path and the
    JAX window server: byte-identical streams, windows engaged, fewer
    dispatches, the pool drained."""
    jcfg, cfg, jparams, ptree = _models(name)
    prompts = _prompts(4, seed=2)
    windowed = _server(cfg, ptree)
    outs = windowed.serve(prompts, max_new_tokens=BUDGETS)
    single = _server(cfg, ptree, multi_step=False)
    oracle = single.serve(prompts, max_new_tokens=BUDGETS)
    jax_server = JaxServer(jcfg, jparams, page_size=8, max_slots=4, prefill_chunk=8, attn_impl="xla",
                           dtype=jnp.float32, multi_step={"enable": True, "horizon": H})
    jax_outs = jax_server.serve(prompts, max_new_tokens=BUDGETS)
    for a, b, c in zip(outs, oracle, jax_outs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))
    st = windowed.serve_stats()
    assert st["window_steps"] >= 2 and st["window_steps"] == jax_server.stats["window_steps"], st
    assert st["window_break_reasons"] == jax_server.serve_stats()["window_break_reasons"]
    assert single.stats["window_steps"] == 0 and st["window_captures"] == 0  # no graph on the CPU
    assert st["dispatches"] < single.stats["dispatches"]
    assert windowed.pool.used_pages() == 0 and windowed.pool.live_tokens() == 0
    windowed.pool.integrity_check()


def test_window_eos_inside():
    """EOS mid-window freezes the row in the window: it emits the EOS and
    nothing after, as single steps do; the break is charged to eos."""
    _, cfg, _, ptree = _models("llama_gqa")
    prompts = _prompts(2, seed=7)
    futures = _single(cfg, ptree, prompts, 16)
    eos = int(futures[0][prompts[0].size + 5])  # round 2 of the second window, not on an edge
    server = _server(cfg, ptree)
    outs = server.serve(prompts, max_new_tokens=16, eos_token_id=eos)
    for a, b in zip(outs, _single(cfg, ptree, prompts, 16, eos=eos)):
        np.testing.assert_array_equal(a, b)
    assert outs[0][-1] == eos and outs[0].size < prompts[0].size + 16
    st = server.serve_stats()
    assert st["window_steps"] >= 1
    assert st["window_break_reasons"]["eos"] >= 1, st["window_break_reasons"]


def test_window_finish_at_window_edge():
    """Budgets that end every row on a window edge: three full windows, no
    single-step tail, nothing charged to budget or eos."""
    _, cfg, _, ptree = _models("llama_gqa")
    prompts = _prompts(2, seed=3, lo=4, hi=7)  # one-chunk prompts
    budget = 3 * H + 1  # the first token comes from the prefill chunk
    server = _server(cfg, ptree)
    outs = server.serve(prompts, max_new_tokens=budget)
    for a, b in zip(outs, _single(cfg, ptree, prompts, budget)):
        np.testing.assert_array_equal(a, b)
    st = server.serve_stats()
    assert st["window_steps"] == 3, st
    assert st["window_break_reasons"]["budget"] == 0 and st["window_break_reasons"]["eos"] == 0


def test_window_admission_breaks():
    """Requests queued while windows run break the next window (admission),
    their chunks ride single steps (prefill), and every stream stays exact."""
    _, cfg, _, ptree = _models("llama_gqa")
    prompts = _prompts(6, seed=4)
    server = _server(cfg, ptree)
    first = [server.submit(p, max_new_tokens=14) for p in prompts[:4]]
    while server.stats["window_steps"] < 1:
        server.step()
    late = [server.submit(p, max_new_tokens=14) for p in prompts[4:]]
    results = server.run()
    for uid, want in zip(first + late, _single(cfg, ptree, prompts, 14)):
        np.testing.assert_array_equal(results[uid], want)
    br = server.serve_stats()["window_break_reasons"]
    assert br["admission"] >= 1 and br["prefill"] >= 1, br


def test_window_preemption_and_resume():
    """An undersized pool: windows break to the single-step path, which
    preempts; the recomputed continuations match the window-off server."""
    _, cfg, _, ptree = _models("llama_gqa")
    kw = dict(page_size=4, num_pages=14, max_slots=3, prefill_chunk=8)
    prompts = _prompts(4, seed=4, lo=6, hi=14)
    windowed = _server(cfg, ptree, **kw)
    outs = windowed.serve(prompts, max_new_tokens=12)
    assert windowed.stats["preempted"] >= 1, "pool was sized to force preemption"
    for a, b in zip(outs, _single(cfg, ptree, prompts, 12, **kw)):
        np.testing.assert_array_equal(a, b)
    assert windowed.pool.used_pages() == 0
    windowed.pool.integrity_check()


def test_window_pool_pressure_breaks_without_preempting():
    """Reservation pressure with no queue and no prefill lands on the "pool"
    counter; the window's reservation hands every page back and preempts no
    one (the single-step fallback then does); streams stay exact."""
    _, cfg, _, ptree = _models("llama_gqa")
    kw = dict(page_size=4, num_pages=10, max_slots=2, prefill_chunk=8)
    prompts = _prompts(2, seed=12, lo=6, hi=10)
    server = _server(cfg, ptree, **kw)
    window = server._ragged_window
    probes = []

    def probe():
        free, preempted = server.pool.free_pages(), server.stats["preempted"]
        pools = server.stats["window_break_reasons"]["pool"]
        formed = window()
        if server.stats["window_break_reasons"]["pool"] > pools:
            probes.append((free, server.pool.free_pages(), preempted, server.stats["preempted"]))
        return formed

    server._ragged_window = probe
    outs = server.serve(prompts, max_new_tokens=14)
    for a, b in zip(outs, _single(cfg, ptree, prompts, 14, **kw)):
        np.testing.assert_array_equal(a, b)
    br = server.serve_stats()["window_break_reasons"]
    assert br["pool"] >= 1, br
    assert probes and all(f0 == f1 and p0 == p1 for f0, f1, p0, p1 in probes), probes
    assert server.stats["preempted"] >= 1
    server.pool.integrity_check()


def test_window_prefix_cache_attach():
    """Warm prefix attaches ride under windows: pages attach, windows form,
    streams match sharing-off single steps."""
    _, cfg, _, ptree = _models("llama_gqa")
    rs = np.random.RandomState(21)
    shared = rs.randint(0, 128, (19,)).astype(np.int32)
    prompts = [np.concatenate([shared, rs.randint(0, 128, (3 + i,)).astype(np.int32)]) for i in range(4)]
    server = _server(cfg, ptree, prefix_cache=True)
    outs = server.serve(prompts[:1], max_new_tokens=9) + server.serve(prompts[1:], max_new_tokens=9)
    assert server.pool.stats["prefix_hit_pages"] > 0 and server.stats["window_steps"] >= 1
    for a, b in zip(outs, _single(cfg, ptree, prompts, 9, prefix_cache=False)):
        np.testing.assert_array_equal(a, b)
    server.pool.integrity_check()


def test_window_forms_with_near_finished_row_at_seq_cap():
    """A row near max_seq_len whose budget fits but whose len + horizon
    would not: the reservation asks min(horizon, budget), so the first
    stable step still forms a window."""
    _, cfg, _, ptree = _models("llama_gqa")
    rs = np.random.RandomState(30)
    long_p = rs.randint(0, 128, (61,)).astype(np.int32)  # 61 + 2 <= 64 < 61 + H
    short_p = rs.randint(0, 128, (6,)).astype(np.int32)
    server = _server(cfg, ptree)
    uids = [server.submit(short_p, max_new_tokens=3 * H + 1), server.submit(long_p, max_new_tokens=2)]
    while server.prefilling():
        server.step()
    assert len(server._active) == 2
    server.step()
    assert server.stats["window_steps"] == 1, server.serve_stats()
    results = server.run()
    want = _single(cfg, ptree, [short_p, long_p], [3 * H + 1, 2])
    np.testing.assert_array_equal(results[uids[0]], want[0])
    np.testing.assert_array_equal(results[uids[1]], want[1])


def test_steady_state_dispatches_per_token_le_one_over_horizon():
    """Once prefill is done and the queue is empty, each call is a window
    of H rounds: dispatches per token <= 1/H."""
    _, cfg, _, ptree = _models("llama_gqa")
    server = _server(cfg, ptree)
    for p in _prompts(2, seed=5, lo=4, hi=7):
        server.submit(p, max_new_tokens=3 * H + 1)
    while server.prefilling():
        server.step()
    disp, toks = server.stats["dispatches"], server.stats["emitted_tokens"]
    server.run()
    disp, toks = server.stats["dispatches"] - disp, server.stats["emitted_tokens"] - toks
    assert toks == 2 * 3 * H
    assert disp / toks <= 1.0 / H and disp == server.stats["window_steps"], (disp, toks)


def test_window_stats_block():
    """serve_stats() carries window_steps, the armed horizon (0 when off),
    the break reasons, and a dispatches_per_token below the single-step
    server's."""
    _, cfg, _, ptree = _models("llama_gqa")
    prompts = _prompts(2, seed=10, lo=4, hi=7)
    server = _server(cfg, ptree)
    server.serve(prompts, max_new_tokens=3 * H + 1)
    st = server.serve_stats()
    assert st["window_horizon"] == H and st["window_steps"] >= 1
    assert 0.0 < st["dispatches_per_token"] < 1.0
    assert set(st["window_break_reasons"]) == {"admission", "prefill", "draft", "eos", "budget", "pool"}
    assert st["window_device_ms"] == {"count": 0}  # replays are timed on a card only
    single = _server(cfg, ptree, multi_step=False)
    single.serve(prompts, max_new_tokens=3 * H + 1)
    sst = single.serve_stats()
    assert sst["window_horizon"] == 0 and sst["window_steps"] == 0
    assert st["dispatches_per_token"] < sst["dispatches_per_token"]


def test_multistep_config_validation():
    _, cfg, _, ptree = _models("llama_gqa")
    with pytest.raises(ValueError, match="horizon"):
        _server(cfg, ptree, horizon=1)
    with pytest.raises(ValueError, match="ragged"):
        _server(cfg, ptree, ragged=False)
    with pytest.raises(ValueError, match="multi_step"):
        DeepSpeedInferenceConfig(paged_kv={"ragged": False, "multi_step": {"enable": True}})
    with pytest.raises(ValueError, match="horizon"):
        DeepSpeedInferenceConfig(paged_kv={"multi_step": {"enable": True, "horizon": 1}})
    DeepSpeedInferenceConfig(paged_kv={"multi_step": {"horizon": 1}})  # checked only when armed


def test_multistep_knob_through_engine():
    """``paged_kv.multi_step`` through ``init_inference`` serves through
    windows, byte-identical to the engine without them."""
    _, cfg, _, ptree = _models("llama_gqa")
    tree = jax.tree_util.tree_map(np.asarray, _models("llama_gqa")[2])
    prompts = _prompts(3, seed=11)
    outs, steps = {}, {}
    for enable in (True, False):
        engine = dst.init_inference(TransformerLM(cfg), dtype="fp32", device="cpu",
                                    paged_kv={"page_size": 8, "max_slots": 4, "prefill_chunk": 8,
                                              "multi_step": {"enable": enable, "horizon": H}})
        engine.load_jax_params(tree)
        outs[enable] = engine.serve(prompts, max_new_tokens=3 * H + 1)
        steps[enable] = engine.serve_stats()["window_steps"]
    assert steps[True] >= 1 and steps[False] == 0
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)


def test_copy_on_write_keeps_pool_storage():
    """A copy-on-write between windows copies a page in place: the pools a
    captured window graph holds keep their storage, and the copy carries
    the shared page's rows."""
    cfg = TransformerConfig(**CONFIGS["llama_gqa"])
    pool = PagePool(cfg, 8, 4, 2, device="cpu")
    k, v = pool.cache.k_pages, pool.cache.v_pages
    ptrs = (k.data_ptr(), v.data_ptr())
    k.copy_(torch.randn_like(k))
    tokens = np.arange(8, dtype=np.int32)
    a = pool.alloc_slot(9)
    pool.advance(a, 8)
    pool.register_prefix(a, tokens, 8)
    b = pool.alloc_slot(9, prefix_tokens=np.arange(9, dtype=np.int32))
    assert int(pool.seq_lens[b]) == 8
    shared = int(pool.page_table[b, 1])
    pool.rollback(b, 1)  # row b now writes into the shared second page
    assert pool.prepare_write(b, 8) and pool.stats["cow_copies"] == 1
    copy = int(pool.page_table[b, 1])
    assert copy != shared and (k.data_ptr(), v.data_ptr()) == ptrs
    torch.testing.assert_close(k[:, copy], k[:, shared], rtol=0, atol=0)
    pool.integrity_check()
