"""The port's speculative decoding against the JAX package's, on the CPU.

Mirrors tests/unit/inference/test_spec_decode.py where it applies, on the
tiny fp32 llama-style GQA model of that file, its weights from the JAX
``TransformerLM.init`` through ``load_jax_params``; the JAX servers score
through XLA (``attn_impl="xla"``), the port's through its plain attention
(a CPU tensor always takes it).

* ``NGramDrafter``: the same proposals for the same contexts, token for
  token, over seeded contexts growing a token at a time, with per-uid state
  and ``drop``;
* the bucketed verify program's packed output equal to JAX's
  ``build_paged_verify_step`` (accepted counts and greedy tokens exactly,
  the written pages to 1e-5), with drafts that reject at once, partly and
  not at all; its refusals (K < 1, ALiBi);
* ragged, bucketed and window servers with scripted drafters (an oracle of
  the speculation-off streams, the oracle corrupted at an index, a constant
  drafter) and the n-gram drafter: streams byte-identical to the JAX spec
  server's and to speculation-off, with ``spec_rounds``, ``spec_drafted``,
  ``spec_accepted``, ``spec_accept_hist``, ``dispatches`` and the "draft"
  window breaks equal to JAX's, and every page back in the pool;
* EOS inside an accepted run, drafts clamped to the budget, preemption
  under an undersized pool, mid-stream admission, the rejected tail's pages
  rolled back mid-stream, and a rejected draft's page never published to
  the prefix index;
* the knobs: ``spec_decode`` through ``init_inference`` in the three
  modes, the stats block, bad lengths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import decode as jax_decode
from deepspeed_tpu.inference.scheduler import PagedServer as JaxServer
from deepspeed_tpu.inference.spec_decode import Drafter as JaxDrafter
from deepspeed_tpu.inference.spec_decode import NGramDrafter as JaxNGram
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models.config import TransformerConfig as JaxConfig
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.inference.decode import build_paged_verify_step
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.inference.spec_decode import Drafter, NGramDrafter
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

CFG = dict(
    vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=64,
    norm="rmsnorm", position="rope", activation="swiglu", use_bias=False, tie_embeddings=False,
    flash_attention=False, dtype="float32",
)
PAGED = dict(page_size=8, max_slots=4, prefill_chunk=8)
H = 4  # the window servers' horizon


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_MODEL = {}


def _model():
    """(jax cfg, port cfg, jax params, numpy tree, port param tree), built once."""
    if not _MODEL:
        jcfg = JaxConfig(**CFG)
        params = JaxLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        tree = jax.tree_util.tree_map(np.asarray, params)
        cfg = TransformerConfig(**CFG)
        _MODEL["m"] = (jcfg, cfg, params, tree, load_jax_params(TransformerLM(cfg), tree, device="cpu").param_tree())
    return _MODEL["m"]


def _prompts(n, seed=0, lo=3, hi=20):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, CFG["vocab_size"], (int(rs.randint(lo, hi)),)).astype(np.int32) for _ in range(n)]


def _motif_prompts(n, seed=0):
    """Prompts that repeat a short motif, so prompt lookup always finds a
    suffix to continue."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        motif = rs.randint(0, CFG["vocab_size"], (int(rs.randint(2, 5)),)).astype(np.int32)
        out.append(np.concatenate([rs.randint(0, CFG["vocab_size"], (2,)).astype(np.int32), np.tile(motif, 3)]))
    return out


class OracleDrafter(Drafter):
    """Drafts each request's known future (speculation-off stream):
    acceptance is total; ``corrupt_at`` changes that index of every
    proposal, pinning the accepted prefix to it."""

    def __init__(self, futures, corrupt_at=None, vocab=128):
        self.futures, self.corrupt_at, self.vocab = futures, corrupt_at, vocab

    def propose(self, uid, context, k):
        cont = self.futures[uid][context.size : context.size + k].copy()
        if self.corrupt_at is not None and cont.size > self.corrupt_at:
            cont[self.corrupt_at] = (cont[self.corrupt_at] + 1) % self.vocab
        return cont.astype(np.int32)


class ConstantDrafter(Drafter):
    """Always the same token: a reject-(almost-)all verify every round."""

    def __init__(self, token=0):
        self.token = int(token)

    def propose(self, uid, context, k):
        return np.full(k, self.token, np.int32)


# the same scripted drafters on the JAX package's interface
class JaxOracle(OracleDrafter, JaxDrafter):
    pass


class JaxConstant(ConstantDrafter, JaxDrafter):
    pass


# one slot bucket keeps the JAX bucketed server to one decode and one verify program (the bucket choice
# is held in test_torch_serving_bucketed.py)
MODES = {"ragged": dict(ragged=True), "bucketed": dict(ragged=False, slot_buckets=[4]),
         "windows": dict(ragged=True, windows=True)}
DRAFTERS = ("oracle", "oracle_corrupt0", "oracle_corrupt2", "constant", "ngram")


def _server(ragged=True, windows=False, **kw):
    _, cfg, _, _, ptree = _model()
    for k, v in PAGED.items():
        kw.setdefault(k, v)
    ms = {"enable": True, "horizon": H} if windows else None
    return PagedServer(cfg, ptree, device="cpu", ragged=ragged, multi_step=ms, **kw)


def _jax_server(ragged=True, windows=False, **kw):
    jcfg, _, params, _, _ = _model()
    for k, v in PAGED.items():
        kw.setdefault(k, v)
    ms = {"enable": True, "horizon": H} if windows else None
    return JaxServer(jcfg, params, attn_impl="xla", dtype=jnp.float32, ragged=ragged, multi_step=ms, **kw)


def _off(prompts, budgets, eos=None, **kw):
    """Speculation-off streams of the port's ragged server (held against
    JAX in test_torch_serving.py)."""
    return _server(**kw).serve(prompts, max_new_tokens=budgets, eos_token_id=eos)


def _drafters(name, futures):
    """(port server kwargs, the JAX server's) for a drafter name."""
    if name == "ngram":
        knobs = {"enable": True, "max_draft": 4, "ngram_order": 3}
        return dict(spec_decode=knobs), dict(spec_decode=knobs)
    if name == "constant":
        return dict(drafter=ConstantDrafter(3)), dict(drafter=JaxConstant(3))
    corrupt = None if name == "oracle" else int(name[-1])
    return dict(drafter=OracleDrafter(futures, corrupt)), dict(drafter=JaxOracle(futures, corrupt))


def _case(name):
    """A server case: (prompts, budgets, eos, server kwargs, port extras,
    JAX extras, the speculation-off streams). Names: (mode, drafter) for
    the mix; ("eos", mode); ("preempt", mode)."""
    kind, arg = name
    if kind == "eos":
        prompts, budgets, kw = _prompts(2, seed=7), 10, dict(MODES[arg])
        eos = int(_off(prompts, 10)[0][prompts[0].size + 2])  # request 0's third generated token
        futures = dict(enumerate(_off(prompts, 10)))
        ref = _off(prompts, 10, eos=eos)
        ours, theirs = _drafters("oracle", futures)
        return prompts, budgets, eos, kw, ours, theirs, ref
    if kind == "preempt":
        prompts, kw = _prompts(4, seed=4, lo=6, hi=14), dict(MODES[arg], num_pages=8)
        ref = _off(prompts, 12, num_pages=8)
        ours, theirs = _drafters("oracle_corrupt1", dict(enumerate(ref)))
        return prompts, 12, None, kw, ours, theirs, ref
    drafter = arg
    prompts = _motif_prompts(6, seed=2) if drafter == "ngram" else _prompts(6, seed=2)
    budgets = [10, 3, 7, 12, 1, 5] if drafter != "ngram" else [24, 16, 30, 20, 9, 12]
    ref = _off(prompts, budgets)
    ours, theirs = _drafters(drafter, dict(enumerate(ref)))
    return prompts, budgets, None, dict(MODES[kind]), ours, theirs, ref


CASES = [(m, d) for m in sorted(MODES) for d in DRAFTERS] + [("eos", "ragged"), ("eos", "bucketed"),
                                                            ("preempt", "ragged")]
VERIFY_K, VERIFY_B = 4, 4


def _verify_inputs():
    """A bucket of 4 rows (a dead pad row among them) at K = 4 on the
    bucketed servers' pool shape (33 pages of 8, 8 table columns), tables
    of distinct random pages."""
    jcfg = _model()[0]
    rs = np.random.RandomState(7)
    K, B, P, maxp, NP = VERIFY_K, VERIFY_B, 8, 8, 33
    L, NKV, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    k_pages = rs.randn(L, NP, NKV, P, D).astype(np.float32)
    v_pages = rs.randn(L, NP, NKV, P, D).astype(np.float32)
    table = np.full((B, maxp), -1, np.int32)
    lengths = np.array([5, 17, 0, 30], np.int32)  # row 2 is dead padding
    draft_lens = np.array([4, 1, 0, 3], np.int32)
    free = rs.permutation(np.arange(1, NP))
    used = 0
    for b in range(B):
        if lengths[b]:
            n = -(-(int(lengths[b]) + K + 1) // P)
            table[b, :n] = free[used : used + n]
            used += n
    tokens = rs.randint(0, CFG["vocab_size"], (B, K + 1)).astype(np.int32)
    return tokens, k_pages, v_pages, table, lengths, draft_lens


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX run this file compares with, made in one fixture: the
    suite drops JAX's compiled programs after each test, and one pass
    compiles each program once. The case's streams and ``serve_stats()``,
    and the verify program's passes: (tokens, packed, k pages, v pages),
    each pass drafting the previous pass's greedy tokens, so rows accept
    0 .. K drafts."""
    runs = {}
    for name in CASES:
        prompts, budgets, eos, kw, _, theirs, _ = _case(name)
        srv = _jax_server(**kw, **theirs)
        outs = [np.asarray(o) for o in srv.serve(prompts, max_new_tokens=budgets, eos_token_id=eos)]
        runs[name] = (outs, srv.serve_stats(), srv.stats["preempted"])
    jcfg, _, params, _, _ = _model()
    tokens, k_pages, v_pages, table, lengths, draft_lens = _verify_inputs()
    fn = jax_decode.build_paged_verify_step(jcfg, VERIFY_B, VERIFY_K, 8, attn_impl="xla")
    passes = []
    for _ in range(VERIFY_K + 1):
        out, kj, vj = fn(params, jnp.asarray(tokens), jnp.asarray(k_pages), jnp.asarray(v_pages),
                         jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(draft_lens))
        out = np.asarray(out)
        passes.append((tokens.copy(), out, np.asarray(kj), np.asarray(vj)))
        tokens[:, 1:] = out[:, 1:-1]
    runs["verify"] = passes
    return runs


SPEC_KEYS = ("spec_rounds", "spec_drafted", "spec_accepted", "spec_accept_hist", "dispatches",
             "decode_steps", "window_steps", "window_break_reasons")


def _run_case(name, jax_runs):
    """The port's server on a case, held against the JAX run and the
    speculation-off streams; every page back in the pool."""
    prompts, budgets, eos, kw, ours, _, ref = _case(name)
    port = _server(**kw, **ours)
    outs = port.serve(prompts, max_new_tokens=budgets, eos_token_id=eos)
    jax_outs, jax_stats, jax_preempted = jax_runs[name]
    for a, b, c in zip(outs, jax_outs, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    st = port.serve_stats()
    for key in SPEC_KEYS:
        assert st[key] == jax_stats[key], (key, st[key], jax_stats[key])
    assert port.stats["preempted"] == jax_preempted
    assert port.pool.used_pages() == 0 and port.pool.live_tokens() == 0
    port.pool.integrity_check()
    return port, outs, st


# --- the drafter -----------------------------------------------------------------------
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_ngram_proposals_equal_jax(order):
    """Contexts growing a token at a time (the serving pattern), several
    requests interleaved, ``k`` from 1 to 5, a ``drop`` midway: the same
    proposals token for token."""
    rs = np.random.RandomState(order)
    ours, theirs = NGramDrafter(ngram_order=order), JaxNGram(ngram_order=order)
    ctxs = {uid: rs.randint(0, 6, (int(rs.randint(1, 6)),)).astype(np.int32) for uid in range(3)}
    hits = 0
    for step in range(60):
        uid = int(rs.randint(3))
        if step == 30:
            ours.drop(uid)
            theirs.drop(uid)
        k = int(rs.randint(1, 6))
        a, b = ours.propose(uid, ctxs[uid], k), theirs.propose(uid, ctxs[uid], k)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32 and a.size <= k
        hits += a.size > 0
        ctxs[uid] = np.append(ctxs[uid], np.int32(rs.randint(0, 6)))
    assert hits > 10  # a six-token vocabulary repeats: the lookup really fired
    assert sorted(ours._state) == sorted(theirs._state)


def test_ngram_drafter_cases_and_bad_order():
    """The JAX file's worked cases; order 0 raises in both."""
    d = NGramDrafter(ngram_order=3)
    ctx = np.array([5, 6, 7, 5, 6, 7, 5, 6], np.int32)
    np.testing.assert_array_equal(d.propose(0, ctx, 4), [7, 5, 6])
    np.testing.assert_array_equal(d.propose(0, ctx, 2), [7, 5])
    assert d.propose(1, np.array([1, 2, 3, 4], np.int32), 4).size == 0
    np.testing.assert_array_equal(d.propose(2, np.array([9, 1, 2, 9, 8, 2], np.int32), 2), [9, 8])
    for cls in (NGramDrafter, JaxNGram):
        with pytest.raises(ValueError, match="ngram_order"):
            cls(ngram_order=0)


# --- the bucketed verify program --------------------------------------------------------
def test_verify_step_packed_output_equals_jax(jax_runs):
    """The port's verify program on the inputs of each JAX pass: the packed
    [B, K+2] output equal to JAX's exactly, the written pages within 1e-5;
    the first pass rejects early, the last accepts every draft."""
    _, cfg, _, _, ptree = _model()
    _, k_pages, v_pages, table, lengths, draft_lens = _verify_inputs()
    ours = build_paged_verify_step(cfg, VERIFY_K)
    live = table[table >= 0]
    for tokens, out_j, kj, vj in jax_runs["verify"]:
        kt, vt = torch.from_numpy(k_pages.copy()), torch.from_numpy(v_pages.copy())
        out_t = ours(ptree, torch.from_numpy(tokens), kt, vt, torch.from_numpy(table), torch.from_numpy(lengths),
                     torch.from_numpy(draft_lens))
        np.testing.assert_array_equal(out_t.numpy(), out_j)
        np.testing.assert_allclose(kt.numpy()[:, live], kj[:, live], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(vt.numpy()[:, live], vj[:, live], rtol=1e-5, atol=1e-5)
    accepted = [p[1][:, 0] for p in jax_runs["verify"]]
    assert accepted[0].max() < VERIFY_K and list(accepted[-1]) == list(draft_lens)


def test_verify_step_refusals():
    _, cfg, _, _, _ = _model()
    with pytest.raises(ValueError, match="K >= 1"):
        build_paged_verify_step(cfg, 0)
    with pytest.raises(NotImplementedError, match="alibi"):
        build_paged_verify_step(TransformerConfig(**dict(CFG, position="alibi")), 2)


# --- servers ------------------------------------------------------------------------------
@pytest.mark.parametrize("drafter", DRAFTERS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_spec_server_streams_and_stats_equal_jax(mode, drafter, jax_runs):
    """Six requests through four slots (budgets 1 to 12, so drafts clamp
    and rows join mid-stream): byte-identical to the JAX spec server and to
    speculation-off, with the speculation stats, the dispatch count and the
    window breaks equal to JAX's."""
    _, _, st = _run_case((mode, drafter), jax_runs)
    assert st["spec_rounds"] >= 1 and st["spec_drafted"] > 0
    if drafter == "oracle":
        assert st["spec_accepted"] == st["spec_drafted"] and st["spec_accept_rate"] == 1.0
        assert st["dispatches"] < sum([10, 3, 7, 12, 1, 5])
    elif drafter.startswith("oracle_corrupt"):
        at = int(drafter[-1])
        assert st["spec_accepted"] < st["spec_drafted"]
        assert all(n == 0 for i, n in enumerate(st["spec_accept_hist"]) if i > at)
    if mode == "windows":
        assert st["window_break_reasons"]["draft"] >= 1


@pytest.mark.parametrize("mode", ["ragged", "bucketed"])
def test_spec_eos_inside_accepted_run(mode, jax_runs):
    """EOS inside an accepted draft run retires the request at the EOS
    token, as sequential decoding does."""
    prompts = _prompts(2, seed=7)
    _, outs, _ = _run_case(("eos", mode), jax_runs)
    assert outs[0].size == prompts[0].size + 3


def test_spec_draft_clamped_to_budget():
    """A drafter offering more than the budget is clamped to budget - 1: a
    1-token request never verifies, no output passes its budget."""
    prompts = _prompts(3, seed=8)
    budgets = [1, 2, 6]
    ref = _off(prompts, budgets)

    class Greedy(ConstantDrafter):
        asked = []

        def propose(self, uid, context, k):
            self.asked.append((uid, k))
            return super().propose(uid, context, 10)  # ignores k: the server must clamp

    drafter = Greedy(1)
    port = _server(ragged=False, drafter=drafter)
    outs = port.serve(prompts, max_new_tokens=budgets)
    for p, n, out, r in zip(prompts, budgets, outs, ref):
        np.testing.assert_array_equal(out, r)
        assert out.size == p.size + n
    assert all(k <= 4 and uid != 0 for uid, k in drafter.asked)


def test_spec_preemption_token_exact(jax_runs):
    """An undersized pool preempts while drafts widen each row's page
    demand: streams, stats and preemptions equal JAX's, the pool drains;
    the bucketed oracle's streams equal speculation-off."""
    port, _, _ = _run_case(("preempt", "ragged"), jax_runs)
    assert port.stats["preempted"] >= 1
    prompts, budgets, _, kw, ours, _, ref = _case(("preempt", "bucketed"))
    port = _server(**kw, **ours)
    for a, b in zip(port.serve(prompts, max_new_tokens=budgets), ref):
        np.testing.assert_array_equal(a, b)
    assert port.stats["preempted"] >= 1 and port.pool.used_pages() == 0


def test_spec_admission_mid_stream():
    """Requests submitted while speculative rounds run join without
    disturbing the streams."""
    prompts = _prompts(4, seed=6)
    ref = _off(prompts, 12)
    server = _server(drafter=OracleDrafter(dict(enumerate(ref))))
    first = [server.submit(p, max_new_tokens=12) for p in prompts[:2]]
    for _ in range(3):
        server.step()
    assert server.stats["spec_rounds"] >= 1
    late = [server.submit(p, max_new_tokens=12) for p in prompts[2:]]
    results = server.run()
    for uid, want in zip(first + late, ref):
        np.testing.assert_array_equal(results[uid], want)


@pytest.mark.parametrize("ragged", [True, False])
def test_spec_round_pages_roll_back(ragged):
    """After a reject-all round the slot holds exactly the accepted tokens
    and the pages they need; the drafted tail's pages are free again."""
    prompt = _prompts(1, seed=13, lo=5, hi=6)[0]
    server = _server(ragged=ragged, page_size=4, drafter=ConstantDrafter(3))
    uid = server.submit(prompt, max_new_tokens=12)
    server.step()  # prefill (and in bucketed mode the first round)
    if not ragged:
        assert server.stats["spec_rounds"] == 1
    else:
        server.step()
    req = server._active[0]
    pool = server.pool
    for _ in range(3):
        acc0 = server.stats["spec_accepted"]
        n0 = int(pool.seq_lens[req.slot])
        rounds = server.stats["spec_rounds"]
        server.step()
        assert server.stats["spec_rounds"] == rounds + 1
        got = int(pool.seq_lens[req.slot])
        assert got == n0 + (server.stats["spec_accepted"] - acc0) + 1
        assert pool._owned[req.slot] == pool.pages_for(got)
    server.run()
    assert server.take_result(uid) is not None and pool.used_pages() == 0


def test_rejected_draft_page_never_published():
    """With the prefix cache on and pages of 4, rejected drafts fill whole
    pages that roll back: after every step no chained page runs past the
    slot's accepted length, and a later request whose prompt is this one's
    output (so it attaches the published pages) streams as without
    speculation."""
    prompts = _prompts(2, seed=21, lo=6, hi=9)
    kw = dict(page_size=4, prefix_cache=True)
    ref = _off(prompts, 14, **kw)
    server = _server(drafter=ConstantDrafter(5), **kw)
    uids = [server.submit(p, max_new_tokens=14) for p in prompts]
    while server.has_work():
        server.step()
        for r in server._active:
            chained = len(server.pool._chain_keys[r.slot])
            assert chained * 4 <= int(server.pool.seq_lens[r.slot]) <= r.context().size
        server.pool.integrity_check()
    for uid, want in zip(uids, ref):
        np.testing.assert_array_equal(server.take_result(uid), want)
    follow = [r[:-2] for r in ref]
    want = _off(follow, 6, **kw)
    hits = server.pool.prefix_stats()["prefix_hit_tokens"]
    got = server.serve(follow, max_new_tokens=6)
    assert server.pool.prefix_stats()["prefix_hit_tokens"] > hits
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --- knobs -----------------------------------------------------------------------------------
@pytest.mark.parametrize("mode", sorted(MODES))
def test_spec_knob_through_engine(mode):
    """``spec_decode.enable`` through ``init_inference`` builds and serves in
    the three modes, byte-identical to the engine without it, with the
    speculation block in ``serve_stats()``."""
    _, cfg, _, tree, _ = _model()
    prompts = _motif_prompts(3, seed=9)
    paged = dict(PAGED, ragged=MODES[mode]["ragged"])
    if mode == "windows":
        paged["multi_step"] = {"enable": True, "horizon": H}
    outs = {}
    for enable in (True, False):
        engine = dst.init_inference(TransformerLM(cfg), dtype="fp32", device="cpu", paged_kv=paged,
                                    spec_decode={"enable": enable, "max_draft": 4, "ngram_order": 3})
        engine.load_jax_params(tree)
        outs[enable] = engine.serve(prompts, max_new_tokens=20)
        st = engine.serve_stats()
        if enable:
            assert st["spec_rounds"] >= 1 and len(st["spec_accept_hist"]) == 5
            for key in ("spec_accept_rate", "spec_mean_accepted_per_round", "spec_drafted", "spec_accepted"):
                assert key in st, key
        else:
            assert st["spec_rounds"] == 0 and engine._paged_server.drafter is None
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", [{"enable": True, "max_draft": 0}, {"enable": True, "spec_lens": [0, 2]}])
def test_spec_bad_lengths_raise_as_jax(spec):
    jcfg, _, params, _, _ = _model()
    with pytest.raises(ValueError, match="max_draft"):
        _server(spec_decode=spec)
    with pytest.raises(ValueError, match="max_draft"):
        JaxServer(jcfg, params, spec_decode=spec, **PAGED)


def test_widths_follow_the_draft_cap():
    """The ragged widths: draft_cap + 1 for decode and verify steps, the
    larger of it and the chunk for mixed ones (JAX's two widths)."""
    s = _server(spec_decode={"enable": True, "max_draft": 6, "spec_lens": [2, 3]})
    assert (s._draft_cap, s._ragged_w_decode, s._ragged_w_mixed) == (3, 4, 8)
    s = _server(spec_decode={"enable": True, "max_draft": 12}, prefill_chunk=8)
    assert (s._draft_cap, s._ragged_w_decode, s._ragged_w_mixed) == (12, 13, 13)
    s = _server()
    assert (s.drafter, s._ragged_w_decode, s._ragged_w_mixed) == (None, 1, 8)
