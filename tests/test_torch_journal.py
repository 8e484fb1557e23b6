"""The port's crash-recovery journal and chaos points against the JAX
package's, on the CPU.

Mirrors tests/unit/inference/test_journal_recovery.py where it applies, on
its tiny llama-style GQA model in fp32 (weights from the JAX
``TransformerLM.init`` through ``load_jax_params``).

* journal units: roundtrip, timing stamps, a seeded re-submit, implicit
  finish, rotation across segments, a torn tail dropped (once and after two
  crashes), a corrupt sealed segment and valid records after a bad one
  raising, the ``journal.append`` chaos point with ``truncate``;
* the format: the same records written by both packages give byte-identical
  segment files, and a journal written by either replays in the other to
  equal states; a JAX server killed mid-serve recovers in the port's server
  and the reverse, with streams equal to the uncrashed run;
* the chaos module: rules, actions, the seeded schedule;
* serving: ``serve.mid_step`` kills (ragged, bucketed, speculative, prefix
  cache) and ``serve.mid_window`` kills recover through a fresh engine on
  the same directory with streams byte-identical to the uncrashed run;
  finished results survive, new uids continue, recovery compacts and
  retires segments, one sync a step (a window's tokens share one), a live
  ``compact_journal``, the knobs.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import journal as jax_journal
from deepspeed_tpu.inference.scheduler import PagedServer as JaxServer
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models.config import TransformerConfig as JaxConfig
from deepspeed_tpu.utils import chaos as jax_chaos
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.inference import journal as port_journal
from deepspeed_tpu_torch.inference.journal import JournalCorruptError, RequestJournal
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.inference.spec_decode import Drafter
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.utils import chaos

CFG = dict(
    vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=96,
    norm="rmsnorm", position="rope", activation="swiglu", use_bias=False, tie_embeddings=False,
    flash_attention=False, dtype="float32",
)
PAGED = {"page_size": 8, "max_slots": 4, "prefill_chunk": 8}
MS = {"multi_step": {"enable": True, "horizon": 4}}

_rs = np.random.RandomState(0)
PROMPTS = [_rs.randint(0, CFG["vocab_size"], (12,)).astype(np.int32) for _ in range(4)]
SHARED = _rs.randint(0, CFG["vocab_size"], (16,)).astype(np.int32)  # a shared system prompt
SHARED_PROMPTS = [np.concatenate([SHARED, _rs.randint(0, CFG["vocab_size"], (6 + i,)).astype(np.int32)])
                  for i in range(3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    chaos.uninstall()
    jax_chaos.uninstall()


_MODEL = {}


def _model():
    """(jax cfg, port cfg, jax params, numpy tree), built once."""
    if not _MODEL:
        jcfg = JaxConfig(**CFG)
        params = JaxLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        _MODEL["m"] = (jcfg, TransformerConfig(**CFG), params, jax.tree_util.tree_map(np.asarray, params))
    return _MODEL["m"]


def _engine(journal_dir=None, spec=None, **paged_over):
    """A fresh fp32 engine on the CPU with its server built (and, on a
    journal that holds records, recovered), as a restarted process has it."""
    _, cfg, _, tree = _model()
    kw = dict(dtype="fp32", device="cpu", paged_kv={**PAGED, **paged_over})
    if journal_dir is not None:
        kw["journal"] = {"enabled": True, "dir": str(journal_dir)}
    if spec is not None:
        kw["spec_decode"] = spec
    eng = dst.init_inference(TransformerLM(cfg), **kw)
    eng.load_jax_params(tree)
    eng._paged_server = eng._build_paged_server()
    return eng


def _crash(srv, point, hit):
    """Run ``srv`` until the armed point kills it at its ``hit``-th arrival."""
    chaos.install(chaos.ChaosSchedule([chaos.ChaosRule(point, hit=hit)]))
    with pytest.raises(chaos.ChaosKilled):
        srv.run()
    chaos.uninstall()


# --- journal units -------------------------------------------------------------------------
class TestJournalUnits:
    def test_roundtrip_submit_emit_finish(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        j.append_submit(0, np.asarray([1, 2, 3], np.int32), 8, None, "default")
        j.append_emit(0, 7)
        j.append_emit(0, 9)
        j.append_submit(1, np.asarray([4], np.int32), 4, 3, "tenantB")
        j.append_finish(0)
        j.sync()
        states, next_uid = RequestJournal.replay(str(tmp_path))
        assert next_uid == 2
        assert states[0].finished and states[0].generated == [7, 9]
        np.testing.assert_array_equal(states[0].prompt, [1, 2, 3])
        assert not states[1].finished and states[1].eos_token_id == 3 and states[1].tenant == "tenantB"

    def test_replay_preserves_timing_stamps(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        j.append_submit(0, np.asarray([1, 2], np.int32), 8, None, "default", t_submit=2.5)
        j.append_first_token(0, 3.25)
        j.append_emit(0, 7)
        j.append_submit(1, np.asarray([4], np.int32), 4, None, "default")
        j.sync()
        states, _ = RequestJournal.replay(str(tmp_path))
        assert states[0].t_submit == 2.5 and states[0].t_first == 3.25
        assert states[1].t_submit is None and states[1].t_first is None

    def test_seeded_resubmit_replaces_state(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        j.append_submit(0, np.asarray([1], np.int32), 8, None, "default")
        j.append_emit(0, 5)
        j.append_submit(0, np.asarray([1], np.int32), 8, None, "default", generated=[5])
        j.append_emit(0, 6)
        j.sync()
        states, _ = RequestJournal.replay(str(tmp_path))
        assert states[0].generated == [5, 6]

    def test_implicit_done_budget_and_eos(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        j.append_submit(0, np.asarray([1], np.int32), 2, None, "default")
        j.append_emit(0, 5)
        j.append_emit(0, 6)  # budget reached; the crash ate the finish record
        j.append_submit(1, np.asarray([1], np.int32), 8, 3, "default")
        j.append_emit(1, 3)  # EOS
        j.sync()
        states, _ = RequestJournal.replay(str(tmp_path))
        assert states[0].done and states[1].done

    def test_segment_rotation_and_cross_segment_replay(self, tmp_path):
        j = RequestJournal(str(tmp_path), segment_bytes=128)
        j.append_submit(0, np.arange(8, dtype=np.int32), 64, None, "default")
        j.sync()
        for t in range(20):
            j.append_emit(0, t)
            j.sync()
        assert j.segments_sealed >= 2
        assert any(n.endswith(".jrnl") for n in os.listdir(tmp_path))
        states, _ = RequestJournal.replay(str(tmp_path))
        assert states[0].generated == list(range(20))

    def test_torn_tail_of_active_segment_is_dropped(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        j.append_submit(0, np.asarray([1], np.int32), 8, None, "default")
        for t in range(4):
            j.append_emit(0, t)
        j.sync()
        path = os.path.join(tmp_path, [n for n in os.listdir(tmp_path) if n.endswith(".open")][0])
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 7)
        states, _ = RequestJournal.replay(str(tmp_path))
        assert states[0].generated == [0, 1, 2]

    def test_double_crash_torn_tails_stay_tolerable(self, tmp_path):
        j1 = RequestJournal(str(tmp_path))
        j1.append_submit(0, np.asarray([1], np.int32), 8, None, "default")
        j1.append_emit(0, 4)
        j1.sync()
        seg0 = os.path.join(tmp_path, "seg_000000.open")
        with open(seg0, "r+b") as f:
            f.truncate(os.path.getsize(seg0) - 5)
        states, _ = RequestJournal.replay(str(tmp_path))
        assert states[0].generated == []
        j2 = RequestJournal(str(tmp_path))  # the recovery writer opens seg_000001
        j2.append_submit(0, np.asarray([1], np.int32), 8, None, "default", generated=[])
        j2.append_emit(0, 4)
        j2.sync()
        states, _ = RequestJournal.replay(str(tmp_path))
        assert states[0].generated == [4] and len(RequestJournal.segments(str(tmp_path))) == 2

    def test_corrupt_sealed_segment_raises(self, tmp_path):
        j = RequestJournal(str(tmp_path), segment_bytes=1)  # seal every sync
        j.append_submit(0, np.asarray([1], np.int32), 8, None, "default")
        j.sync()
        assert j.segments_sealed == 1
        path = os.path.join(tmp_path, [n for n in os.listdir(tmp_path) if n.endswith(".jrnl")][0])
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 5)
        with pytest.raises(JournalCorruptError, match="sealed"):
            RequestJournal.replay(str(tmp_path))
        assert RequestJournal.has_records(str(tmp_path))

    def test_valid_records_after_a_bad_one_raise(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        j.append_submit(0, np.asarray([1], np.int32), 8, None, "default")
        j.append_emit(0, 1)
        j.append_emit(0, 2)
        j.sync()
        path = os.path.join(tmp_path, [n for n in os.listdir(tmp_path) if n.endswith(".open")][0])
        with open(path, "rb") as f:
            lines = f.readlines()
        lines[1] = b"deadbeef corrupted-not-torn\n"  # damage mid-file
        with open(path, "wb") as f:
            f.writelines(lines)
        with pytest.raises(JournalCorruptError, match="valid records after"):
            RequestJournal.replay(str(tmp_path))

    def test_chaos_truncate_at_append_is_survivable(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        j.append_submit(0, np.asarray([1], np.int32), 8, None, "default")
        j.sync()
        j.append_emit(0, 1)
        chaos.install(chaos.ChaosSchedule([chaos.ChaosRule("journal.append", action="truncate", nbytes=5)]))
        with pytest.raises(chaos.ChaosKilled):
            j.sync()
        chaos.uninstall()
        states, _ = RequestJournal.replay(str(tmp_path))
        assert states[0].generated == []
        np.testing.assert_array_equal(states[0].prompt, [1])


# --- the format, across the two packages ----------------------------------------------------
def _write(mod, directory):
    """One record sequence through a package's writer: every record kind,
    stamps, seeded and plain submits, rotation at 256 bytes, a compaction."""
    j = mod.RequestJournal(str(directory), segment_bytes=256, fsync=False)
    j.append_submit(0, np.asarray([5, 6, 7], np.int32), 9, None, "default", t_submit=1.5)
    j.append_first_token(0, 2.75)
    for t in (11, 12, 13):
        j.append_emit(0, t)
        j.sync()
    j.append_submit(1, np.arange(20, dtype=np.int32), 4, 2, "tenantB", generated=[3, 4])
    j.append_emit(1, 2)
    j.append_finish(1)
    j.sync()
    j.begin_compaction()
    j.append_submit(0, np.asarray([5, 6, 7], np.int32), 9, None, "default", generated=[11, 12, 13], t_submit=1.5,
                    t_first=2.75)
    j.append_submit(1, np.arange(20, dtype=np.int32), 4, 2, "tenantB", generated=[3, 4, 2])
    j.append_finish(1)
    j.sync()
    j.retire_older_segments()
    j.append_emit(0, 14)
    j.sync()
    return j


def _states(states):
    return {uid: (st.prompt.tolist(), st.max_new_tokens, st.eos_token_id, st.tenant, st.generated, st.finished,
                  st.t_submit, st.t_first, st.done) for uid, st in states.items()}


def test_journal_files_byte_identical_to_jax(tmp_path):
    """The same records through both writers give the same segment names
    and the same bytes, rotation and compaction included."""
    theirs, ours = _write(jax_journal, tmp_path / "jax"), _write(port_journal, tmp_path / "port")
    assert ours.segments_sealed == theirs.segments_sealed >= 1
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "port" / n).read_bytes(), n


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_across_packages(tmp_path, writer):
    """A journal written by either package replays in both to equal
    states (and the same next uid), torn tail included."""
    _write(jax_journal if writer == "jax" else port_journal, tmp_path)
    with open(os.path.join(tmp_path, "seg_999999.open"), "wb") as f:  # a torn record at the newest tail
        f.write(b"0123abcd {\"t\":\"e\",\"uid\":0,")
    ours, n_ours = RequestJournal.replay(str(tmp_path))
    theirs, n_theirs = jax_journal.RequestJournal.replay(str(tmp_path))
    assert n_ours == n_theirs == 2
    assert _states(ours) == _states(theirs)
    assert ours[0].generated == [11, 12, 13, 14] and ours[1].finished


# --- the chaos module ------------------------------------------------------------------------
def test_chaos_rules_and_seeded_schedule(tmp_path):
    """Rules fire once on their hit, ``ChaosKilled`` escapes ``except
    Exception``, ``corrupt`` rewrites the tail deterministically (as JAX's),
    bad rules raise, and a seed fixes the schedule."""
    with pytest.raises(ValueError):
        chaos.ChaosRule("serve.mid_step", action="nap")
    with pytest.raises(ValueError):
        chaos.ChaosRule("serve.mid_step", hit=0)
    sched = chaos.install(chaos.ChaosSchedule([chaos.ChaosRule("serve.mid_step", hit=2)]))
    chaos.point("serve.mid_step")
    with pytest.raises(chaos.ChaosKilled):
        try:
            chaos.point("serve.mid_step")
        except Exception:  # noqa: BLE001 - the kill must not be caught here
            pytest.fail("ChaosKilled was caught as an Exception")
    chaos.point("serve.mid_step")  # fired once only
    assert sched.fired_log == ["serve.mid_step#2:raise"] and chaos.active() is sched
    chaos.uninstall()
    assert chaos.active() is None
    for mod, name in ((chaos, "port"), (jax_chaos, "jax")):
        path = tmp_path / name
        path.write_bytes(bytes(range(40)))
        mod.install(mod.ChaosSchedule([mod.ChaosRule("journal.append", action="corrupt", nbytes=8)]))
        with pytest.raises(mod.ChaosKilled):
            mod.point("journal.append", path=str(path))
        mod.uninstall()
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes() != bytes(range(40))
    a = [(r.point, r.hit, r.action) for r in chaos.seeded_schedule(3, n_faults=4).rules]
    assert a == [(r.point, r.hit, r.action) for r in chaos.seeded_schedule(3, n_faults=4).rules]
    assert all(p in chaos.POINTS and 1 <= h <= 3 for p, h, _ in a)


# --- crash and recovery through the engine ---------------------------------------------------
def _reference(prompts, max_new, spec=None, **paged):
    return _engine(spec=spec, **paged).serve(prompts, max_new_tokens=max_new)


@pytest.mark.parametrize("mode,kill_step", [("ragged", 1), ("ragged", 3), ("bucketed", 4)])
def test_mid_step_crash_streams_resume_byte_identical(tmp_path, mode, kill_step):
    paged = {"ragged": mode == "ragged"}
    ref = _reference(PROMPTS, 16, **paged)
    srv = _engine(tmp_path, **paged)._paged_server
    uids = [srv.submit(p, max_new_tokens=16) for p in PROMPTS]
    _crash(srv, "serve.mid_step", kill_step)
    srv2 = _engine(tmp_path, **paged)._paged_server
    assert srv2.stats["recovered"] == len(PROMPTS)
    srv2.run()
    for uid, want in zip(uids, ref):
        np.testing.assert_array_equal(srv2.take_result(uid), want)
    srv2.pool.integrity_check()
    assert srv2.pool.used_pages() == 0


def test_recovery_with_prefix_cache_shared_prompts(tmp_path):
    """Recovery with the prefix cache on (shared system prompts): the
    streams stay byte-identical and the pool consistent."""
    ref = _reference(SHARED_PROMPTS, 12, prefix_cache=True)
    srv = _engine(tmp_path, prefix_cache=True)._paged_server
    uids = [srv.submit(p, max_new_tokens=12) for p in SHARED_PROMPTS]
    _crash(srv, "serve.mid_step", 4)
    srv2 = _engine(tmp_path, prefix_cache=True)._paged_server
    srv2.run()
    for uid, want in zip(uids, ref):
        np.testing.assert_array_equal(srv2.take_result(uid), want)
    srv2.pool.integrity_check()


class _Oracle(Drafter):
    """Drafts each request's known future, changing its second draft: the
    verify rows accept one draft of every round and reject the rest."""

    def __init__(self, futures):
        self.futures = futures

    def propose(self, uid, context, k):
        cont = self.futures[uid][context.size : context.size + k].astype(np.int32)
        if cont.size > 1:
            cont[1] = (cont[1] + 1) % CFG["vocab_size"]
        return cont


@pytest.mark.parametrize("mode", ["ragged", "bucketed", "windows"])
def test_spec_decode_streams_survive_crash(tmp_path, mode):
    """Speculative serving journals through the same emit path: a kill
    after some rounds recovers byte-identically (drafts are host scratch;
    only accepted tokens are journaled), with the rejected tails' pages
    back in the pool."""
    _, cfg, _, _ = _model()
    paged = {"ragged": mode != "bucketed", **(MS if mode == "windows" else {})}
    ref = _reference(PROMPTS, 16, **paged)  # speculation off
    params = _engine()._paged_server.params

    def server(journal):
        return PagedServer(cfg, params, device="cpu", drafter=_Oracle(dict(enumerate(ref))), journal=journal,
                           **{**PAGED, **paged})

    srv = server(RequestJournal(str(tmp_path)))
    uids = [srv.submit(p, max_new_tokens=16) for p in PROMPTS]
    _crash(srv, "serve.mid_step", 4)
    assert srv.stats["spec_rounds"] >= 1 and srv.stats["spec_accepted"] < srv.stats["spec_drafted"]
    states, next_uid = RequestJournal.replay(str(tmp_path))
    srv2 = server(RequestJournal(str(tmp_path)))
    assert srv2.recover(states, next_uid) == len(PROMPTS)
    srv2.run()
    for uid, want in zip(uids, ref):
        np.testing.assert_array_equal(srv2.take_result(uid), want)
    assert srv2.stats["spec_rounds"] >= 1 and srv2.pool.used_pages() == 0
    srv2.pool.integrity_check()


@pytest.mark.parametrize("hit", [1, 2])
def test_mid_window_crash_streams_resume_byte_identical(tmp_path, hit):
    """A kill inside a window's host phase (its tokens buffered, none
    durable) resumes from the last durable token, whether the restarted
    engine windows (hit 1) or not (hit 2)."""
    ref = _reference(PROMPTS, 16, **MS)
    srv = _engine(tmp_path, **MS)._paged_server
    uids = [srv.submit(p, max_new_tokens=16) for p in PROMPTS]
    _crash(srv, "serve.mid_window", hit)
    assert srv.stats["window_steps"] >= hit
    srv2 = _engine(tmp_path, **(MS if hit == 1 else {}))._paged_server
    assert srv2.stats["recovered"] == len(PROMPTS)
    srv2.run()
    for uid, want in zip(uids, ref):
        np.testing.assert_array_equal(srv2.take_result(uid), want)
    srv2.pool.integrity_check()


def test_finished_results_survive_restart(tmp_path):
    srv = _engine(tmp_path)._paged_server
    uids = [srv.submit(p, max_new_tokens=6) for p in PROMPTS]
    srv.run()
    done = {u: srv.take_result(u) for u in uids}
    srv2 = _engine(tmp_path)._paged_server  # a crash after completion, before the results were fetched
    assert srv2.stats["recovered"] == 0
    for u in uids:
        np.testing.assert_array_equal(srv2.take_result(u), done[u])


def test_new_submissions_after_recovery_get_fresh_uids(tmp_path):
    srv = _engine(tmp_path)._paged_server
    uids = [srv.submit(p, max_new_tokens=4) for p in PROMPTS[:2]]
    _crash(srv, "serve.mid_step", 1)
    srv2 = _engine(tmp_path)._paged_server
    new_uid = srv2.submit(PROMPTS[2], max_new_tokens=4)
    assert new_uid not in uids
    srv2.run()
    assert srv2.take_result(new_uid) is not None
    srv2.pool.integrity_check()


def test_recovery_compacts_and_retires_old_segments(tmp_path):
    """Repeated restarts do not grow the journal: each recovery journals
    the full state into one fresh segment and retires the rest."""
    srv = _engine(tmp_path)._paged_server
    uids = [srv.submit(p, max_new_tokens=6) for p in PROMPTS]
    srv.run()
    done = {u: srv._results[u] for u in uids}
    for _ in range(3):
        srv2 = _engine(tmp_path)._paged_server
        assert len(RequestJournal.segments(str(tmp_path))) == 1
        for u in uids:
            np.testing.assert_array_equal(srv2._results[u], done[u])


def test_live_compaction_and_journal_off(tmp_path):
    """``compact_journal`` on a live server leaves one segment that replays
    to the same state; without a journal nothing is written."""
    srv = _engine(tmp_path / "j")._paged_server
    uids = [srv.submit(p, max_new_tokens=8) for p in PROMPTS]
    for _ in range(3):
        srv.step()
    before = _states(RequestJournal.replay(str(tmp_path / "j"))[0])
    assert srv.compact_journal() >= 1 and srv.stats["journal_compactions"] == 1
    assert len(RequestJournal.segments(str(tmp_path / "j"))) == 1
    after = RequestJournal.replay(str(tmp_path / "j"))[0]
    assert {u: v[:6] for u, v in before.items()} == {u: v[:6] for u, v in _states(after).items()}
    srv.run()
    assert all(srv.take_result(u) is not None for u in uids)
    eng = _engine()
    eng.serve(PROMPTS[:2], max_new_tokens=4)
    assert eng._paged_server.journal is None and eng._paged_server.compact_journal() == 0
    assert sorted(os.listdir(tmp_path)) == ["j"]


def test_one_journal_sync_per_step(tmp_path):
    """Durability is paid once a scheduler step: a window's tokens share one
    sync, so syncs (past the submits') count the steps, well under the
    tokens emitted."""
    eng = _engine(tmp_path, **MS)
    srv = eng._paged_server
    calls = {"sync": 0, "steps": 0}
    sync, step = srv.journal.sync, srv.step

    def counted_sync():
        calls["sync"] += 1
        sync()

    def counted_step():
        calls["steps"] += 1
        step()

    srv.journal.sync, srv.step = counted_sync, counted_step
    outs = eng.serve(PROMPTS, max_new_tokens=13)
    for got, want in zip(outs, _reference(PROMPTS, 13, **MS)):
        np.testing.assert_array_equal(got, want)
    st = srv.serve_stats()
    assert st["window_steps"] >= 1
    assert calls["sync"] == calls["steps"] + len(PROMPTS) < st["emitted_tokens"]


def test_journal_knob_without_dir_raises():
    _, cfg, _, tree = _model()
    eng = dst.init_inference(TransformerLM(cfg), dtype="fp32", device="cpu", paged_kv=PAGED,
                             journal={"enabled": True})
    eng.load_jax_params(tree)
    with pytest.raises(ValueError, match="journal.dir"):
        eng.serve(PROMPTS[:1], max_new_tokens=2)


def test_journal_knob_through_serve(tmp_path):
    """``journal.enabled`` through ``init_inference`` and ``serve``: every
    request journaled and finished; a second engine on the directory
    serves new requests after recovering nothing live."""
    _, cfg, _, tree = _model()
    kw = dict(dtype="fp32", device="cpu", paged_kv=PAGED, journal={"enabled": True, "dir": str(tmp_path)})
    eng = dst.init_inference(TransformerLM(cfg), **kw)
    eng.load_jax_params(tree)
    outs = eng.serve(PROMPTS, max_new_tokens=5)
    states, next_uid = RequestJournal.replay(str(tmp_path))
    assert next_uid == len(PROMPTS) and all(states[u].finished for u in range(len(PROMPTS)))
    for u, out in enumerate(outs):
        np.testing.assert_array_equal(np.concatenate([states[u].prompt, states[u].generated]), out)
    eng2 = dst.init_inference(TransformerLM(cfg), **kw)
    eng2.load_jax_params(tree)
    again = eng2.serve(PROMPTS[:1], max_new_tokens=5)
    np.testing.assert_array_equal(again[0], outs[0])
    assert eng2.serve_stats()["recovered"] == 0


# --- a crash in one package, the recovery in the other -----------------------------------------
@pytest.fixture(scope="module")
def jax_crash(tmp_path_factory):
    """A JAX server (XLA attention, fp32) killed at ``serve.mid_step`` hit 3
    with its journal, its uncrashed streams, and its replay of a port
    journal killed the same way; made in one fixture (the suite drops JAX's
    compiled programs after each test)."""
    jcfg, _, params, _ = _model()
    root = tmp_path_factory.mktemp("cross")

    def jax_server(d=None):
        journal = jax_journal.RequestJournal(str(d)) if d is not None else None
        return JaxServer(jcfg, params, attn_impl="xla", dtype=jnp.float32, journal=journal, **PAGED)

    ref = [np.asarray(o) for o in jax_server().serve(PROMPTS, max_new_tokens=16)]
    srv = jax_server(root / "jax")
    for p in PROMPTS:
        srv.submit(p, max_new_tokens=16)
    jax_chaos.install(jax_chaos.ChaosSchedule([jax_chaos.ChaosRule("serve.mid_step", hit=3)]))
    with pytest.raises(jax_chaos.ChaosKilled):
        srv.run()
    jax_chaos.uninstall()
    # the port's journal, killed at the same point, recovered by a JAX server
    port = _engine(root / "port")._paged_server
    for p in PROMPTS:
        port.submit(p, max_new_tokens=16)
    _crash(port, "serve.mid_step", 3)
    jax_states, next_uid = jax_journal.RequestJournal.replay(str(root / "port"))
    rec = jax_server(root / "port_by_jax")
    rec.recover(jax_states, next_uid)
    rec.run()
    return dict(root=root, ref=ref, jax_recovered=[np.asarray(rec.take_result(u)) for u in range(len(PROMPTS))])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_crash_in_one_package_recovers_in_the_other(jax_crash, direction):
    """A server killed at ``serve.mid_step`` (hit 3) in one package resumes
    in the other from its journal, byte-identical to the uncrashed JAX
    streams (which the port's uncrashed streams equal)."""
    ref = jax_crash["ref"]
    for a, b in zip(_reference(PROMPTS, 16), ref):
        np.testing.assert_array_equal(a, b)
    if direction == "port_to_jax":
        outs = jax_crash["jax_recovered"]
    else:
        srv = _engine(jax_crash["root"] / "jax")._paged_server
        assert srv.stats["recovered"] == len(PROMPTS)
        srv.run()
        outs = [srv.take_result(u) for u in range(len(PROMPTS))]
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, b)
