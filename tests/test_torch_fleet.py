"""The port's serving fleet (ROADMAP S7) against the JAX package's, on the
CPU.

Every scenario runs twice through one runner: on a fleet of port replicas
and on a fleet of JAX replicas (the same tiny fp32 llama-style GQA model,
the same prompts, the same calls), mirroring
tests/unit/inference/test_fleet.py. Held equal between the two: each
request's replica (the routing), the uids, every stream, ``fleet_stats()``
(counters, replica states and loads, ring nodes) and the merged
``serve_stats()`` counters; ``migrated_token_divergence`` is 0 and the
streams equal a single port server's. Scenarios:

* a healthy fleet; a migration mid decode and mid prefill; a drain (its
  journal compacted to at most one segment); a migration with no target
  (the request put back); one onto a journal-less replica (the source
  keeps its claim until the output is delivered);
* ``fleet.replica_kill`` with journals (re-routed from the journal) and
  without (the router's shadow submissions); ``fleet.mid_migration``;
  ``fleet.mid_drain``; the circuit breaker and the health probe;
* ``adopt_journal`` of a JAX-written and of a port-written journal (the
  uid floor raised past the adopted uids), and a journal catch-up join;
* the prefill/decode role split (migration at the first decode token);
* ``replay`` of a two-tenant ``make_trace`` across SLA replicas with a
  mid-trace kill under a ``VirtualClock``: the whole report equal;
* the host units: ``prefix_chain_keys``, ``ConsistentHashRing``,
  ``valid_fleet_sizes``, ``FleetResizePolicy`` decisions and
  ``autoscale_step``.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.elasticity import fleet_policy as jax_fleet_policy
from deepspeed_tpu.inference import fleet as jax_fleet
from deepspeed_tpu.inference import journal as jax_journal
from deepspeed_tpu.inference import traffic as jax_traffic
from deepspeed_tpu.inference.scheduler import PagedServer as JaxServer
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models.config import TransformerConfig as JaxConfig
from deepspeed_tpu.utils import chaos as jax_chaos
from deepspeed_tpu.utils import loadgen as jax_loadgen
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.elasticity import fleet_policy
from deepspeed_tpu_torch.inference import fleet, journal, traffic
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.utils import chaos, loadgen

CFG = dict(
    vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=64,
    norm="rmsnorm", position="rope", activation="swiglu", use_bias=False, tie_embeddings=False,
    flash_attention=False, dtype="float32",
)
# chunks of 1: prefill and decode rows share the ragged step's one width, so each JAX fleet compiles one
# program (the suite's conftest drops JAX's compiled programs after every test)
GEOMETRY = dict(page_size=8, max_slots=4, prefill_chunk=1, prefix_cache=True)


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
    """(jax cfg, port cfg, jax params, port param tree), built once."""
    if not _MODEL:
        jcfg = JaxConfig(**CFG)
        params = JaxLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        tree = jax.tree_util.tree_map(np.asarray, params)
        cfg = TransformerConfig(**CFG)
        _MODEL["m"] = (jcfg, cfg, params, load_jax_params(TransformerLM(cfg), tree, device="cpu").param_tree())
    return _MODEL["m"]


def _port_server(journal_dir=None, **kw):
    _, cfg, _, ptree = _model()
    jrnl = journal.RequestJournal(journal_dir) if journal_dir else None
    return PagedServer(cfg, ptree, device="cpu", journal=jrnl, **{**GEOMETRY, **kw})


def _jax_server(journal_dir=None, **kw):
    jcfg, _, params, _ = _model()
    jrnl = jax_journal.RequestJournal(journal_dir) if journal_dir else None
    return JaxServer(jcfg, params, attn_impl="xla", dtype=jnp.float32, journal=jrnl, **{**GEOMETRY, **kw})


PORT = SimpleNamespace(name="port", fleet=fleet, chaos=chaos, journal=journal, traffic=traffic, loadgen=loadgen,
                       policy=fleet_policy, server=_port_server)
JAX = SimpleNamespace(name="jax", fleet=jax_fleet, chaos=jax_chaos, journal=jax_journal, traffic=jax_traffic,
                      loadgen=jax_loadgen, policy=jax_fleet_policy, server=_jax_server)


def _server(ns, journal_dir=None, tenants=None, **kw):
    srv = ns.server(journal_dir, **kw)
    if tenants:
        srv = ns.traffic.MultiTenantServer(srv, tenants=[ns.traffic.TenantSpec(**t) for t in tenants])
    return srv


def _fleet(ns, n=2, tmp=None, names=None, tenants=None, journals=None, **router_kw):
    handles = []
    for i in range(n):
        name = names[i] if names else f"r{i}"
        use = tmp is not None and (journals is None or journals[i])
        jdir = os.path.join(str(tmp), ns.name, name) if use else None
        handles.append(ns.fleet.ReplicaHandle(name=name, server=_server(ns, jdir, tenants), journal_dir=jdir))
    return ns.fleet.FleetRouter(handles, **router_kw)


def _prompts(seed=7, n=6, shared_frac=2):
    rs = np.random.RandomState(seed)
    sysp = rs.randint(0, CFG["vocab_size"], (16,)).astype(np.int32)
    out = []
    for i in range(n):
        tail = rs.randint(0, CFG["vocab_size"], (int(rs.randint(3, 8)),)).astype(np.int32)
        out.append(np.concatenate([sysp, tail]) if i % shared_frac == 0 else tail)
    return out


_SINGLE = {}


def _single(prompts, budgets):
    """Streams of one uninterrupted port server: the oracle every fleet
    stream must equal."""
    key = (tuple(p.tobytes() for p in prompts), tuple(budgets))
    if key not in _SINGLE:
        _SINGLE[key] = _port_server().serve(prompts, max_new_tokens=list(budgets))
    return _SINGLE[key]


def _fleet_stats(router):
    s = router.fleet_stats()
    for rec in s["replicas"].values():
        rec["journal_dir"] = None if rec["journal_dir"] is None else os.path.basename(rec["journal_dir"])
    return s


MERGED_KEYS = ("admitted", "preempted", "finished", "recovered", "migrated_out", "migrated_in",
               "journal_compactions", "prefill_chunks", "ragged_steps", "dispatches", "emitted_tokens",
               "decode_steps", "prefix_cached_tokens", "dispatches_per_token")


def _observe(router, uids):
    """What the two fleets must agree on."""
    merged = router.serve_stats()
    return dict(
        outs=[None if u is None else router.take_result(u) for u in uids],
        fleet=_fleet_stats(router),
        merged={k: merged[k] for k in MERGED_KEYS},
        tenants={t: {k: rec[k] for k in ("submitted", "finished", "tokens")} for t, rec in merged["tenants"].items()},
        latencies=(merged["ttft_ms"]["count"], merged["tpot_ms"]["count"]),
        prefix_hits=merged["prefix"]["prefix_hit_tokens"],
    )


def _both(scenario, tmp_path, **kw):
    """Run ``scenario(ns, tmp)`` on the port and on JAX; assert the
    observations equal and every stream the single-server oracle's."""
    got = {ns.name: scenario(ns, tmp_path, **kw) for ns in (PORT, JAX)}
    port, ref = got["port"], got["jax"]
    assert port["uids"] == ref["uids"]
    assert port["where"] == ref["where"]  # routing decisions, step by step
    obs, jobs = port["obs"], ref["obs"]
    for a, b in zip(obs["outs"], jobs["outs"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for key in ("fleet", "merged", "tenants", "latencies", "prefix_hits"):
        assert obs[key] == jobs[key], key
    assert obs["fleet"]["migrated_token_divergence"] == 0
    if "prompts" in port:
        for out, want in zip(obs["outs"], _single(port["prompts"], port["budgets"])):
            np.testing.assert_array_equal(out, want)
    return port


def _submit(router, prompts, budgets, tenants=None):
    tenants = tenants or ["default"] * len(prompts)
    return [router.submit(p, max_new_tokens=n, tenant=t) for p, n, t in zip(prompts, budgets, tenants)]


def _run(router, uids, prompts, budgets, where, extra=None):
    router.run()
    where.append(dict(router._where))
    return dict(uids=uids, where=where, prompts=prompts, budgets=budgets, obs=_observe(router, uids), **(extra or {}))


# --- healthy fleet, migration, drain -------------------------------------------------------------
def _healthy(ns, tmp):
    router = _fleet(ns, n=2, tmp=tmp)
    prompts, budgets = _prompts(n=8), [8, 5, 10, 6, 7, 9, 4, 8]
    uids = _submit(router, prompts, budgets)
    where = [dict(router._where)]
    served = None
    out = _run(router, uids, prompts, budgets, where)
    served = {n: h.inner.stats["finished"] for n, h in router.replicas.items()}
    out["served"] = served
    return out


def test_healthy_fleet_routes_and_streams_like_jax(tmp_path):
    port = _both(_healthy, tmp_path)
    assert sum(port["served"].values()) == 8 and min(port["served"].values()) > 0  # both replicas served
    assert port["obs"]["fleet"]["routed"] == 8 and port["obs"]["latencies"][0] == 8
    bases = sorted(rec["uid_base"] for rec in port["obs"]["fleet"]["replicas"].values())
    assert bases == [0, fleet.UID_STRIDE]


def _mid_decode(ns, tmp):
    router = _fleet(ns, n=2, tmp=tmp)
    prompts, budgets = _prompts(seed=19, n=4), [12, 9, 11, 10]
    uids = _submit(router, prompts, budgets)
    where = [dict(router._where)]
    mid = None
    while mid is None:
        router.step()
        mid = next((r.uid for h in router.replicas.values() for r in h.inner._active
                    if len(r.generated) >= 2 and not r.done), None)
    src = router._where[mid]
    assert router.migrate(mid)
    assert router._where[mid] != src
    for h in router.replicas.values():
        h.inner.pool.integrity_check()
    where.append(dict(router._where))
    return _run(router, uids, prompts, budgets, where)


def _mid_prefill(ns, tmp):
    router = _fleet(ns, n=2, tmp=tmp)
    rs = np.random.RandomState(23)
    prompts, budgets = [rs.randint(0, 128, (28,)).astype(np.int32) for _ in range(2)], [8, 6]
    uids = _submit(router, prompts, budgets)
    router.step()
    mid = next(r.uid for h in router.replicas.values() for r in h.inner._active
               if r.pending is None and 0 < r.consumed < r.prompt.size)
    assert router.migrate(mid)
    return _run(router, uids, prompts, budgets, [dict(router._where)])


@pytest.mark.parametrize("when", ["mid_decode", "mid_prefill"])
def test_migration_matches_jax(tmp_path, when):
    port = _both({"mid_decode": _mid_decode, "mid_prefill": _mid_prefill}[when], tmp_path)
    assert port["obs"]["fleet"]["migrations"] == 1
    assert port["obs"]["merged"]["migrated_in"] == port["obs"]["merged"]["migrated_out"] == 1


def _drain(ns, tmp):
    router = _fleet(ns, n=2, tmp=tmp)
    prompts, budgets = _prompts(seed=29, n=6), [9, 7, 11, 8, 10, 6]
    uids = _submit(router, prompts, budgets)
    for _ in range(4):
        router.step()
    victim = next(n for n, h in router.replicas.items() if h.inner.has_work())
    inner = router.replicas[victim].inner
    outstanding = inner.queued_count() + inner.live_count()
    moved = router.drain(victim)
    assert moved == outstanding >= 1 and not inner.has_work()
    assert router.replicas[victim].state == "drained" and victim not in router._ring.nodes()
    jdir = router.replicas[victim].journal_dir
    segments = len(ns.journal.RequestJournal.segments(jdir))
    states, _ = ns.journal.RequestJournal.replay(jdir)
    extra = router.submit(prompts[0], max_new_tokens=3)
    assert router._where[extra] != victim
    out = _run(router, uids + [extra], prompts + [prompts[0]], budgets + [3], [dict(router._where)])
    out.update(segments=segments, live_in_journal=sum(not st.done for st in states.values()), moved=moved)
    return out


def test_drain_matches_jax_and_compacts(tmp_path):
    port = _both(_drain, tmp_path)
    assert port["segments"] <= 1 and port["live_in_journal"] == 0
    assert port["obs"]["fleet"]["drains"] == 1 and port["obs"]["fleet"]["migrations"] == port["moved"]


def _no_target(ns, tmp):
    router = _fleet(ns, n=1, tmp=tmp)
    prompts, budgets = _prompts(seed=31, n=2), [8, 6]
    uids = _submit(router, prompts, budgets)
    for _ in range(3):
        router.step()
    inner = router.replicas["r0"].inner
    live = next(r.uid for r in inner._active if not r.done)
    with pytest.raises(RuntimeError, match="no active replica"):
        router.migrate(live)
    assert router._where[live] == "r0" and any(r.uid == live for r in list(inner._queue) + list(inner._active))
    assert inner.stats["migrated_out"] == inner.stats["migrated_in"] == 0
    with pytest.raises(RuntimeError):
        router.drain("r0")
    assert router.replicas["r0"].state == "active" and "r0" in router._ring.nodes()
    return _run(router, uids, prompts, budgets, [dict(router._where)])


def test_migration_without_target_puts_the_request_back_like_jax(tmp_path):
    _both(_no_target, tmp_path)


def _journal_less_target(ns, tmp):
    router = _fleet(ns, n=2, tmp=tmp, names=["src", "bare"], journals=[True, False])
    rs = np.random.RandomState(47)
    prompts, budgets, uids = [], [], []
    for _ in range(24):  # until one routes to the journaled replica
        p = rs.randint(0, 128, (int(rs.randint(6, 20)),)).astype(np.int32)
        uids.append(router.submit(p, max_new_tokens=7))
        prompts.append(p)
        budgets.append(7)
        if router._where.get(uids[-1]) == "src" and len(uids) >= 3:
            break
    for _ in range(3):
        router.step()
    inner = router.replicas["src"].inner
    victim = next(r.uid for r in list(inner._active) + list(inner._queue))
    acked = list(next((r.generated for r in inner._active if r.uid == victim), []))
    assert router.migrate(victim, target="bare")
    jdir = router.replicas["src"].journal_dir
    states, _ = ns.journal.RequestJournal.replay(jdir)
    kept = victim in states and not states[victim].done and list(states[victim].generated)[:len(acked)] == acked
    inner.compact_journal()
    states, _ = ns.journal.RequestJournal.replay(jdir)
    kept = kept and victim in states and not states[victim].done
    out = _run(router, uids, prompts, budgets, [dict(router._where)])
    states, _ = ns.journal.RequestJournal.replay(jdir)
    out.update(kept=kept, released=victim not in states or states[victim].done)
    return out


def test_journal_less_target_keeps_the_source_claim_like_jax(tmp_path):
    port = _both(_journal_less_target, tmp_path)
    assert port["kept"] and port["released"]


# --- failures ---------------------------------------------------------------------------------------
def _replica_kill(ns, tmp, hit, journals):
    router = _fleet(ns, n=2, tmp=tmp if journals else None)
    prompts, budgets = _prompts(n=6), [10, 7, 12, 8, 9, 11]
    uids = _submit(router, prompts, budgets)
    ns.chaos.install(ns.chaos.ChaosSchedule([ns.chaos.ChaosRule("fleet.replica_kill", hit=hit)]))
    try:
        router.run()
    finally:
        ns.chaos.uninstall()
    for h in router.replicas.values():
        if h.state != "dead":
            h.inner.pool.integrity_check()
    return _run(router, uids, prompts, budgets, [dict(router._where)])


@pytest.mark.parametrize("hit,journals", [(2, True), (5, True), (3, False)],
                         ids=["hit2-journal", "hit5-journal", "hit3-shadow"])
def test_replica_kill_matches_jax(tmp_path, hit, journals):
    """A chaos kill of one replica at a step arrival: its live requests
    re-route onto the survivor from its journal (or, without journals,
    from the router's shadow submissions, a full recompute)."""
    port = _both(_replica_kill, tmp_path, hit=hit, journals=journals)
    fs = port["obs"]["fleet"]
    assert fs["replica_kills"] == 1 and fs["n_active"] == 1 and fs["rerouted"] >= 1


def _mid_migration(ns, tmp):
    router = _fleet(ns, n=2, tmp=tmp)
    prompts, budgets = _prompts(seed=13, n=4), [10, 8, 9, 7]
    uids = _submit(router, prompts, budgets)
    for _ in range(5):
        router.step()
    live_uid = next(u for u in uids if u in router._where)
    src = router._where[live_uid]
    ns.chaos.install(ns.chaos.ChaosSchedule([ns.chaos.ChaosRule("fleet.mid_migration", hit=1)]))
    try:
        with pytest.raises(ns.chaos.ChaosKilled):
            router.migrate(live_uid)
    finally:
        ns.chaos.uninstall()
    router.fail_replica(src, reason="died mid-migration")  # the supervisor's move
    out = _run(router, uids, prompts, budgets, [dict(router._where)])
    out["n_results"] = len(out["obs"]["outs"])
    return out


def test_mid_migration_kill_matches_jax(tmp_path):
    port = _both(_mid_migration, tmp_path)
    assert all(o is not None for o in port["obs"]["outs"])


def _mid_drain(ns, tmp):
    router = _fleet(ns, n=2, tmp=tmp)
    prompts, budgets = _prompts(seed=17, n=5), [9, 8, 10, 7, 9]
    uids = _submit(router, prompts, budgets)
    for _ in range(4):
        router.step()
    victim = next(n for n, h in router.replicas.items() if h.inner.has_work())
    ns.chaos.install(ns.chaos.ChaosSchedule([ns.chaos.ChaosRule("fleet.mid_drain", hit=2)]))
    try:
        router.drain(victim)  # the router catches the kill
    finally:
        ns.chaos.uninstall()
    assert router.replicas[victim].state == "dead"
    return _run(router, uids, prompts, budgets, [dict(router._where)])


def test_mid_drain_kill_matches_jax(tmp_path):
    _both(_mid_drain, tmp_path)


def _breaker(ns, tmp):
    router = _fleet(ns, n=2, tmp=tmp, breaker_threshold=3)
    prompts, budgets = _prompts(seed=31, n=4), [8, 9, 7, 10]
    uids = _submit(router, prompts, budgets)
    for _ in range(2):
        router.step()
    victim = next(n for n, h in router.replicas.items() if h.inner.has_work())

    def boom():
        raise RuntimeError("wedged backend")

    router.replicas[victim].server.step = boom
    out = _run(router, uids, prompts, budgets, [dict(router._where)])
    out["dead"] = router.replicas[victim].state == "dead"
    return out


def test_circuit_breaker_matches_jax(tmp_path):
    port = _both(_breaker, tmp_path)
    assert port["dead"] and port["obs"]["fleet"]["replica_kills"] == 1


def test_health_probe_circuit_breaker():
    router = _fleet(PORT, n=2, breaker_threshold=2)
    name = next(iter(router.replicas))
    router.replicas[name].health_fn = lambda srv: False
    assert router.probe() == {name: False, "r1": True}
    assert router.replicas[name].state == "active"  # one strike
    router.probe()
    assert router.replicas[name].state == "dead"


# --- adoption and joins ----------------------------------------------------------------------------
def _adopt(ns, tmp, writer):
    """A one-replica fleet of package ``writer`` journals three requests,
    steps once and dies; a fresh fleet of ``ns`` on the same stride adopts
    its journal and allocates new uids past it."""
    old_dir = os.path.join(str(tmp), ns.name, "old")
    old = writer.fleet.FleetRouter([writer.fleet.ReplicaHandle(
        name="old", server=_server(writer, old_dir), journal_dir=old_dir)])
    prompts, budgets = _prompts(seed=37, n=3), [8, 7, 6]
    old_uids = _submit(old, prompts, budgets)
    old.step()
    del old
    fresh = _fleet(ns, n=1, tmp=tmp, names=["n0"])
    adopted = fresh.adopt_journal(old_dir)
    new_uid = fresh.submit(prompts[0], max_new_tokens=4)
    jdir = os.path.join(str(tmp), ns.name, "n1")
    h1 = fresh.join(_server(ns, jdir), name="n1", journal_dir=jdir)
    out = _run(fresh, old_uids + [new_uid], prompts + [prompts[0]], budgets + [4], [dict(fresh._where)])
    out.update(adopted=adopted, fresh_uid_clear=new_uid not in old_uids, floor=h1.inner._next_uid >= h1.uid_base)
    return out


@pytest.mark.parametrize("writer", ["jax", "port"], ids=["jax-journal", "port-journal"])
def test_adopt_journal_matches_jax(tmp_path, writer):
    """``adopt_journal`` of a journal either package wrote: the port's
    fleet adopting it matches JAX's fleet adopting the same kind."""
    w = JAX if writer == "jax" else PORT
    port = _both(lambda ns, tmp: _adopt(ns, tmp, w), tmp_path)
    assert port["adopted"] == 3 and port["fresh_uid_clear"] and port["floor"]
    assert port["obs"]["fleet"]["adopted"] == 3


def _catchup_join(ns, tmp):
    router = _fleet(ns, n=2, tmp=tmp)
    prompts, budgets = _prompts(seed=43, n=4), [10, 8, 9, 11]
    uids = _submit(router, prompts, budgets)
    for _ in range(4):
        router.step()
    victim = next(n for n, h in router.replicas.items() if h.inner.has_work())
    h = router.replicas[victim]
    h.state = "dead"  # gone without a re-route: its requests leave the router's tracking
    router._ring.remove(victim)
    dead = [u for u, n in router._where.items() if n == victim]
    for u in dead:
        del router._where[u]
    jdir = os.path.join(str(tmp), ns.name, "joiner")
    router.join(_server(ns, jdir), name="joiner", journal_dir=jdir, catchup_dir=h.journal_dir)
    out = _run(router, uids, prompts, budgets, [dict(router._where)])
    out["dead"] = len(dead)
    return out


def test_journal_catchup_join_matches_jax(tmp_path):
    port = _both(_catchup_join, tmp_path)
    assert port["obs"]["fleet"]["adopted"] >= port["dead"] >= 1 and port["obs"]["fleet"]["joins"] == 1


def test_geometry_guard():
    with pytest.raises(ValueError, match="pool geometry"):
        fleet.FleetRouter([fleet.ReplicaHandle(name="x", server=_port_server()),
                           fleet.ReplicaHandle(name="y", server=_port_server(page_size=4))])
    router = _fleet(PORT, n=1)
    with pytest.raises(ValueError, match="pool geometry"):
        router.join(_port_server(max_slots=2))
    with pytest.raises(ValueError, match="role"):
        fleet.ReplicaHandle(name="z", server=_port_server(), role="cache")


# --- the prefill/decode split -----------------------------------------------------------------------
def _role_split(ns, tmp):
    router = ns.fleet.FleetRouter([ns.fleet.ReplicaHandle(name="pf", server=_server(ns), role="prefill"),
                                   ns.fleet.ReplicaHandle(name="dc", server=_server(ns), role="decode")])
    rs = np.random.RandomState(37)
    prompts = [rs.randint(0, 128, (int(rs.randint(10, 20)),)).astype(np.int32) for _ in range(4)]
    budgets = [6, 9, 4, 8]
    uids = _submit(router, prompts, budgets)
    out = _run(router, uids, prompts, budgets, [dict(router._where)])
    out["pf"] = dict(router.replicas["pf"].inner.stats)
    out["dc"] = dict(router.replicas["dc"].inner.stats)
    return out


def test_role_split_matches_jax(tmp_path):
    port = _both(_role_split, tmp_path)
    assert port["obs"]["fleet"]["role_migrations"] == 4
    assert port["pf"]["decode_steps"] == 0 and port["dc"]["decode_steps"] > 0
    assert port["pf"]["emitted_tokens"] == 4 and port["dc"]["emitted_tokens"] == sum(port["budgets"]) - 4


# --- trace replay across the fleet ------------------------------------------------------------------
def _replay_with_kill(ns, tmp):
    tenants = [dict(name="gold", weight=3.0, priority=1, ttft_target_ms=4000), dict(name="free", weight=1.0)]
    trace = ns.loadgen.make_trace(
        [ns.loadgen.TenantLoad(name="gold", rate=30, prompt_len=(6, 14), max_new_tokens=(3, 7)),
         ns.loadgen.TenantLoad(name="free", rate=30, prompt_len=(6, 14), max_new_tokens=(3, 7))],
        horizon_s=0.5, vocab_size=CFG["vocab_size"], seed=5)
    router = _fleet(ns, n=2, tmp=tmp, tenants=tenants)
    kill = (0.15, lambda srv: srv.kill_replica(next(n for n, h in srv.replicas.items() if h.inner.has_work())))
    rep = ns.loadgen.replay(router, trace, clock=ns.loadgen.VirtualClock(step_cost_s=0.02), events=[kill])
    outputs = rep.pop("outputs")
    return dict(uids=None, where=None, rep=rep, fleet=_fleet_stats(router),
                outs=[outputs.get(r.index) for r in trace],
                prompts=[r.prompt for r in trace], budgets=[r.max_new_tokens for r in trace])


def test_replay_across_a_mid_trace_kill_matches_jax(tmp_path):
    port, ref = _replay_with_kill(PORT, tmp_path), _replay_with_kill(JAX, tmp_path)
    assert port["rep"] == ref["rep"]
    assert port["fleet"] == ref["fleet"]
    assert port["rep"]["events_fired"] == 1 and port["fleet"]["replica_kills"] == 1
    assert port["fleet"]["rerouted"] >= 1 and port["fleet"]["migrated_token_divergence"] == 0
    assert port["rep"]["starved_tenants"] == []
    for a, b, want in zip(port["outs"], ref["outs"], _single(port["prompts"], port["budgets"])):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, want)


# --- host units ---------------------------------------------------------------------------------------
def test_chain_keys_and_ring_match_jax():
    rs = np.random.RandomState(0)
    sysp = rs.randint(0, 128, (16,)).astype(np.int32)
    for p in (np.concatenate([sysp, rs.randint(0, 128, (5,)).astype(np.int32)]), sysp, sysp[:9],
              np.asarray([1, 2], np.int32), rs.randint(0, 128, (40,)).astype(np.int32)):
        for page in (4, 8):
            assert fleet.prefix_chain_keys(p, page) == jax_fleet.prefix_chain_keys(p, page)
    ring, jring = fleet.ConsistentHashRing(vnodes=16), jax_fleet.ConsistentHashRing(vnodes=16)
    keys = list(range(0, 2**32, 2**26))
    for r in (ring, jring):
        for n in ("a", "b", "c"):
            r.add(n)
    before = {k: ring.lookup(k, lambda n: True) for k in keys}
    assert before == {k: jring.lookup(k, lambda n: True) for k in keys} and set(before.values()) == {"a", "b", "c"}
    ring.remove("b")
    jring.remove("b")
    after = {k: ring.lookup(k, lambda n: True) for k in keys}
    assert after == {k: jring.lookup(k, lambda n: True) for k in keys}
    assert all(after[k] == before[k] for k in keys if before[k] != "b")  # only b's arcs moved
    assert ring.nodes() == ["a", "c"] and ring.lookup(keys[0], lambda n: False) is None


def test_resize_policy_decisions_match_jax():
    assert fleet_policy.valid_fleet_sizes(32, 4) == jax_fleet_policy.valid_fleet_sizes(32, 4) == [1, 2, 4, 8]
    assert fleet_policy.valid_fleet_sizes(24, 3, 2, 6) == jax_fleet_policy.valid_fleet_sizes(24, 3, 2, 6)
    kw = dict(min_replicas=1, max_replicas=8, target_backlog_per_replica=4.0, cooldown_steps=5,
              valid_counts=[1, 2, 4, 8])
    ours, theirs = fleet_policy.FleetResizePolicy(**kw), jax_fleet_policy.FleetResizePolicy(**kw)
    rs = np.random.RandomState(9)
    n_active, decisions = 2, []
    for step in range(60):
        backlog = float(rs.randint(0, 50))
        a = ours.decide(backlog=backlog, n_active=n_active, step=step)
        assert a == theirs.decide(backlog=backlog, n_active=n_active, step=step)
        decisions.append(a)
        n_active = a
    assert len(set(decisions)) >= 3  # the trace moved the fleet through several sizes
    for bad in (dict(scale_up_at=0.2, scale_down_at=0.5), dict(min_replicas=3, max_replicas=2),
                dict(target_backlog_per_replica=0.0), dict(min_replicas=3, max_replicas=3, valid_counts=[2])):
        with pytest.raises(ValueError):
            fleet_policy.FleetResizePolicy(**bad)


def _autoscale(ns, tmp):
    router = _fleet(ns, n=1)
    rs = np.random.RandomState(41)
    prompts = [rs.randint(0, 128, (8,)).astype(np.int32) for _ in range(12)]
    budgets = [4] * 12
    uids = _submit(router, prompts, budgets)
    pol = ns.policy.FleetResizePolicy(min_replicas=1, max_replicas=4, target_backlog_per_replica=3.0,
                                      cooldown_steps=0)
    grew = router.autoscale_step(pol, spawn=lambda: _server(ns), step=0)
    where = [dict(router._where)]
    router.run()
    where.append(dict(router._where))
    obs = _observe(router, uids)
    shrank = router.autoscale_step(pol, spawn=lambda: _server(ns), step=10)
    return dict(uids=uids, where=where, prompts=prompts, budgets=budgets, obs=obs, grew=grew, shrank=shrank,
                after=_fleet_stats(router))


def test_autoscale_grows_and_drains_like_jax(tmp_path):
    port = _both(_autoscale, tmp_path)
    assert port["grew"] == 3 and port["shrank"] == -3
    assert port["obs"]["fleet"]["joins"] == 3 and port["after"]["n_active"] == 1
