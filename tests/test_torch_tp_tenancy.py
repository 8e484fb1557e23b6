"""Tensor-parallel serving under tenancy, the fleet and wall-clock replay
(ROADMAP S10), on the CPU.

One gloo rank group at tp = 2 (``torch_rank_group.py``) runs three
scenarios on every rank, each server a ``PagedServer(tp=TPServing(2))``
over the tiny fp32 model of ``torch_tp_scenarios.py``; the parent holds
them against JAX's servers over ``TPServing(mesh=serving_mesh(2))`` on
the 8-device CPU mesh and against the port's single-rank server:

* ``MultiTenantServer`` with two tenants of different priorities and TTFT
  targets, replaying a flood-and-trickle trace under a ``VirtualClock``:
  the whole report (latency percentiles, goodput, shares, outputs) equal
  to JAX's on every rank;
* a two-replica ``FleetRouter`` of tp servers: a migration mid decode,
  then a drain; the routing, the uids, every stream and ``fleet_stats()``
  equal to JAX's fleet, ``migrated_token_divergence`` 0;
* ``replay`` on the wall clock (``clock=None``) across a two-replica
  fleet, with a drain fired at 50 ms of trace time: on every rank the same
  steps, the same fired event and the same per-step fingerprints of both
  replicas, every request finished with the single-rank server's stream,
  and no TTFT shorter than the step that made the first token.

Every step under tp also checks the ranks' fingerprints itself
(``TPServing.step_sync``), and a disagreement raises ``TPDivergence``; the
last test makes one rank diverge on purpose.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.fleet import FleetRouter, ReplicaHandle
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.inference.tp import TPDivergence, TPServing
from deepspeed_tpu_torch.inference.traffic import MultiTenantServer, TenantSpec
from deepspeed_tpu_torch.utils.loadgen import TenantLoad, TraceRequest, VirtualClock, make_trace, replay
from torch_rank_group import join_ranks, start_ranks
from torch_tp_scenarios import CFG, SERVER, port_params, tree

TP = 2
SLA = [dict(name="flood", weight=1.0, priority=0, ttft_target_ms=20_000),
       dict(name="trickle", weight=1.0, priority=1, ttft_target_ms=2_000)]
FLEET_BUDGETS = [9, 5, 10, 6]
WALL_LOADS = [dict(name="a", rate=400.0, prompt_len=(4, 10), max_new_tokens=(3, 6), n_prefixes=1, prefix_len=8,
                   n_requests=4),
              dict(name="b", rate=200.0, prompt_len=(4, 10), max_new_tokens=(3, 6), n_prefixes=0, n_requests=3)]
DRAIN_AT_S = 0.05


def _trace(trace_cls):
    """Ten flood requests sharing a system prompt at t ~ 0, four trickle
    requests while the flood drains."""
    rs = np.random.RandomState(50)
    sys_tokens = rs.randint(0, CFG["vocab_size"], (16,)).astype(np.int32)
    out = []
    for i in range(10):
        tail = rs.randint(0, CFG["vocab_size"], (3 + i % 4,)).astype(np.int32)
        out.append(trace_cls(at=0.001 * i, tenant="flood", prompt=np.concatenate([sys_tokens, tail]),
                             max_new_tokens=5))
    for j in range(4):
        out.append(trace_cls(at=0.15 + 0.4 * j, tenant="trickle",
                             prompt=rs.randint(0, CFG["vocab_size"], (8,)).astype(np.int32), max_new_tokens=5))
    out.sort(key=lambda r: r.at)
    for i, r in enumerate(out):
        r.index = i
    return out


def _fleet_prompts():
    rs = np.random.RandomState(19)
    sys_tokens = rs.randint(0, CFG["vocab_size"], (16,)).astype(np.int32)
    return [np.concatenate([sys_tokens, rs.randint(0, CFG["vocab_size"], (3 + i,)).astype(np.int32)]) if i % 2 == 0
            else rs.randint(0, CFG["vocab_size"], (5 + i,)).astype(np.int32) for i in range(4)]


def _wall_trace():
    return make_trace([TenantLoad(**t) for t in WALL_LOADS], horizon_s=1.0, vocab_size=CFG["vocab_size"], seed=4)


def _split(report):
    report = dict(report)
    outs = report.pop("outputs")
    return report, {int(k): np.asarray(v).tolist() for k, v in outs.items()}


# --- one scenario, on either package ---------------------------------------------------------
def _fleet_run(router):
    """Submit four prompts, migrate the first request that has two tokens,
    drain replica r1, run to the end."""
    uids = [router.submit(p, max_new_tokens=n) for p, n in zip(_fleet_prompts(), FLEET_BUDGETS)]
    where = [dict(router._where)]
    mid = None
    while mid is None:
        router.step()
        mid = next((r.uid for h in router.replicas.values() for r in h.inner._active
                    if len(r.generated) >= 2 and not r.done), None)
    assert router.migrate(mid)
    where.append(dict(router._where))
    router.drain("r1")
    where.append(dict(router._where))
    router.run()
    stats = router.fleet_stats()
    return dict(uids=uids, where=where, outs=[np.asarray(router.take_result(u)).tolist() for u in uids],
                fleet=stats)


def _fingerprint_log(inner, log, emit_ms):
    """Record the server's fingerprint after each of its steps, and the
    wall time of each step that emitted tokens."""
    step = inner.step

    def logged():
        n, t = inner.stats["emitted_tokens"], time.perf_counter()
        step()
        if inner.stats["emitted_tokens"] > n:
            emit_ms.append((time.perf_counter() - t) * 1e3)
        log.append(f"{inner._fingerprint:08x}")

    inner.step = logged


# --- the ranks --------------------------------------------------------------------------------
def _port_server(clock=None):
    cfg, params = port_params("mha")
    return PagedServer(cfg, params, attn_impl="plain", device="cpu", tp=TPServing(degree=TP), clock=clock,
                       prefix_cache=True, **SERVER)


def _rank_main(rank, world, tmp):  # noqa: ARG001
    out = {}
    front = MultiTenantServer(_port_server(), tenants=[TenantSpec(**t) for t in SLA])
    out["sla"] = _split(replay(front, _trace(TraceRequest), clock=VirtualClock(0.05)))

    router = FleetRouter([ReplicaHandle(name=f"r{i}", server=_port_server()) for i in range(2)])
    out["fleet"] = _fleet_run(router)

    router = FleetRouter([ReplicaHandle(name=f"r{i}", server=_port_server()) for i in range(2)])
    logs = {name: [] for name in router.replicas}
    emit_ms = []
    for name, h in router.replicas.items():
        _fingerprint_log(h.inner, logs[name], emit_ms)
    report = replay(router, _wall_trace(), events=[(DRAIN_AT_S, lambda f: f.drain("r1"))])
    rep, outs = _split(report)
    out["wall"] = dict(steps=rep["steps"], events_fired=rep["events_fired"], outs=outs, prints=logs,
                       finished=sum(t["finished"] for t in rep["tenants"].values()),
                       states={n: h.state for n, h in router.replicas.items()},
                       ttft_ms=[t for _, t, _, _ in router.finished_log()], emit_ms=emit_ms)

    # a rank whose host arrays differ: the next step's sync raises on every rank
    srv = _port_server()
    srv.submit(np.arange(3 + rank, dtype=np.int32), max_new_tokens=2)
    try:
        srv.run()
        out["diverged"] = None
    except TPDivergence as e:
        out["diverged"] = str(e)
    return out


# --- the JAX references -----------------------------------------------------------------------
def _jax_runs():
    import jax.numpy as jnp

    from deepspeed_tpu.inference import fleet as jax_fleet
    from deepspeed_tpu.inference import traffic as jax_traffic
    from deepspeed_tpu.inference.scheduler import PagedServer as JaxServer
    from deepspeed_tpu.inference.tp import TPServing as JaxTP, serving_mesh
    from deepspeed_tpu.models.config import TransformerConfig as JaxConfig
    from deepspeed_tpu.utils import loadgen as jax_loadgen
    from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree

    params = unflatten_tree({k: jnp.asarray(v) for k, v in flatten_tree(tree("mha")).items()})
    mesh = serving_mesh(TP)

    def server():
        return JaxServer(JaxConfig(**CFG), params, attn_impl="xla", dtype=jnp.float32, tp=JaxTP(mesh=mesh),
                         prefix_cache=True, **SERVER)

    front = jax_traffic.MultiTenantServer(server(), tenants=[jax_traffic.TenantSpec(**t) for t in SLA])
    sla = _split(jax_loadgen.replay(front, _trace(jax_loadgen.TraceRequest), clock=jax_loadgen.VirtualClock(0.05)))
    router = jax_fleet.FleetRouter([jax_fleet.ReplicaHandle(name=f"r{i}", server=server()) for i in range(2)])
    return dict(sla=sla, fleet=_fleet_run(router))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_tenancy"))
    handle = start_ranks(_rank_main, TP, os.path.join(tmp, "ranks"), tmp)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jax = _jax_runs()
        cfg, params = port_params("mha")
        single = PagedServer(cfg, params, attn_impl="plain", device="cpu", **SERVER)
        trace = _wall_trace()
        wall_ref = single.serve([r.prompt for r in trace], max_new_tokens=[r.max_new_tokens for r in trace])
        fleet_ref = single.serve(_fleet_prompts(), max_new_tokens=FLEET_BUDGETS)
        ranks = join_ranks(handle, limit_s=180.0)
    finally:
        torch.set_num_threads(prev)
    return dict(jax=jax, ranks=ranks, wall_ref={r.index: o.tolist() for r, o in zip(trace, wall_ref)},
                fleet_ref=[o.tolist() for o in fleet_ref])


def test_tp_multi_tenant_replay_equals_jax(runs):
    """Two tenants over a tp = 2 server, replayed under a virtual clock: the
    whole report and every output equal to JAX's tp = 2 tenancy on every
    rank; the priority tenant's TTFT beats the flood's."""
    ref_report, ref_outs = runs["jax"]["sla"]
    for rank, res in enumerate(runs["ranks"]):
        report, outs = res["sla"]
        assert outs == ref_outs, f"rank {rank}"
        assert report == ref_report, f"rank {rank}"
    assert ref_report["starved_tenants"] == [] and ref_report["n_rejected"] == 0
    assert ref_report["tenants"]["trickle"]["ttft_ms"]["p50"] < ref_report["tenants"]["flood"]["ttft_ms"]["p50"]


def test_tp_fleet_routes_migrates_and_drains_like_jax(runs):
    """A two-replica fleet of tp = 2 servers: routing at every stage, uids,
    streams and ``fleet_stats()`` equal to JAX's on every rank; the streams
    equal one single-rank server's."""
    ref = runs["jax"]["fleet"]
    assert ref["fleet"]["migrations"] >= 2 and ref["fleet"]["drains"] == 1
    for rank, res in enumerate(runs["ranks"]):
        got = res["fleet"]
        for key in ("uids", "where", "outs", "fleet"):
            assert got[key] == ref[key], (rank, key)
        assert got["outs"] == runs["fleet_ref"]
        assert got["fleet"]["migrated_token_divergence"] == 0


def test_tp_wall_clock_replay_decides_alike_on_every_rank(runs):
    """Wall-clock replay across a two-replica tp fleet with a drain at 50 ms:
    every rank took the same steps, fired the event, logged the same
    fingerprint after every step of each replica, and finished every
    request with the single-rank stream."""
    ranks = runs["ranks"]
    first = ranks[0]["wall"]
    assert first["events_fired"] == 1 and first["states"]["r1"] == "drained"
    assert first["finished"] == len(runs["wall_ref"]) and first["outs"] == runs["wall_ref"]
    assert sum(len(v) for v in first["prints"].values()) > 0
    for res in ranks[1:]:
        got = res["wall"]
        assert (got["steps"], got["events_fired"], got["states"]) == (first["steps"], 1, first["states"])
        assert got["prints"] == first["prints"] and got["outs"] == first["outs"]


def test_tp_wall_clock_ttft_covers_the_step_that_made_the_token(runs):
    """Under tp the first token's stamp is rank 0's clock after the device
    work that made it: no request's wall-clock TTFT falls below half the
    shortest step that emitted tokens (a stamp taken at the step's start
    reads about 0 for a request that finds the server idle)."""
    wall = runs["ranks"][0]["wall"]
    assert len(wall["ttft_ms"]) == len(runs["wall_ref"]) and wall["emit_ms"]
    assert min(wall["ttft_ms"]) >= 0.5 * min(wall["emit_ms"]), (wall["ttft_ms"], wall["emit_ms"])


def test_tp_divergent_rank_raises_on_every_rank(runs):
    """Ranks that ship different host arrays (here: different prompts)
    stop at the next step's fingerprint check, every rank alike."""
    for res in runs["ranks"]:
        assert res["diverged"] is not None and "fingerprint" in res["diverged"]
