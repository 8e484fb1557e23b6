"""The port's multi-tenant SLA serving and load harness (ROADMAP S7)
against the JAX package's, on the CPU.

Mirrors tests/unit/inference/test_traffic.py on its tiny fp32 llama-style
GQA model:

* ``make_trace``: traces equal to JAX's for the same tenants and seed
  (arrival times, tenants, prompts, budgets, prefix ids);
* ``SLAPolicy`` units: victim order, admission by priority and deficit,
  deficits spanning backlog periods only, the same picks as JAX's policy;
* ``MultiTenantServer`` over an undersized pool (forced preemption) with
  the prefix cache on: streams byte-identical to JAX's, the admission
  order and every preemption victim equal, per-tenant ``serve_stats``
  (budget and goodput shares, rejections) equal;
* ``replay`` under a ``VirtualClock``: the whole report equal to JAX's
  (TTFT/TPOT percentiles, goodput, starvation verdicts, SLA attainment,
  outputs), for the flood-and-trickle trace under the SLA policy and FIFO;
* admission control: the queue cap rejects like JAX's; an unknown tenant
  raises;
* the engine's ``traffic.enabled`` builds a ``MultiTenantServer`` whose
  streams and per-tenant stats equal the JAX engine's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.inference.scheduler import PagedServer as JaxServer
from deepspeed_tpu.inference.scheduler import Request as JaxRequest
from deepspeed_tpu.inference import traffic as jax_traffic
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models.config import TransformerConfig as JaxConfig
from deepspeed_tpu.utils import loadgen as jax_loadgen
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.inference.scheduler import PagedServer, Request
from deepspeed_tpu_torch.inference.traffic import MultiTenantServer, SLAPolicy, TenantSpec
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.utils.loadgen import TenantLoad, TraceRequest, VirtualClock, make_trace, replay

CFG = dict(
    vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=64,
    norm="rmsnorm", position="rope", activation="swiglu", use_bias=False, tie_embeddings=False,
    flash_attention=False, dtype="float32",
)


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


def _kw(kw):
    for k, v in dict(page_size=8, max_slots=4, prefill_chunk=8, prefix_cache=True).items():
        kw.setdefault(k, v)
    return kw


def _servers(**kw):
    """(port server, JAX server) of the same geometry."""
    jcfg, cfg, params, _, ptree = _model()
    kw = _kw(kw)
    jkw = dict(kw)
    if "clock" in kw:
        jkw["clock"] = kw["clock"][1]
        kw["clock"] = kw["clock"][0]
    return (PagedServer(cfg, ptree, device="cpu", **kw),
            JaxServer(jcfg, params, attn_impl="xla", dtype=jnp.float32, **jkw))


def _sys_prompt(seed=21, n=16):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"], (n,)).astype(np.int32)


def _shared_prompts(n, sys_tokens, seed=22, lo=3, hi=8):
    rs = np.random.RandomState(seed)
    return [np.concatenate([sys_tokens, rs.randint(0, CFG["vocab_size"], (int(rs.randint(lo, hi)),)).astype(np.int32)])
            for _ in range(n)]


def _record(server):
    """Log the policy's admissions and preemption victims (uids, in order)."""
    log = {"admit": [], "victim": []}
    policy = server.policy
    choose = policy.preemption_victim

    def victim(candidates, srv, for_req=None):
        v = choose(candidates, srv, for_req=for_req)
        log["victim"].append(v.uid)
        return v

    policy.on_admit = lambda req, srv: log["admit"].append(req.uid)
    policy.preemption_victim = victim
    return log


TENANT_KEYS = ("submitted", "finished", "tokens", "weight", "priority", "rejected", "budget_share",
               "goodput_share", "ttft_sla_attainment", "tpot_sla_attainment", "ttft_ms", "tpot_ms")


def _assert_tenants_equal(stats, jstats, keys=TENANT_KEYS):
    assert sorted(stats["tenants"]) == sorted(jstats["tenants"])
    for name, rec in jstats["tenants"].items():
        for key in keys:
            assert stats["tenants"][name][key] == rec[key], (name, key)


# --- the load generator ----------------------------------------------------------------------
LOADS = [dict(name="a", rate=20.0, pareto_alpha=1.3, n_prefixes=2, prefix_len=16, shared_prefix_prob=0.7),
         dict(name="b", rate=10.0), dict(name="c", rate=5.0, n_prefixes=0, n_requests=3)]


@pytest.mark.parametrize("seed", [5, 6])
def test_make_trace_equals_jax(seed):
    ours = make_trace([TenantLoad(**t) for t in LOADS], horizon_s=2.0, vocab_size=128, seed=seed)
    theirs = jax_loadgen.make_trace([jax_loadgen.TenantLoad(**t) for t in LOADS], horizon_s=2.0, vocab_size=128,
                                    seed=seed)
    assert len(ours) == len(theirs) > 10
    for a, b in zip(ours, theirs):
        assert (a.at, a.tenant, a.max_new_tokens, a.prefix_id, a.index) == \
               (b.at, b.tenant, b.max_new_tokens, b.prefix_id, b.index)
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.prompt.dtype == np.int32
    assert sum(r.tenant == "c" for r in ours) <= 3
    heads = {r.prompt[:16].tobytes() for r in ours if r.tenant == "a" and r.prefix_id >= 0}
    assert 1 <= len(heads) <= 2  # drawn from the tenant's 2 system prompts


def test_virtual_clock_ticks_like_jax():
    ours, theirs = VirtualClock(step_cost_s=0.02), jax_loadgen.VirtualClock(step_cost_s=0.02)
    for ck in (ours, theirs):
        ck.tick()
        ck.tick(0.5)
        ck.tick(-1.0)  # a negative gap jumps nowhere
    assert ours() == theirs() == pytest.approx(0.52)


# --- SLA policy units --------------------------------------------------------------------------
def _fake(uid, tenant, jax_side=False):
    cls = JaxRequest if jax_side else Request
    return cls(uid=uid, prompt=np.zeros(4, np.int32), max_new_tokens=4, tenant=tenant)


def _policies(specs):
    return (SLAPolicy({s["name"]: TenantSpec(**s) for s in specs}),
            jax_traffic.SLAPolicy({s["name"]: jax_traffic.TenantSpec(**s) for s in specs}))


def test_sla_policy_victim_order_matches_jax():
    specs = [dict(name="hi", priority=1), dict(name="lo"), dict(name="lo2")]
    for jax_side, policy in zip((False, True), _policies(specs)):
        hi, lo_old, lo_young = (_fake(0, "hi", jax_side), _fake(1, "lo", jax_side), _fake(2, "lo", jax_side))
        assert policy.preemption_victim([lo_old, hi, lo_young], None) is lo_young  # priority dominates
        policy.served = {"lo": 100, "lo2": 0}
        lo2 = _fake(3, "lo2", jax_side)
        assert policy.preemption_victim([lo2, lo_old], None) is lo_old  # most over budget
        assert policy.preemption_victim([hi], None) is hi  # liveness beats priority


def test_sla_policy_admission_and_backlog_periods_match_jax():
    specs = [dict(name="a"), dict(name="b"), dict(name="vip", priority=2)]
    picks, served = [], []
    for jax_side, policy in zip((False, True), _policies(specs)):
        qa, qb, vip = _fake(0, "a", jax_side), _fake(1, "b", jax_side), _fake(2, "vip", jax_side)
        seq = [policy.next_admission([qa], None).uid]
        policy.served["a"] = 1000.0
        seq.append(policy.next_admission([qa, qb], None).uid)  # b joins at a's floor: a first (tie)
        seq.append(policy.served["b"])
        seq.append(policy.next_admission([qa, qb, vip], None).uid)  # priority wins
        seq.append(policy.next_admission([qb], None).uid)  # a drains and loses its counter
        seq.append("a" in policy.served)
        policy.served["b"] = 40.0
        policy.next_admission([qa, qb], None)
        seq.append(policy.served["a"])  # a returns at the floor
        picks.append(seq)
        served.append(dict(policy.served))
    assert picks[0] == picks[1] == [0, 0, 1000.0, 2, 1, False, 40.0]
    assert served[0] == served[1]


# --- the multi-tenant server ---------------------------------------------------------------------
TENANTS = [dict(name="gold", weight=3.0, priority=1, ttft_target_ms=400.0, tpot_target_ms=60.0),
           dict(name="free", weight=1.0, ttft_target_ms=200.0)]


def _fronts(tenants=TENANTS, **kw):
    srv, jsrv = _servers(**kw)
    return (MultiTenantServer(srv, tenants=[TenantSpec(**t) for t in tenants]),
            jax_traffic.MultiTenantServer(jsrv, tenants=[jax_traffic.TenantSpec(**t) for t in tenants]))


def test_multi_tenant_server_matches_jax_under_preemption():
    """Prefix cache, SLA tenancy and an undersized pool (forced preemption)
    under a virtual clock: streams, the admission order, every victim and
    the per-tenant stats equal JAX's."""
    sys_tokens = _sys_prompt()
    prompts = _shared_prompts(6, sys_tokens)
    budgets = [10, 3, 7, 12, 1, 5]
    tenants = ["gold" if i % 2 else "free" for i in range(6)]
    clocks = (VirtualClock(0.02), jax_loadgen.VirtualClock(0.02))
    front, jfront = _fronts(page_size=4, num_pages=16, max_slots=3, clock=clocks)
    logs = [_record(front.server), _record(jfront.server)]
    outs = []
    for f, ck in zip((front, jfront), clocks):
        uids = [f.submit(p, max_new_tokens=n, tenant=t) for p, n, t in zip(prompts, budgets, tenants)]
        while f.has_work():
            ck.tick()
            f.step()
        outs.append([f.take_result(u) for u in uids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert logs[0] == logs[1] and len(logs[0]["victim"]) >= 1
    assert front.server.stats["preempted"] == jfront.server.stats["preempted"] >= 1
    stats, jstats = front.serve_stats(), jfront.serve_stats()
    _assert_tenants_equal(stats, jstats)
    assert stats["tenants"]["gold"]["budget_share"] == pytest.approx(3.0 / 5.0)  # the default tenant weighs 1
    assert stats["prefix"]["prefix_hit_tokens"] == jstats["prefix"]["prefix_hit_tokens"] > 0
    assert front.finished_log() == jfront.finished_log()
    assert front.queued_count() == front.live_count() == 0 and front.pool.used_pages() == 0


def test_admission_control_rejects_like_jax():
    front, jfront = _fronts(tenants=[dict(name="capped", max_queued=2)])
    prompts = _shared_prompts(5, _sys_prompt(), seed=40)
    got = []
    for f in (front, jfront):
        uids = [f.submit(p, max_new_tokens=3, tenant="capped") for p in prompts]
        assert uids[2:] == [None, None, None] and all(u is not None for u in uids[:2])
        assert f.queued_count("capped") == 2 and f.queued_count("default") == 0
        f.run()
        got.append(f.serve_stats()["tenants"]["capped"])
        with pytest.raises(KeyError, match="unknown tenant"):
            f.submit(prompts[0], tenant="nobody")
    assert got[0]["rejected"] == got[1]["rejected"] == 3
    assert got[0]["finished"] == got[1]["finished"] == 2
    front.register_tenant({"name": "late", "weight": 2.0})
    assert front.serve_stats()["tenants"]["late"]["budget_share"] == pytest.approx(2.0 / 4.0)


def _flood_trickle_trace(sys_tokens, trace_cls):
    rs = np.random.RandomState(50)
    trace = []
    for i in range(10):  # the flood tenant fills the server at t ~ 0
        tail = rs.randint(0, CFG["vocab_size"], (3 + i % 4,)).astype(np.int32)
        trace.append(trace_cls(at=0.001 * i, tenant="flood", prompt=np.concatenate([sys_tokens, tail]),
                               max_new_tokens=5))
    for j in range(4):  # the trickle tenant arrives while the flood drains
        trace.append(trace_cls(at=0.15 + 0.4 * j, tenant="trickle",
                               prompt=rs.randint(0, CFG["vocab_size"], (8,)).astype(np.int32), max_new_tokens=5))
    trace.sort(key=lambda r: r.at)
    for i, r in enumerate(trace):
        r.index = i
    return trace


SLA = [dict(name="flood", weight=1.0, ttft_target_ms=20_000), dict(name="trickle", weight=1.0, ttft_target_ms=2_000)]


def _replays(sla: bool):
    sys_tokens = _sys_prompt(seed=51)
    srv, jsrv = _servers(max_slots=2)
    if sla:
        srv = MultiTenantServer(srv, tenants=[TenantSpec(**t) for t in SLA])
        jsrv = jax_traffic.MultiTenantServer(jsrv, tenants=[jax_traffic.TenantSpec(**t) for t in SLA])
    rep = replay(srv, _flood_trickle_trace(sys_tokens, TraceRequest), clock=VirtualClock(0.05))
    jrep = jax_loadgen.replay(jsrv, _flood_trickle_trace(sys_tokens, jax_loadgen.TraceRequest),
                              clock=jax_loadgen.VirtualClock(0.05))
    return rep, jrep, sys_tokens


def _assert_reports_equal(rep, jrep):
    outs, jouts = rep.pop("outputs"), jrep.pop("outputs")
    assert sorted(outs) == sorted(jouts)
    for idx, out in jouts.items():
        np.testing.assert_array_equal(outs[idx], np.asarray(out))
    assert rep == jrep


@pytest.mark.parametrize("sla", [True, False], ids=["sla", "fifo"])
def test_replay_report_equals_jax(sla):
    """The flood-and-trickle replay under a virtual clock: the whole report
    (latency percentiles, goodput, shares, starvation, outputs) equals
    JAX's; with the SLA policy nobody starves and the trickle tenant's TTFT
    beats the flood's; the streams equal sharing-off single-tenant serving."""
    rep, jrep, sys_tokens = _replays(sla)
    outputs = dict(rep["outputs"])
    _assert_reports_equal(rep, jrep)
    assert rep["n_rejected"] == 0 and rep["steps"] > 0
    if sla:
        assert rep["starved_tenants"] == []
        assert rep["tenants"]["trickle"]["ttft_ms"]["p50"] < rep["tenants"]["flood"]["ttft_ms"]["p50"]
        assert rep["prefix_hit_rate"] > 0.2
        off, _ = _servers(max_slots=2, prefix_cache=False)
        trace = _flood_trickle_trace(sys_tokens, TraceRequest)
        expected = off.serve([r.prompt for r in trace], max_new_tokens=[r.max_new_tokens for r in trace])
        for r, exp in zip(trace, expected):
            np.testing.assert_array_equal(outputs[r.index], exp)


def test_wall_clock_replay_serves_everything():
    """``clock=None`` replays on the wall clock: every request finishes,
    and the report has the same keys as a virtual replay's."""
    srv, _ = _servers(max_slots=2)
    trace = make_trace([TenantLoad(name="a", rate=200.0, prompt_len=(4, 8), max_new_tokens=(2, 4), n_prefixes=1,
                                   prefix_len=8, n_requests=4)], horizon_s=1.0, vocab_size=128, seed=3)
    rep = replay(srv, trace)
    assert rep["tenants"]["a"]["finished"] == rep["tenants"]["a"]["offered"] == len(trace) == 4
    assert rep["duration_s"] > 0 and all(out is not None for out in rep["outputs"].values())


def test_engine_traffic_matches_jax_engine():
    """``traffic.enabled`` through ``init_inference``: a ``MultiTenantServer``
    whose streams and per-tenant stats equal the JAX engine's."""
    jcfg, cfg, params, tree, _ = _model()
    paged = {"page_size": 8, "max_slots": 4, "prefill_chunk": 8, "attn_impl": "xla", "prefix_cache": True}
    traffic = {"enabled": True, "tenants": [{"name": "default", "weight": 2.0},
                                            {"name": "batch", "weight": 1.0, "priority": -1}]}
    jeng = ds.init_inference(JaxLM(jcfg), dtype="fp32", paged_kv=paged, traffic=traffic)
    jeng.set_params(params)
    jeng._ds_config = jcfg
    eng = dst.init_inference(TransformerLM(cfg), dtype="fp32", device="cpu", paged_kv=paged, traffic=traffic)
    eng.load_jax_params(tree)
    prompts = _shared_prompts(3, _sys_prompt(seed=60), seed=61)
    outs, ref = eng.serve(prompts, max_new_tokens=6), jeng.serve(prompts, max_new_tokens=6)
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert isinstance(eng._paged_server, MultiTenantServer)
    stats, jstats = eng.serve_stats(), jeng.serve_stats()
    assert stats["tenants"]["default"]["budget_share"] == pytest.approx(2 / 3)
    assert stats["tenants"]["batch"]["priority"] == -1
    _assert_tenants_equal(stats, jstats, keys=("submitted", "finished", "tokens", "weight", "priority", "rejected",
                                               "budget_share", "goodput_share"))
