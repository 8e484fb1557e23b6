"""Trace-replay load generation for the paged serving stack.

Counterpart of ``deepspeed_tpu/utils/loadgen.py`` (no JAX; the port keeps
its own copy, and its traces are the JAX package's for the same seed):

* ``make_trace`` builds a deterministic request trace from per-tenant
  ``TenantLoad`` specs: unit-mean Pareto inter-arrivals (tail index
  ``pareto_alpha``; smaller is burstier), a shared-prefix mixture (each
  tenant owns ``n_prefixes`` system prompts of zipf-like popularity,
  prepended to a random suffix) and per-request token budgets, all from one
  numpy ``RandomState(seed)``;
* ``replay`` feeds the trace into a server (``PagedServer``,
  ``MultiTenantServer`` or a ``FleetRouter``) arrival by arrival while it
  drives the step loop, then reports p50/p99 TTFT and TPOT (aggregate and
  per tenant), goodput (tokens a second from finished requests that met
  their tenant's TTFT target), per-tenant goodput against budget shares
  with a ``starved_tenants`` verdict, rejections and the prefix hit rate.
  ``events`` fires timed actions (kill a replica, drain one, join one) at
  trace instants.

Time is real (the wall clock; arrivals in real time, idle gaps slept) or
virtual (``VirtualClock``: each server step costs a fixed ``dt`` and idle
gaps jump at once), which is deterministic and what the tests pin down.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.inference.tp import refuse_tp


@dataclass
class TenantLoad:
    """One tenant's offered load.

    ``rate`` is the mean arrival rate (requests per second of trace time);
    inter-arrivals are unit-mean Pareto with tail index ``pareto_alpha``
    (must be > 1 for a finite mean; values near 1 give extreme bursts).
    Prompts are ``prefix + suffix``: with probability
    ``shared_prefix_prob`` one of the tenant's ``n_prefixes`` system
    prompts (zipf-ish popularity — rank r drawn ∝ 1/(r+1)) of
    ``prefix_len`` tokens is prepended to a fresh random suffix of
    uniform length in ``prompt_len``."""

    name: str = "default"
    rate: float = 4.0
    pareto_alpha: float = 1.5
    prompt_len: Tuple[int, int] = (8, 24)
    max_new_tokens: Tuple[int, int] = (4, 12)
    shared_prefix_prob: float = 0.8
    n_prefixes: int = 2
    prefix_len: int = 16
    n_requests: Optional[int] = None  # cap per tenant (horizon still applies)


@dataclass
class TraceRequest:
    """One scheduled arrival (``at`` seconds from trace start)."""

    at: float
    tenant: str
    prompt: np.ndarray
    max_new_tokens: int
    prefix_id: int = -1  # index of the shared system prompt, -1 = none
    index: int = field(default=-1)  # position in the merged trace


def _pareto_gap(rs: np.random.RandomState, alpha: float) -> float:
    """Unit-mean Pareto (Lomax + 1) sample: heavy upper tail, so a few
    gaps are huge and most are small — bursts."""
    a = max(float(alpha), 1.05)
    return (a - 1.0) / a * (1.0 + float(rs.pareto(a)))


def make_trace(
    tenants: Sequence[TenantLoad],
    horizon_s: float,
    vocab_size: int,
    seed: int = 0,
) -> List[TraceRequest]:
    """Deterministic heavy-tailed trace, merged over tenants and sorted by
    arrival time. All randomness flows from ``seed``."""
    rs = np.random.RandomState(seed)
    out: List[TraceRequest] = []
    for tl in tenants:
        prefixes = [
            rs.randint(0, vocab_size, (int(tl.prefix_len),)).astype(np.int32)
            for _ in range(int(tl.n_prefixes))
        ]
        if tl.n_prefixes:
            pop = 1.0 / np.arange(1, tl.n_prefixes + 1, dtype=np.float64)
            pop /= pop.sum()
        t, count = 0.0, 0
        mean_gap = 1.0 / max(float(tl.rate), 1e-9)
        while True:
            t += mean_gap * _pareto_gap(rs, tl.pareto_alpha)
            if t >= horizon_s or (
                tl.n_requests is not None and count >= tl.n_requests
            ):
                break
            lo, hi = tl.prompt_len
            suffix = rs.randint(0, vocab_size, (int(rs.randint(lo, hi + 1)),))
            pid = -1
            if tl.n_prefixes and rs.rand() < tl.shared_prefix_prob:
                pid = int(rs.choice(tl.n_prefixes, p=pop))
                prompt = np.concatenate([prefixes[pid], suffix.astype(np.int32)])
            else:
                prompt = suffix.astype(np.int32)
            blo, bhi = tl.max_new_tokens
            out.append(
                TraceRequest(
                    at=t,
                    tenant=tl.name,
                    prompt=prompt,
                    max_new_tokens=int(rs.randint(blo, bhi + 1)),
                    prefix_id=pid,
                )
            )
            count += 1
    out.sort(key=lambda r: (r.at, r.tenant))
    for i, r in enumerate(out):
        r.index = i
    return out


class VirtualClock:
    """Deterministic replay clock: ``clock()`` reads the current virtual
    time; the replay loop charges ``step_cost_s`` per server step via
    ``tick()`` and jumps idle gaps with ``tick(dt)``. Hand the SAME
    instance to the server (``PagedServer(clock=...)``) so its TTFT/TPOT
    stamps live on the virtual axis."""

    def __init__(self, step_cost_s: float = 0.01):
        self.now = 0.0
        self.step_cost_s = float(step_cost_s)

    def __call__(self) -> float:
        return self.now

    def tick(self, dt: Optional[float] = None) -> None:
        self.now += self.step_cost_s if dt is None else max(float(dt), 0.0)


def replay(
    server,
    trace: Sequence[TraceRequest],
    clock: Optional[VirtualClock] = None,
    eos_token_id: Optional[int] = None,
    max_steps: int = 1_000_000,
    starvation_tolerance: float = 0.10,
    keep_outputs: bool = True,
    events: Optional[Sequence[Tuple[float, Callable]]] = None,
) -> Dict:
    """Replay ``trace`` into ``server`` and report SLA percentiles,
    per-tenant goodput vs budget shares, and prefix hit rate.

    ``server`` is a ``PagedServer`` or ``MultiTenantServer`` — or a
    ``FleetRouter`` over several of them (rejections — ``submit``
    returning None — are counted, not raised). With ``clock=None`` the
    replay runs on the wall clock (arrivals in real time, idle gaps
    slept); pass a ``VirtualClock`` (also installed on the server) for
    deterministic virtual-time replay.

    ``events`` is a list of ``(at_seconds, fn)`` timed actions fired once
    when replay time passes ``at_seconds``, each called with the server —
    the fleet-scope failure injections (kill a replica mid-trace, drain
    one, join a fresh one) that make "p99 TTFT under replica kill" a
    reproducible measurement. Events landing after the replay finishes
    never fire; the report counts the fired ones."""
    wall = clock is None
    if wall:
        refuse_tp(server, "replay on the wall clock")
        t0 = time.perf_counter()

        def now_fn() -> float:
            return time.perf_counter() - t0

    else:
        now_fn = clock
        # the server's TTFT/TPOT stamps must live on the same virtual axis
        inner = getattr(server, "server", server)  # MultiTenantServer front
        inner.clock = clock

    offered: Dict[str, int] = {}
    rejected: Dict[str, int] = {}
    uid_by_index: Dict[int, int] = {}
    pending_events = sorted(events or [], key=lambda e: e[0])
    events_fired = 0
    i = 0
    steps = 0
    trace = list(trace)
    while i < len(trace) or server.has_work():
        now = now_fn()
        while pending_events and pending_events[0][0] <= now:
            _, fire = pending_events.pop(0)
            fire(server)
            events_fired += 1
        while i < len(trace) and trace[i].at <= now:
            r = trace[i]
            offered[r.tenant] = offered.get(r.tenant, 0) + 1
            try:
                uid = server.submit(
                    r.prompt,
                    max_new_tokens=r.max_new_tokens,
                    eos_token_id=eos_token_id,
                    tenant=r.tenant,
                )
            except ValueError:  # oversized for the pool: shed, don't crash
                uid = None
            if uid is None:
                rejected[r.tenant] = rejected.get(r.tenant, 0) + 1
            else:
                uid_by_index[r.index] = uid
            i += 1
        if server.has_work():
            if not wall:
                # charge the step's cost BEFORE it runs so tokens emitted by
                # this step are stamped after the time they took — a request
                # served on the step right after arrival gets TTFT >= one
                # step cost, never 0
                clock.tick()
            server.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(f"replay exceeded max_steps={max_steps}")
        elif i < len(trace):
            gap = trace[i].at - now
            if wall:
                time.sleep(min(max(gap, 0.0), 0.005))
            else:
                clock.tick(gap)
    duration = max(now_fn(), 1e-9)

    stats = server.serve_stats()
    tenant_stats = stats.get("tenants", {})
    # goodput: tokens from finished requests meeting their tenant's TTFT
    # target (no target — or no MultiTenantServer specs — counts them all)
    specs = getattr(server, "tenants", {})
    good_tokens: Dict[str, int] = {}
    for tenant, ttft_ms, _tpot_ms, n_tokens in server.finished_log():
        spec = specs.get(tenant)
        target = getattr(spec, "ttft_target_ms", None) if spec else None
        if target is None or ttft_ms <= target:
            good_tokens[tenant] = good_tokens.get(tenant, 0) + n_tokens
    total_good = sum(good_tokens.values())

    weights = {
        name: getattr(spec, "weight", 1.0) for name, spec in specs.items()
    } or {name: 1.0 for name in offered}
    demanding = [name for name in weights if offered.get(name, 0) > 0]
    demand_weight = sum(weights[n] for n in demanding) or 1.0
    # per-tenant demand in tokens (offered budgets): a tenant that offers
    # LESS than its budget share is not starved by not reaching it — the
    # entitlement is min(budget share, demand share)
    demand_tokens: Dict[str, int] = {}
    for r in trace:
        demand_tokens[r.tenant] = demand_tokens.get(r.tenant, 0) + r.max_new_tokens
    total_demand = sum(demand_tokens.values()) or 1

    tenants_report: Dict[str, Dict] = {}
    starved: List[str] = []
    for name in sorted(set(offered) | set(weights)):
        tokens = tenant_stats.get(name, {}).get("tokens", 0)
        good = good_tokens.get(name, 0)
        budget_share = (
            weights.get(name, 1.0) / demand_weight if name in demanding else 0.0
        )
        demand_share = demand_tokens.get(name, 0) / total_demand
        goodput_share = good / total_good if total_good else 0.0
        entitled = min(budget_share, demand_share)
        is_starved = (
            name in demanding
            and entitled > 0
            and goodput_share + starvation_tolerance < entitled
        )
        if is_starved:
            starved.append(name)
        tenants_report[name] = {
            "offered": offered.get(name, 0),
            "rejected": rejected.get(name, 0),
            "finished": tenant_stats.get(name, {}).get("finished", 0),
            "tokens": tokens,
            "good_tokens": good,
            "goodput_tokens_per_s": good / duration,
            "goodput_share": goodput_share,
            "budget_share": budget_share,
            "demand_share": demand_share,
            "starved": is_starved,
            "ttft_ms": tenant_stats.get(name, {}).get("ttft_ms", {"count": 0}),
            "tpot_ms": tenant_stats.get(name, {}).get("tpot_ms", {"count": 0}),
        }

    report = {
        "duration_s": duration,
        "steps": steps,
        "events_fired": events_fired,
        "n_requests": len(trace),
        "n_rejected": sum(rejected.values()),
        "ttft_ms": stats.get("ttft_ms", {"count": 0}),
        "tpot_ms": stats.get("tpot_ms", {"count": 0}),
        "goodput_tokens_per_s": total_good / duration,
        "prefix": stats.get("prefix", {}),
        "prefix_hit_rate": stats.get("prefix", {}).get("prefix_hit_rate", 0.0),
        "tenants": tenants_report,
        "starved_tenants": starved,
    }
    if keep_outputs:
        report["outputs"] = {
            idx: server.result(uid) for idx, uid in uid_by_index.items()
        }
    return report
