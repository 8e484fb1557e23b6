"""SLA-aware multi-tenant traffic over the paged serving scheduler.

Counterpart of ``deepspeed_tpu/inference/traffic.py`` (host code, no
device work). Tenancy sits on ``PagedServer`` through its
``SchedulingPolicy`` seam: the server keeps its token-exactness,
one-call-a-step and recompute-preemption contracts, and this layer decides
only who goes next.

* ``TenantSpec``: one tenant's contract: a token budget ``weight`` (its
  fair share of served tokens), a strict ``priority`` class (higher admits
  first and is preempted last), TTFT/TPOT SLA targets (attainment is
  reported, not enforced) and admission caps (queue depth, live slots).
* ``SLAPolicy``: admission picks, among queued tenants under their
  live-slot caps, the highest priority class and within it the tenant with
  the least ``served_tokens / weight`` (weighted deficit fairness over
  continuous backlog periods); preemption takes the lowest priority, then
  the most over budget, then the youngest: the inverse of admission.
* ``MultiTenantServer``: the front door: per-tenant ``submit`` with
  queue-cap rejection, the step loop delegated, and ``serve_stats()`` with
  per-tenant budget shares, goodput shares, rejections and SLA attainment.

Greedy streams are byte-identical to single-tenant serving of the same
requests: the order changes when a request runs, never what it generates.
Over a tensor-parallel server every rank runs the same tenancy on the same
submissions; its decisions read served-token counts and the server's
clock, which under tp is rank 0's (``inference/tp.py:SharedClock``).
Multi-step windows form underneath only when nothing is queued, so a
tenant's pending admission always breaks the window first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from deepspeed_tpu_torch.inference.scheduler import (
    PagedServer,
    Request,
    SchedulingPolicy,
)


@dataclass
class TenantSpec:
    """One tenant's serving contract.

    ``weight`` is the tenant's token-budget share: over any backlogged
    interval it is entitled to ``weight / sum(weights of backlogged
    tenants)`` of the served tokens. ``priority`` classes are strict
    (higher wins admission and survives preemption longer) — use weights
    for proportional sharing inside a class, priorities for hard tiers.
    ``ttft_target_ms`` / ``tpot_target_ms`` define the SLA used for
    goodput and attainment reporting. ``max_queued`` / ``max_live_slots``
    are admission control: submissions beyond the queue cap are REJECTED
    (not silently queued forever), and live-slot caps stop one tenant from
    monopolizing the batch even when others are momentarily idle."""

    name: str
    weight: float = 1.0
    priority: int = 0
    ttft_target_ms: Optional[float] = None
    tpot_target_ms: Optional[float] = None
    max_queued: Optional[int] = None
    max_live_slots: Optional[int] = None


_DEFAULT_SPEC = TenantSpec(name="default")


class SLAPolicy(SchedulingPolicy):
    """Weighted-deficit + priority scheduling over ``PagedServer``'s
    policy hooks. Unknown tenants fall back to a weight-1 priority-0
    default spec, so the policy is always total.

    Served-token counters span CONTINUOUS backlog periods only (real
    WDRR semantics): a tenant entering the backlog joins at the current
    service floor (the least-served contender's normalized service), and
    a tenant whose work drains loses its counter. Tokens served while
    others were idle therefore never buy an unbounded catch-up window
    against a later arrival — the fairness horizon is the contention
    period, not process lifetime."""

    def __init__(self, tenants: Dict[str, TenantSpec]):
        self.tenants = dict(tenants)
        self.served: Dict[str, float] = {}
        self._backlogged: set = set()

    def _spec(self, name: str) -> TenantSpec:
        return self.tenants.get(name, _DEFAULT_SPEC)

    def _deficit(self, name: str) -> float:
        """Tokens served normalized by budget weight — smaller = more
        underserved. Admission minimizes it; preemption maximizes it."""
        return self.served.get(name, 0) / max(self._spec(name).weight, 1e-9)

    def _sync_backlog(self, queue: Sequence[Request], server) -> None:
        """Track idle<->backlogged transitions: newly backlogged tenants
        join at the current floor, drained tenants drop their counters."""
        current = {r.tenant for r in queue}
        if server is not None:
            current |= {r.tenant for r in server._active}
        newly = current - self._backlogged
        if newly:
            still = self._backlogged & current
            floor = min((self._deficit(t) for t in still), default=0.0)
            for t in newly:
                w = max(self._spec(t).weight, 1e-9)
                self.served[t] = max(self.served.get(t, 0.0), floor * w)
        for t in self._backlogged - current:
            self.served.pop(t, None)
        self._backlogged = current

    # --- hooks ----------------------------------------------------------
    def next_admission(self, queue: Sequence[Request], server: PagedServer):
        self._sync_backlog(queue, server)
        best = None
        best_key = None
        seen = set()
        for req in queue:  # queue order = FIFO within a tenant
            if req.tenant in seen:
                continue
            seen.add(req.tenant)
            spec = self._spec(req.tenant)
            if (
                spec.max_live_slots is not None
                and server.live_count(req.tenant) >= spec.max_live_slots
            ):
                continue
            key = (-spec.priority, self._deficit(req.tenant))
            if best is None or key < best_key:
                best, best_key = req, key
        return best

    def preemption_victim(
        self,
        candidates: Sequence[Request],
        server: PagedServer,
        for_req: Optional[Request] = None,
    ) -> Request:
        # lowest priority class first, most-over-budget tenant next,
        # youngest admission last — the exact inverse of admission order,
        # and always total (liveness: when the pool is dry SOMEONE yields,
        # even a high-priority request, rather than deadlocking)
        def badness(item):
            i, r = item
            spec = self._spec(r.tenant)
            return (spec.priority, -self._deficit(r.tenant), -i)

        return min(enumerate(candidates), key=badness)[1]

    def on_emit(self, req: Request, server: PagedServer) -> None:
        self.served[req.tenant] = self.served.get(req.tenant, 0) + 1


class MultiTenantServer:
    """Multi-tenant front over a ``PagedServer``: installs the
    ``SLAPolicy``, enforces per-tenant admission control at ``submit``,
    and reports per-tenant budget/goodput/SLA breakdowns.

    Compatible with the ``PagedServer`` surface the engine and the load
    harness drive (``submit`` / ``step`` / ``run`` / ``serve`` /
    ``has_work`` / ``result`` / ``serve_stats``)."""

    def __init__(
        self,
        server: PagedServer,
        tenants: Sequence[Union[TenantSpec, Dict]],
        default_tenant: str = "default",
    ):
        specs: Dict[str, TenantSpec] = {}
        for t in tenants or []:
            spec = t if isinstance(t, TenantSpec) else TenantSpec(**dict(t))
            specs[spec.name] = spec
        if default_tenant not in specs:
            specs[default_tenant] = TenantSpec(name=default_tenant)
        self.tenants = specs
        self.default_tenant = default_tenant
        self.server = server
        self.policy = SLAPolicy(specs)
        server.policy = self.policy
        self.rejected: Dict[str, int] = {name: 0 for name in specs}

    # --- intake with admission control ----------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int = 32,
        eos_token_id: Optional[int] = None,
        tenant: Optional[str] = None,
    ) -> Optional[int]:
        """Submit under a tenant's contract; returns the uid, or None when
        the tenant's queue cap rejects the request (overload shedding —
        the SLA answer to an unbounded queue is a fast no)."""
        tenant = tenant or self.default_tenant
        spec = self.tenants.get(tenant)
        if spec is None:
            raise KeyError(
                f"unknown tenant {tenant!r}: register it first "
                f"(known: {sorted(self.tenants)})"
            )
        if (
            spec.max_queued is not None
            and self.server.queued_count(tenant) >= spec.max_queued
        ):
            self.rejected[tenant] += 1
            return None
        return self.server.submit(
            prompt, max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
            tenant=tenant,
        )

    def register_tenant(self, spec: Union[TenantSpec, Dict]) -> None:
        spec = spec if isinstance(spec, TenantSpec) else TenantSpec(**dict(spec))
        self.tenants[spec.name] = spec
        self.policy.tenants[spec.name] = spec
        self.rejected.setdefault(spec.name, 0)

    # --- step-loop delegation -------------------------------------------
    def step(self) -> None:
        self.server.step()

    def run(self):
        return self.server.run()

    def has_work(self) -> bool:
        return self.server.has_work()

    def result(self, uid: int):
        return self.server.result(uid)

    def take_result(self, uid: int):
        return self.server.take_result(uid)

    def queued_count(self, tenant: Optional[str] = None) -> int:
        return self.server.queued_count(tenant)

    def live_count(self, tenant: Optional[str] = None) -> int:
        return self.server.live_count(tenant)

    def recover(self, states, next_uid: int = 0, migrated_in: bool = False) -> int:
        # fleet migration / crash adoption lands on the wrapped server; the
        # SLA policy sees the re-queued requests through its normal hooks
        return self.server.recover(states, next_uid, migrated_in=migrated_in)

    def extract_request(self, uid: int):
        return self.server.extract_request(uid)

    def finalize_migration(self, uid: int) -> None:
        self.server.finalize_migration(uid)

    def finished_log(self):
        return self.server.finished_log()

    @property
    def pool(self):
        return self.server.pool

    @property
    def stats(self):
        return self.server.stats

    @property
    def tracer(self):
        # the unified tracing plane lives on the wrapped PagedServer (one
        # timeline per engine); the SLA layer adds no phases of its own
        return self.server.tracer

    @property
    def metrics(self):
        return self.server.metrics

    def serve(
        self,
        prompts: Sequence,
        max_new_tokens=32,
        eos_token_id: Optional[int] = None,
        tenant=None,
    ) -> List[Optional[np.ndarray]]:
        """Batch convenience: ``tenant`` is a name or a per-request list.
        Rejected submissions return None in their output position."""
        n = len(prompts)
        if isinstance(max_new_tokens, (int, np.integer)):
            max_new_tokens = [max_new_tokens] * n
        if tenant is None or isinstance(tenant, str):
            tenant = [tenant or self.default_tenant] * n
        if len(max_new_tokens) != n or len(tenant) != n:
            raise ValueError(
                f"{n} prompts but {len(max_new_tokens)} max_new_tokens / "
                f"{len(tenant)} tenants"
            )
        uids = [
            self.submit(p, max_new_tokens=int(m), eos_token_id=eos_token_id,
                        tenant=t)
            for p, m, t in zip(prompts, max_new_tokens, tenant)
        ]
        self.server.run()
        return [None if u is None else self.server.take_result(u) for u in uids]

    # --- observability ---------------------------------------------------
    def serve_stats(self) -> Dict:
        """The base server's stats (incl. the multi-step window block —
        ``window_steps`` / ``dispatches_per_token`` /
        ``window_break_reasons``) with per-tenant SLA/budget breakdowns:
        ``budget_share`` (weight over all configured weights),
        ``goodput_share`` (fraction of served tokens), ``rejected``, and
        TTFT/TPOT SLA attainment (fraction of finished requests meeting
        the tenant's target; None when no target is set)."""
        s = self.server.serve_stats()
        tenants = s.setdefault("tenants", {})
        total_weight = sum(t.weight for t in self.tenants.values()) or 1.0
        total_tokens = sum(rec.get("tokens", 0) for rec in tenants.values())
        raw = self.server._tenant_stats
        for name, spec in self.tenants.items():
            rec = tenants.setdefault(
                name,
                {"submitted": 0, "finished": 0, "tokens": 0,
                 "ttft_ms": {"count": 0}, "tpot_ms": {"count": 0}},
            )
            rec["weight"] = spec.weight
            rec["priority"] = spec.priority
            rec["rejected"] = self.rejected.get(name, 0)
            rec["budget_share"] = spec.weight / total_weight
            rec["goodput_share"] = (
                rec.get("tokens", 0) / total_tokens if total_tokens else 0.0
            )
            for kind, target in (
                ("ttft", spec.ttft_target_ms),
                ("tpot", spec.tpot_target_ms),
            ):
                att = None
                samples = raw.get(name, {}).get(f"{kind}_ms", ())
                if target is not None and len(samples):
                    vals = np.asarray(samples, np.float64)
                    att = float((vals <= target).mean())
                rec[f"{kind}_sla_attainment"] = att
        return s
