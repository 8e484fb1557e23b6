"""Serving fleet: replicated paged servers behind one router.

Counterpart of ``deepspeed_tpu/inference/fleet.py``. A ``FleetRouter`` over
N replicas (``PagedServer`` or its ``MultiTenantServer`` front) keeps the
serving contracts (byte-identical greedy streams, journal-exact crash
recovery, SLA tenancy) across:

* prefix-affinity consistent-hash routing: a request is keyed by the
  deepest block of its prompt whose crc32 chain key
  (``prefix_chain_keys``, the process-portable analog of the pool's prefix
  chain) the router has routed before, and the key picks a replica on a
  ``ConsistentHashRing``, so requests sharing a system prompt land on the
  replica whose prefix cache holds it;
* live migration: ``migrate(uid)`` extracts the request's replay state
  (``PagedServer.extract_request``), seeds it on the target through
  ``recover(..., migrated_in=True)`` and lets the target re-prefill
  ``prompt + generated``, so the stream is byte-identical to one that never
  moved (``fleet_stats()['migrated_token_divergence']`` audits every acked
  prefix and must read 0). The target's journal holds the state before the
  source writes its migrated-out record;
* replica failure: each replica steps inside its own guard; a
  ``ChaosKilled`` out of its step is that replica dying, other exceptions
  trip a circuit breaker after ``breaker_threshold`` in a row, and
  ``probe()`` runs injectable health checks. A dead replica's requests
  re-route onto survivors from its journal (``RequestJournal.replay``), or
  from the router's shadow submissions (a full greedy recompute) when it
  ran without one;
* elastic ``drain`` (migrate everything off, then leave service), ``join``
  and ``adopt_journal`` (replay an orphaned journal and spread its
  requests); ``elasticity/fleet_policy.py`` decides when and
  ``autoscale_step`` carries it out;
* an optional prefill/decode role split: ``role="prefill"`` replicas admit,
  and the step a request has its first decode token it migrates to a
  ``role="decode"`` replica, which re-derives the KV it needs.

The router is host code: table lookups, crc32 hashing, journal replay. It
exposes the serving surface the load harness drives (``submit``, ``step``,
``run``, ``serve``, ``has_work``, ``result``, ``serve_stats``,
``finished_log``, and a ``clock`` setter that installs a clock on every
replica), so ``utils/loadgen.py`` replays traces across the fleet
unchanged. Replicas may share one weight tree; each owns its pool.

Replicas may be tensor-parallel servers (``PagedServer(tp=...)``): every
rank runs the same router over its own shard of each replica, and the
router's decisions (routing by crc32 chains, drains, kills, migration,
adoption) read only host state that is the same on every rank, in the same
order. A tensor-parallel replica's step error is raised, not counted by
the breaker.

Chaos points (``utils/chaos.py``): ``fleet.replica_kill`` at the top of a
replica's turn in the step loop, ``fleet.mid_migration`` between the
source's extraction and the target's seeding, ``fleet.mid_drain`` between
two migrations of a drain.
"""

from __future__ import annotations

import bisect
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.inference.journal import JournalCorruptError, JournaledRequest, RequestJournal
from deepspeed_tpu_torch.inference.tp import serving_tp
from deepspeed_tpu_torch.profiling.tracer import NULL_TRACER, MetricsRegistry, percentile_summary
from deepspeed_tpu_torch.utils import chaos
from deepspeed_tpu_torch.utils.logging import logger

# replica uid spaces: each attached replica's scheduler counter starts at a
# fresh stride, so uids are unique fleet-wide and a migrated request keeps
# its uid on the target (recover() re-admits under the original uid)
UID_STRIDE = 1 << 32

# same chain root as PagePool's prefix index — only equality matters, but
# sharing the constant keeps the two chain definitions visibly parallel
_ROOT_CHAIN = 0x9E3779B9

ACTIVE = "active"
DRAINING = "draining"
DRAINED = "drained"
DEAD = "dead"


def _crc(data: bytes, seed: int = 0) -> int:
    return zlib.crc32(data, seed & 0xFFFFFFFF) & 0xFFFFFFFF


def prefix_chain_keys(prompt, page_size: int) -> List[int]:
    """crc32 chain keys over the prompt's leading full ``page_size``-token
    blocks — key b names blocks [0..b] as a unit, exactly like the pool's
    prefix index chains, but process-portable (crc32, not ``hash()``) so a
    restarted router routes the same prompts to the same ring arcs. The
    last (partial) block never keys: it cannot be a shared cached page."""
    toks = np.ascontiguousarray(np.asarray(prompt, np.int32).reshape(-1))
    n_full = max(toks.size - 1, 0) // int(page_size)
    keys: List[int] = []
    chain = _ROOT_CHAIN
    for b in range(n_full):
        chain = _crc(toks[b * page_size : (b + 1) * page_size].tobytes(), chain)
        keys.append(chain)
    return keys


class ConsistentHashRing:
    """Classic consistent hashing: each node owns ``vnodes`` points on a
    2^32 ring; a key routes to the first node point clockwise from its
    hash. Adding/removing a node moves only that node's arcs — prefix
    affinity survives fleet resizes for every key not on a moved arc."""

    def __init__(self, vnodes: int = 32):
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, str]] = []  # sorted (hash, node)

    def add(self, name: str) -> None:
        for i in range(self.vnodes):
            self._points.append((_crc(f"{name}#{i}".encode()), name))
        self._points.sort()

    def remove(self, name: str) -> None:
        self._points = [(h, n) for h, n in self._points if n != name]

    def nodes(self) -> List[str]:
        return sorted({n for _, n in self._points})

    def lookup(self, key: int, accept: Callable[[str], bool]) -> Optional[str]:
        """First acceptable node clockwise from ``key`` (wrapping)."""
        if not self._points:
            return None
        start = bisect.bisect_left(self._points, (key & 0xFFFFFFFF, ""))
        n = len(self._points)
        seen = set()
        for off in range(n):
            _, name = self._points[(start + off) % n]
            if name in seen:
                continue
            seen.add(name)
            if accept(name):
                return name
        return None


@dataclass
class ReplicaHandle:
    """One replica in the fleet: the server (a ``PagedServer`` or its
    ``MultiTenantServer`` front), its journal directory (the recovery
    source of truth when it dies), its service role, and the router's
    health bookkeeping."""

    name: str
    server: object
    journal_dir: Optional[str] = None
    role: str = "any"  # any | prefill | decode
    state: str = ACTIVE
    failures: int = 0  # consecutive step/probe failures (circuit breaker)
    uid_base: int = 0
    health_fn: Optional[Callable] = None  # injectable probe; None = liveness only

    def __post_init__(self):
        if self.role not in ("any", "prefill", "decode"):
            raise ValueError(f"replica role must be any|prefill|decode, got {self.role!r}")

    @property
    def inner(self):
        """The underlying ``PagedServer`` (unwraps a MultiTenantServer)."""
        return getattr(self.server, "server", self.server)


def _pool_geometry(handle: ReplicaHandle) -> Tuple[int, int, int, int]:
    """The pool shape every replica must share (page size, pages, slots,
    max length): migration and re-routing assume that any request fits any
    replica. The one definition the constructor and ``join`` check."""
    pool = handle.inner.pool
    return (pool.page_size, pool.num_pages, pool.max_slots, pool.max_seq_len)


class FleetRouter:
    """The fleet front door: routes, steps, migrates, and supervises N
    replicas. See the module docstring for the design; the surface is
    deliberately the serving-server surface so the engine-side callers and
    the load harness treat a fleet exactly like one big server."""

    def __init__(
        self,
        replicas: Sequence[ReplicaHandle],
        vnodes: int = 32,
        affinity: bool = True,
        breaker_threshold: int = 3,
        integrity_checks: bool = True,
        tracer=None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.affinity = bool(affinity)
        self.breaker_threshold = int(breaker_threshold)
        self.integrity_checks = bool(integrity_checks)
        self.replicas: Dict[str, ReplicaHandle] = {}
        self._ring = ConsistentHashRing(vnodes)
        self._where: Dict[int, str] = {}  # outstanding uid -> replica name
        self._shadow: Dict[int, JournaledRequest] = {}  # uid -> submit state
        # acked tokens a migrated request carried: its final output must
        # reproduce them verbatim (the divergence metric's ground truth)
        self._acked: Dict[int, List[int]] = {}
        # uid -> journaled replica still holding the durable claim for a
        # request that migrated to a journal-less target (released when
        # the request finishes)
        self._claims: Dict[int, str] = {}
        self._results: Dict[int, np.ndarray] = {}
        # chain key -> owning replica, LRU-bounded: unlike the pool's
        # prefix index (bounded by page capacity) this is pure routing
        # memory, and unique-prompt traffic would otherwise grow it one
        # entry per full prompt page forever. Evicting a cold chain only
        # costs its next request a ring placement, not correctness.
        self._chains: "OrderedDict[int, str]" = OrderedDict()
        self._chains_cap = 1 << 16
        self._next_stride = 0
        # stride index -> lowest safe next uid (absolute): adopted journals
        # carry uids from a PREVIOUS fleet's strides, and a replica that
        # lands on the same stride must allocate past them or two requests
        # share a uid in the fleet-global maps
        self._uid_floor: Dict[int, int] = {}
        self._clock = None
        self.stats = {
            "routed": 0,
            "rejected": 0,
            "migrations": 0,  # cooperative migrate() moves (incl. drains)
            "role_migrations": 0,  # prefill->decode handoffs
            "rerouted": 0,  # dead-replica requests re-placed on survivors
            "replica_kills": 0,
            "drains": 0,
            "joins": 0,
            "adopted": 0,  # requests adopted from orphaned journals
            "migrated_token_divergence": 0,  # MUST stay 0
        }
        # one pool geometry: a request that fits one replica fits every other
        geos = {_pool_geometry(h) for h in replicas}
        if len(geos) > 1:
            raise ValueError(
                f"fleet replicas must share one pool geometry "
                f"(page_size, num_pages, max_slots, max_seq_len); got {sorted(geos)}"
            )
        self.page_size = next(iter(geos))[0]
        for h in replicas:
            self._attach(h)

    # --- membership -----------------------------------------------------
    def _attach(self, handle: ReplicaHandle) -> None:
        if handle.name in self.replicas:
            raise ValueError(f"duplicate replica name {handle.name!r}")
        handle.uid_base = self._next_stride * UID_STRIDE
        inner = handle.inner
        inner._next_uid = max(
            inner._next_uid, handle.uid_base,
            self._uid_floor.get(self._next_stride, 0),
        )
        self._next_stride += 1
        self.replicas[handle.name] = handle
        if handle.state == ACTIVE:
            self._ring.add(handle.name)
        # a replica attached with replayed state (restart): track it
        for req in list(inner._queue) + list(inner._active):
            self._where[req.uid] = handle.name
            self._shadow.setdefault(
                req.uid,
                JournaledRequest(
                    uid=req.uid, prompt=np.asarray(req.prompt, np.int32),
                    max_new_tokens=int(req.max_new_tokens),
                    eos_token_id=req.eos_token_id, tenant=req.tenant,
                ),
            )
        for uid in list(inner._results):
            self._results[uid] = inner.take_result(uid)
        if self._clock is not None:
            inner.clock = self._clock

    def join(
        self,
        server,
        name: Optional[str] = None,
        journal_dir: Optional[str] = None,
        role: str = "any",
        catchup_dir: Optional[str] = None,
    ) -> ReplicaHandle:
        """Elastic scale-up: attach a fresh replica (same pool geometry).
        With ``catchup_dir``, journal-catch-up join: an orphaned journal
        (typically a dead replica's) is replayed and its outstanding
        requests adopted across the fleet — the new capacity arrives
        already carrying the dead replica's load."""
        name = name or f"r{self._next_stride}"
        handle = ReplicaHandle(
            name=name, server=server, journal_dir=journal_dir, role=role
        )
        geo = _pool_geometry(handle)
        have = next(
            (_pool_geometry(h) for h in self.replicas.values()), None
        )
        if have is not None and geo != have:
            raise ValueError(
                f"joining replica {name!r} breaks the fleet pool geometry: "
                f"{geo} vs {have}"
            )
        self._attach(handle)
        self.stats["joins"] += 1
        self.tracer.event("fleet.join", replica=name, role=role)
        if catchup_dir:
            self.adopt_journal(catchup_dir)
        return handle

    def drain(self, name: str) -> int:
        """Elastic scale-down: stop routing to the replica, migrate every
        queued and live request off it (acked tokens ride the replay state
        verbatim — zero dropped), and remove it from service. Returns how
        many requests moved. A kill landing mid-drain (``fleet.mid_drain``
        / ``fleet.mid_migration``) is the draining replica dying: the
        router fails it and the remainder re-routes from its journal."""
        h = self.replicas[name]
        if h.state == DEAD:
            return 0
        h.state = DRAINING
        self._ring.remove(name)
        self.stats["drains"] += 1
        moved = 0
        with self.tracer.span("fleet.drain", replica=name):
            self._collect_results()
            inner = h.inner
            uids = [r.uid for r in list(inner._queue)] + [
                r.uid for r in list(inner._active)
            ]
            for uid in uids:
                try:
                    chaos.point("fleet.mid_drain", replica=name, uid=uid)
                    if self.migrate(uid):
                        moved += 1
                except chaos.ChaosKilled:
                    self.fail_replica(name, reason="killed mid-drain")
                    return moved
                except Exception:
                    # the remainder has nowhere to go (e.g. last active
                    # replica): migrate() already put the request back, so
                    # return the replica to service rather than leaving it
                    # half-drained and unroutable
                    h.state = ACTIVE
                    self._ring.add(name)
                    raise
            h.state = DRAINED
        return moved

    def fail_replica(self, name: str, reason: str = "killed") -> int:
        """Mark a replica dead and re-route its outstanding requests onto
        the survivors. Idempotent and re-entrant: a crash INSIDE the
        re-routing (``fleet.mid_migration``) leaves the remaining requests
        still mapped to the dead replica, and calling again finishes the
        job — nothing is ever lost while the journal (or the router's
        shadow) holds the state. Returns how many requests re-routed."""
        h = self.replicas[name]
        if h.state != DEAD:
            h.state = DEAD
            self._ring.remove(name)
            self.stats["replica_kills"] += 1
            self.tracer.event("fleet.replica_dead", replica=name, reason=reason)
            self.metrics.counter("fleet.replica_kills").inc()
            logger.warning(f"fleet: replica {name!r} failed ({reason}); re-routing")
        return self._reroute_from(h)

    kill_replica = fail_replica  # the chaos/test-facing name

    # --- routing --------------------------------------------------------
    def _routable(self, roles: Tuple[str, ...]) -> Callable[[str], bool]:
        def accept(name: str) -> bool:
            h = self.replicas.get(name)
            return h is not None and h.state == ACTIVE and h.role in roles

        return accept

    def _admit_roles(self) -> Tuple[str, ...]:
        """New submissions go to prefill-capable replicas when the fleet
        is role-split; an all-decode remnant still serves (degraded) so a
        prefill-tier outage never refuses the whole fleet."""
        active_roles = {
            h.role for h in self.replicas.values() if h.state == ACTIVE
        }
        if "prefill" in active_roles or "any" in active_roles:
            return ("prefill", "any")
        return ("decode",)

    def _remember_chains(self, keys: List[int], name: str) -> None:
        for k in keys:
            self._chains[k] = name
            self._chains.move_to_end(k)
        while len(self._chains) > self._chains_cap:
            self._chains.popitem(last=False)  # coldest chain out

    def _route(
        self,
        prompt,
        roles: Optional[Tuple[str, ...]] = None,
        exclude: Iterable[str] = (),
    ) -> Optional[ReplicaHandle]:
        roles = roles or self._admit_roles()
        exclude = set(exclude)
        accept = self._routable(roles)
        keys = prefix_chain_keys(prompt, self.page_size)
        if self.affinity:
            # deepest block whose chain the router has routed before goes
            # straight to its owning replica — that replica has (very
            # likely) cached the prefix; the ring only places UNSEEN
            # prefixes (and re-places chains whose owner left the fleet)
            for k in reversed(keys):
                owner = self._chains.get(k)
                if owner is not None and accept(owner) and owner not in exclude:
                    self._remember_chains(keys, owner)
                    return self.replicas[owner]
            key = keys[0] if keys else _crc(
                np.ascontiguousarray(np.asarray(prompt, np.int32)).tobytes()
            )
        else:
            # affinity off (the A/B baseline): spread on a rotating key
            key = _crc(str(self.stats["routed"] + self.stats["rerouted"]).encode())
        name = self._ring.lookup(key, lambda n: accept(n) and n not in exclude)
        if name is None:
            return None
        self._remember_chains(keys, name)
        return self.replicas[name]

    # --- request intake -------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int = 32,
        eos_token_id: Optional[int] = None,
        tenant: str = "default",
    ) -> Optional[int]:
        """Route and submit one request; returns the fleet-wide uid, or
        None when the owning replica's admission control rejected it."""
        with self.tracer.span("fleet.route"):
            h = self._route(prompt)
            if h is None:
                raise RuntimeError("fleet has no active replica to route to")
            uid = h.server.submit(
                prompt, max_new_tokens=max_new_tokens,
                eos_token_id=eos_token_id, tenant=tenant,
            )
        if uid is None:
            self.stats["rejected"] += 1
            return None
        self._where[uid] = h.name
        self._shadow[uid] = JournaledRequest(
            uid=uid, prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens), eos_token_id=eos_token_id,
            tenant=tenant,
        )
        self.stats["routed"] += 1
        self.metrics.counter("fleet.routed").inc()
        return uid

    # --- the fleet step -------------------------------------------------
    def step(self) -> None:
        """One scheduler round across the fleet: step every serving
        replica inside its failure guard, harvest finished results, and
        run the role-split handoffs. Each replica's step is still its own
        one call (or one window); the router adds no device work."""
        with self.tracer.span("fleet.step"):
            for h in list(self.replicas.values()):
                if h.state not in (ACTIVE, DRAINING):
                    continue
                if not h.inner.has_work():
                    continue
                self._step_replica(h)
            self._collect_results()
            self._role_handoffs()
        self.metrics.counter("fleet.steps").inc()

    def _step_replica(self, h: ReplicaHandle) -> None:
        try:
            chaos.point("fleet.replica_kill", replica=h.name)
            with self.tracer.span("fleet.replica_step", replica=h.name):
                h.server.step()
            h.failures = 0
        except chaos.ChaosKilled:
            # the replica is the failure domain: a kill unwinding out of
            # its step is THAT replica dying, observed by the supervisor —
            # the in-process analog of a monitor seeing a dead process.
            # (chaos's BaseException contract exists so the replica's own
            # recovery code cannot swallow a kill; the router is not the
            # replica's recovery code.)
            self.fail_replica(h.name, reason="chaos kill in step")
        except Exception as e:  # noqa: BLE001 — the breaker's whole job
            if serving_tp(h.server) is not None:
                # a tensor-parallel replica's failure may be one rank's alone, its peers waiting in a
                # collective: no breaker can decide alike on every rank
                raise
            h.failures += 1
            logger.warning(
                f"fleet: replica {h.name!r} step failed "
                f"({h.failures}/{self.breaker_threshold}): {type(e).__name__}: {e}"
            )
            if h.failures >= self.breaker_threshold:
                self.fail_replica(
                    h.name, reason=f"circuit breaker: {type(e).__name__}: {e}"
                )

    def probe(self) -> Dict[str, bool]:
        """Health-probe every serving replica (the injectable
        ``health_fn``; default is pure liveness — the step guard already
        catches crashes). Consecutive failures trip the same circuit
        breaker as step failures."""
        out: Dict[str, bool] = {}
        for h in list(self.replicas.values()):
            if h.state not in (ACTIVE, DRAINING):
                continue
            try:
                ok = bool(h.health_fn(h.server)) if h.health_fn else True
            except Exception:
                ok = False
            if ok:
                h.failures = 0
            else:
                h.failures += 1
                if h.failures >= self.breaker_threshold:
                    self.fail_replica(h.name, reason="health probe circuit breaker")
            out[h.name] = ok
        return out

    def has_work(self) -> bool:
        return any(
            h.state in (ACTIVE, DRAINING) and h.inner.has_work()
            for h in self.replicas.values()
        )

    def run(self) -> Dict[int, np.ndarray]:
        while self.has_work():
            self.step()
        return self._results

    def serve(
        self,
        prompts: Sequence,
        max_new_tokens=32,
        eos_token_id: Optional[int] = None,
        tenant="default",
    ) -> List[Optional[np.ndarray]]:
        """Batch convenience mirroring the single-server fronts: scalar or
        per-request budgets, scalar or per-request tenants; rejected
        submissions return None in their slot."""
        n = len(prompts)
        if isinstance(max_new_tokens, (int, np.integer)):
            max_new_tokens = [max_new_tokens] * n
        if isinstance(tenant, str):
            tenant = [tenant] * n
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
        self.run()
        return [None if u is None else self.take_result(u) for u in uids]

    # --- results --------------------------------------------------------
    def _collect_results(self) -> None:
        for h in self.replicas.values():
            if h.state == DEAD:
                continue
            inner = h.inner
            for uid in list(inner._results):
                self._finish_result(uid, inner.take_result(uid))

    def _finish_result(self, uid: int, out: np.ndarray) -> None:
        """Book one finished output and settle the divergence check: a
        migrated request's acked prefix must appear verbatim in the final
        stream (byte-identical migration is a contract, and this counter
        is its audit)."""
        holder = self._claims.pop(uid, None)
        if holder is not None:
            # the output is delivered: the journaled source that kept the
            # durable claim for this journal-less-target migration can
            # disclaim it now (a dead holder's journal resurrects the
            # request on adoption instead — at-least-once, deduped)
            hrep = self.replicas.get(holder)
            if hrep is not None and hrep.state != DEAD:
                hrep.inner.release_migrated_claim(uid)
        acked = self._acked.pop(uid, None)
        shadow = self._shadow.pop(uid, None)
        if acked and shadow is not None:
            p = int(np.asarray(shadow.prompt).size)
            got = np.asarray(out[p : p + len(acked)])
            want = np.asarray(acked, np.int32)
            if got.size < want.size or not np.array_equal(got, want[: got.size]):
                self.stats["migrated_token_divergence"] += 1
                logger.error(
                    f"fleet: request {uid} diverged from its acked prefix "
                    f"after migration ({want.tolist()} vs {got.tolist()})"
                )
        self._where.pop(uid, None)
        self._results[uid] = out

    def result(self, uid: int) -> Optional[np.ndarray]:
        if uid not in self._results:
            self._collect_results()
        return self._results.get(uid)

    def take_result(self, uid: int) -> Optional[np.ndarray]:
        if uid not in self._results:
            self._collect_results()
        return self._results.pop(uid, None)

    # --- migration ------------------------------------------------------
    def migrate(
        self,
        uid: int,
        target: Optional[str] = None,
        roles: Optional[Tuple[str, ...]] = None,
    ) -> bool:
        """Live-migrate one request: extract its replay state from the
        source replica, re-seed it durably on the target (journal-first),
        then retire it from the source journal. Byte-identical streams by
        the recompute contract; acked tokens audited at finish. A kill at
        ``fleet.mid_migration`` models the source dying with the state off
        its scheduler but its journal still claiming the request — callers
        that own a failure domain (the step loop, ``drain``) catch it and
        ``fail_replica`` the source, which replays the journal and loses
        nothing."""
        src_name = self._where.get(uid)
        if src_name is None:
            return False  # already finished (or never routed)
        src = self.replicas[src_name]
        if target is not None:
            # validate BEFORE extraction: a bad explicit target must be a
            # pure no-op, not a tear-off-and-restore round trip
            tgt = self.replicas[target]
            if tgt.state != ACTIVE or tgt.name == src_name:
                raise ValueError(
                    f"migration target {target!r} is not an active "
                    f"other replica"
                )
        with self.tracer.span("fleet.migrate", uid=uid, source=src_name):
            state = src.inner.extract_request(uid)
            if state is None:
                # finished between the caller's snapshot and now
                self._collect_results()
                return False
            if target is None:
                tgt = self._route(
                    state.prompt, roles=roles, exclude={src_name}
                )
                if tgt is None:
                    # no eligible target (single-replica fleet): put the
                    # state back on the source instead of stranding it off
                    # every scheduler — the stream continues
                    # byte-identically where it was, and the extraction's
                    # migration accounting is undone (nothing moved)
                    src.inner.restore_request(state)
                    raise RuntimeError(
                        f"no active replica to migrate request {uid} to"
                    )
            chaos.point("fleet.mid_migration", uid=uid, source=src_name,
                        target=tgt.name)
            self._place_states(tgt, {uid: state})
            self.stats["migrations"] += 1
            self.metrics.counter("fleet.migrations").inc()
            # source-side journal hand-off LAST: the state is durable on
            # the target before the source disclaims it. A journal-less
            # target never durably claims the request, so the source must
            # KEEP its claim — disclaiming would leave the state in
            # neither journal and a crash would lose acked tokens. The
            # retained claim rides the source's compactions and is
            # disclaimed when the request finishes (_finish_result); the
            # double-claim window it opens is the one adoption dedupes
            if tgt.inner.journal is not None:
                src.inner.finalize_migration(uid)
            elif src.inner.journal is not None:
                src.inner.retain_migrated_claim(uid, state)
                self._claims[uid] = src_name
        return True

    def _place_states(
        self,
        tgt: ReplicaHandle,
        states: Dict[int, JournaledRequest],
        migrated_in: bool = True,
    ) -> None:
        """Seed a batch of replay states onto one target replica: ONE
        ``recover()`` (one journal sync + segment scan however many
        requests arrive — failover re-routes a dead replica's whole load
        through here) and one pool assert, then the router's per-request
        bookkeeping. ``migrated_in=False`` is the adoption-after-restart
        form: the previous fleet's counters and clock died with it, so
        the target claims the submits and restamps the clock."""
        inner = tgt.inner
        inner.recover(states, 0, migrated_in=migrated_in)
        if self.integrity_checks:
            # the post-migration pool assert: adoption re-queues through
            # the normal admission path, and the target pool must be
            # internally consistent before its next dispatch
            inner.pool.integrity_check()
        for uid, state in states.items():
            self._where[uid] = tgt.name
            self._shadow.setdefault(
                uid,
                JournaledRequest(
                    uid=uid, prompt=np.asarray(state.prompt, np.int32),
                    max_new_tokens=int(state.max_new_tokens),
                    eos_token_id=state.eos_token_id, tenant=state.tenant,
                ),
            )
            if state.generated:
                self._acked[uid] = [int(t) for t in state.generated]

    def _reroute_from(self, h: ReplicaHandle) -> int:
        """Re-place every outstanding request still mapped to a dead
        replica: journal replay is the source of truth (acked tokens ride
        verbatim); the router's shadow submissions are the journal-less
        fallback (full recompute — still byte-identical under greedy)."""
        uids = [u for u, n in self._where.items() if n == h.name]
        if not uids:
            return 0
        states: Dict[int, JournaledRequest] = {}
        if h.journal_dir:
            try:
                states, _ = RequestJournal.replay(h.journal_dir)
            except JournalCorruptError as e:
                logger.error(
                    f"fleet: journal of dead replica {h.name!r} is corrupt "
                    f"({e}); falling back to shadow resubmission"
                )
                states = {}
        moved = 0
        placements: Dict[str, Dict[int, JournaledRequest]] = {}
        for uid in sorted(uids):
            st = states.get(uid) or self._shadow.get(uid)
            if st is None:
                logger.error(f"fleet: request {uid} lost with replica {h.name!r}")
                continue
            if st.done:
                self._finish_result(
                    uid,
                    np.concatenate([
                        np.asarray(st.prompt, np.int32),
                        np.asarray(st.generated, np.int32),
                    ]),
                )
                moved += 1
                continue
            tgt = self._route(st.prompt, exclude={h.name})
            if tgt is None:
                raise RuntimeError(
                    f"fleet: no surviving replica for request {uid}"
                )
            chaos.point("fleet.mid_migration", uid=uid, source=h.name,
                        target=tgt.name)
            placements.setdefault(tgt.name, {})[uid] = st
        # one batched recover per surviving target: the failover window
        # pays one journal sync + pool assert per TARGET, not per request
        # (a kill during the routing loop above placed nothing — every
        # request is still mapped to the dead replica and the re-entrant
        # call re-routes them; a kill between targets leaves the placed
        # batch placed and the rest recoverable, same contract as before)
        for tname in sorted(placements):
            batch = placements[tname]
            self._place_states(self.replicas[tname], batch)
            self.stats["rerouted"] += len(batch)
            moved += len(batch)
        return moved

    def adopt_journal(self, directory: str) -> int:
        """Journal-catch-up: replay an orphaned journal directory (a dead
        replica's, after a process-level ``kill -9`` and restart) and
        place its outstanding requests across the fleet. Requests the
        fleet already tracks are skipped — the live copy (seeded from the
        target journal during a migration whose source-side retirement
        the crash ate) always carries at least as many acked tokens as
        the stale claim, so dedup keeps the superset."""
        states, next_uid = RequestJournal.replay(directory)
        # adopted uids come from a previous fleet's stride space: raise the
        # per-stride allocation floor past them (and past the dead server's
        # own counter) so no current or future replica on the same stride
        # hands out a uid the fleet already tracks
        floors: Dict[int, int] = {}
        for uid in states:
            s = uid // UID_STRIDE
            floors[s] = max(floors.get(s, 0), uid + 1)
        if next_uid > 0:
            s = (next_uid - 1) // UID_STRIDE
            floors[s] = max(floors.get(s, 0), next_uid)
        for s, floor in floors.items():
            self._uid_floor[s] = max(self._uid_floor.get(s, 0), floor)
        for h in self.replicas.values():
            s = h.uid_base // UID_STRIDE
            if s in floors:
                h.inner._next_uid = max(h.inner._next_uid, floors[s])
        adopted = 0
        placements: Dict[str, Dict[int, JournaledRequest]] = {}
        for uid in sorted(states):
            if uid in self._where or uid in self._results:
                continue  # double-claim from a mid-migration crash: live copy wins
            st = states[uid]
            if st.done:
                self._finish_result(
                    uid,
                    np.concatenate([
                        np.asarray(st.prompt, np.int32),
                        np.asarray(st.generated, np.int32),
                    ]),
                )
                adopted += 1
                continue
            tgt = self._route(st.prompt)
            if tgt is None:
                raise RuntimeError("fleet: no active replica to adopt into")
            placements.setdefault(tgt.name, {})[uid] = st
        for tname in sorted(placements):
            # migrated_in=False: the previous fleet died with its counters
            # and clock — the adopting replica claims the submits and the
            # journaled timestamps are restamped against the live clock
            self._place_states(
                self.replicas[tname], placements[tname], migrated_in=False
            )
            adopted += len(placements[tname])
        self.stats["adopted"] += adopted
        return adopted

    # --- prefill/decode role split --------------------------------------
    def _role_handoffs(self) -> None:
        """Migration-at-first-decode: the step a request on a prefill-role
        replica holds its first decode token, hand it to a decode replica.
        The KV handoff is the migration itself — the decode replica
        re-derives (or prefix-attaches) the KV it needs."""
        decode_targets = any(
            h.state == ACTIVE and h.role in ("decode", "any")
            for h in self.replicas.values()
        )
        if not decode_targets:
            return
        for h in list(self.replicas.values()):
            if h.state != ACTIVE or h.role != "prefill":
                continue
            ready = [
                r.uid
                for r in list(h.inner._active)
                if r.pending is not None and not r.done
            ]
            for uid in ready:
                try:
                    if self.migrate(uid, roles=("decode", "any")):
                        self.stats["role_migrations"] += 1
                except chaos.ChaosKilled:
                    self.fail_replica(h.name, reason="killed mid-handoff")
                    break

    # --- elasticity -----------------------------------------------------
    def autoscale_step(self, policy, spawn: Callable[[], object], step: int) -> int:
        """Drive an ``elasticity.FleetResizePolicy``: compute the backlog,
        ask for a target size, then drain the least-loaded replicas (scale
        down) or ``spawn()`` + ``join`` fresh ones (scale up). Returns the
        signed size delta actually applied."""
        active = [h for h in self.replicas.values() if h.state == ACTIVE]
        backlog = sum(
            h.inner.queued_count() + h.inner.live_count() for h in active
        )
        target = policy.decide(backlog=backlog, n_active=len(active), step=step)
        delta = target - len(active)
        if delta > 0:
            for _ in range(delta):
                self.join(spawn())
        elif delta < 0:
            by_load = sorted(
                active,
                key=lambda h: h.inner.queued_count() + h.inner.live_count(),
            )
            for h in by_load[: -delta]:
                self.drain(h.name)
        return delta

    # --- observability ---------------------------------------------------
    @property
    def clock(self):
        return self._clock

    @clock.setter
    def clock(self, fn) -> None:
        # the load harness installs its virtual clock through this setter
        # (it treats the router as the innermost server); every replica's
        # TTFT/TPOT stamps must live on the same axis
        self._clock = fn
        for h in self.replicas.values():
            h.inner.clock = fn

    @property
    def tenants(self) -> Dict:
        """Merged tenant specs across MultiTenantServer replicas (the load
        harness reads weights/targets for goodput accounting)."""
        merged: Dict = {}
        for h in self.replicas.values():
            merged.update(getattr(h.server, "tenants", {}) or {})
        return merged

    def finished_log(self) -> List:
        out: List = []
        for h in self.replicas.values():
            try:
                out.extend(h.server.finished_log())
            except Exception:
                pass  # an unresponsive dead replica drops only its history
        return out

    _percentiles = staticmethod(percentile_summary)

    def fleet_stats(self) -> Dict:
        """The router's own block: counters, per-replica state/role/load,
        and ring membership. ``serve_stats()`` embeds it under ``fleet``."""
        reps = {}
        for name, h in self.replicas.items():
            inner = h.inner
            reps[name] = {
                "state": h.state,
                "role": h.role,
                "failures": h.failures,
                "uid_base": h.uid_base,
                "journal_dir": h.journal_dir,
                "queued": inner.queued_count() if h.state != DEAD else None,
                "live": inner.live_count() if h.state != DEAD else None,
            }
        return {
            **self.stats,
            "n_replicas": len(self.replicas),
            "n_active": sum(
                1 for h in self.replicas.values() if h.state == ACTIVE
            ),
            "ring_nodes": self._ring.nodes(),
            "outstanding": len(self._where),
            "chains_tracked": len(self._chains),
            "replicas": reps,
        }

    def serve_stats(self) -> Dict:
        """Fleet-merged serving stats, shaped like one server's: summed
        scheduler/pool/speculation counters, TTFT/TPOT percentiles
        recomputed over every replica's finished requests, per-tenant
        breakdowns merged the same way, a merged ``prefix`` block with the
        fleet-wide hit rate, per-replica blocks under ``replicas``, and
        the router's own block under ``fleet``. Dead replicas' counters
        stay in the merge (their served work happened — dropping it would
        make the counters disagree with ``finished_log`` and the replay
        report's goodput); an in-process dead replica still answers from
        host state, and one that cannot is skipped."""
        per: Dict[str, Dict] = {}
        for name, h in self.replicas.items():
            try:
                per[name] = h.server.serve_stats()
            except Exception:
                continue  # unresponsive dead replica: history unavailable
        merged: Dict = {}
        skip = {
            "ttft_ms", "tpot_ms", "tenants", "prefix", "window_break_reasons",
            "spec_accept_hist", "dispatches_per_token", "spec_accept_rate",
            "spec_mean_accepted_per_round", "pool_utilization",
            "window_horizon",
        }
        for rep in per.values():
            for k, v in rep.items():
                if k in skip or not isinstance(v, (int, float)):
                    continue
                merged[k] = merged.get(k, 0) + v
        merged["dispatches_per_token"] = (
            merged.get("dispatches", 0) / merged["emitted_tokens"]
            if merged.get("emitted_tokens")
            else 0.0
        )
        # latency percentiles recomputed from the union of finished
        # requests (per-replica percentiles cannot merge)
        logs = self.finished_log()
        merged["ttft_ms"] = self._percentiles([t for _, t, _, _ in logs])
        merged["tpot_ms"] = self._percentiles(
            [t for _, _, t, _ in logs if t is not None]
        )
        tenants: Dict[str, Dict] = {}
        for rep in per.values():
            for tname, rec in rep.get("tenants", {}).items():
                agg = tenants.setdefault(
                    tname, {"submitted": 0, "finished": 0, "tokens": 0}
                )
                for k in ("submitted", "finished", "tokens", "rejected"):
                    if k in rec:
                        agg[k] = agg.get(k, 0) + rec[k]
        for tname, agg in tenants.items():
            agg["ttft_ms"] = self._percentiles(
                [t for tn, t, _, _ in logs if tn == tname]
            )
            agg["tpot_ms"] = self._percentiles(
                [t for tn, _, t, _ in logs if tn == tname and t is not None]
            )
        merged["tenants"] = tenants
        prefix: Dict = {}
        for rep in per.values():
            for k, v in rep.get("prefix", {}).items():
                if isinstance(v, (int, float)) and k != "prefix_hit_rate":
                    prefix[k] = prefix.get(k, 0) + v
        q = prefix.get("prefix_query_tokens", 0)
        prefix["prefix_hit_rate"] = (
            prefix.get("prefix_hit_tokens", 0) / q if q else 0.0
        )
        merged["prefix"] = prefix
        merged["replicas"] = per
        merged["fleet"] = self.fleet_stats()
        return merged
