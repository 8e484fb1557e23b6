"""Continuous-batching scheduler over the paged KV pool.

Counterpart of ``deepspeed_tpu/inference/scheduler.py``'s ``PagedServer``:
requests are admitted whenever a slot and enough pages exist and evicted
the step they finish; prompts prefill in fixed-size chunks; when the pool
runs dry the policy's victim (default: the youngest request) is preempted
and recomputed on re-admission, which greedy decoding makes token-exact;
with prefix caching the longest indexed full-page prefix of a request
attaches by reference, and prefill resumes realigned to the cold chunk
grid. Two modes:

* ragged (the default): every scheduler step is ONE call of
  ``decode.build_ragged_step``: every active row contributes a prefill
  chunk, its pending decode token, or its pending token and its drafts (a
  verify row), to a ``[max_slots, W]`` window with per-row
  ``(kv_len, q_len)`` arrays (attention K4). Per step the host
  makes one small host->device copy (tokens, page table, lengths and
  q_lens packed into one int32 buffer) and one ``[R, W+1]`` device->host
  fetch, which is the step's only synchronisation;
* bucketed (``ragged=False``, the token-exactness oracle): each step runs
  one ``build_paged_prefill`` call per prefilling row's next chunk, then
  one ``build_paged_decode_step`` call over the running rows padded to the
  smallest slot bucket that covers them (attention K5), or, when some row
  drafted, one ``build_paged_verify_step`` call of the smallest compiled
  draft width that covers the longest draft. Greedy streams are
  byte-identical to the ragged mode's.

With speculative decoding (``spec_decode``, or an explicit ``drafter``)
each round first asks a host-side ``Drafter`` (``spec_decode.py``) for up
to ``draft_cap`` tokens a running request, clamped to its budget; the verify
rows accept the longest prefix equal to the model's own greedy argmax, the
rejected tail's pages roll back to the pool, and greedy streams stay
byte-identical to speculation-off serving.

With ``multi_step`` armed (ragged mode only), a step whose running set is
stable (nothing queued, nothing prefilling, every row's pages for the whole
window reservable without preemption) runs ONE window of ``horizon``
plain-decode rounds (``decode.build_ragged_multistep``): on a card one
replay of a CUDA graph captured once per server (``decode.WindowGraph``,
over ``max_slots`` rows), on the CPU the same body eagerly; one host
fetch of the packed ``[R, 1+N]`` tokens either way. Any scheduling event
breaks the window back to the single-step path (``window_break_reasons``
names it; a step where some row drafted breaks with "draft" and hands its
drafts to the single step, so the drafter is asked once a step), and greedy
streams stay byte-identical.

With a ``journal`` (``journal.py``) every submit, first token, emitted
token and finish is appended, and made durable once a step
(``journal.sync()`` at the end of ``step()``; a submit at once). A
restarted server replays the directory and ``recover`` re-queues every live
request with its journaled tokens pre-seeded: its re-admission re-prefills
``prompt + generated`` on the cold chunk grid, which is what makes a
recompute preemption invisible, and the stream resumes byte-identically.
The chaos points ``serve.mid_step`` and ``serve.mid_window``
(``utils/chaos.py``) sit just before the journal flush.

The fleet half (``inference/fleet.py``) moves live requests between
servers: ``extract_request`` takes one off this server as replay state,
``recover(..., migrated_in=True)`` seeds it on another with its stamps kept,
and the journal hand-off (``finalize_migration``, or a retained claim while
the target runs without a journal) writes the source's migrated-out record
only after the target holds the request durably. Admission order and
preemption victims go through a ``SchedulingPolicy`` (``traffic.py``'s
``SLAPolicy`` is the multi-tenant one), and every stamp reads the server's
injectable ``clock`` (the load harness's virtual clock, ``utils/loadgen.py``).

With ``tp`` (``inference/tp.py:TPServing``) the server is one rank of a
tensor-parallel group, one process a rank: the weights are this rank's
shard, the pools hold ``NKV / tp`` kv heads, and page tables, the prefix
index, copy-on-write and the journal stay whole on every rank, as in JAX.
Every rank runs the same scheduler on the same submitted requests, and
the steps' tokens agree through ``tp.argmax``; the host arrays each step
ships are folded into a running CRC (``serve_stats()["step_fingerprint"]``),
which a caller compares across ranks after a run. Windows under ``tp``
run their rounds eagerly with the same tokens: a gloo collective cannot
be captured in a CUDA graph, so no ``WindowGraph`` is built.
"""

from __future__ import annotations

import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.inference.config import canonical_attn_impl
from deepspeed_tpu_torch.inference.decode import (
    WindowGraph,
    build_paged_decode_step,
    build_paged_prefill,
    build_paged_verify_step,
    build_ragged_multistep,
    build_ragged_step,
)
from deepspeed_tpu_torch.inference.journal import JournaledRequest, RequestJournal
from deepspeed_tpu_torch.inference.kv_pool import PagePool
from deepspeed_tpu_torch.inference.spec_decode import Drafter, NGramDrafter
from deepspeed_tpu_torch.models.config import TransformerConfig
from deepspeed_tpu_torch.profiling.tracer import NULL_TRACER, MetricsRegistry, percentile_summary
from deepspeed_tpu_torch.utils import chaos
from deepspeed_tpu_torch.utils.logging import logger


def _knob(block, name, default):
    """A knob off a config object, a plain dict, or None."""
    if block is None:
        return default
    if isinstance(block, dict):
        return block.get(name, default)
    return getattr(block, name, default)


def _default_buckets(max_slots: int) -> List[int]:
    """Powers of two up to and including max_slots."""
    buckets, b = [], 1
    while b < max_slots:
        buckets.append(b)
        b *= 2
    buckets.append(max_slots)
    return sorted(set(buckets))


class SchedulingPolicy:
    """Admission-order / preemption-victim policy for ``PagedServer``:
    FIFO admission and youngest-first recompute preemption by default."""

    def next_admission(self, queue: Sequence["Request"], server: "PagedServer") -> Optional["Request"]:
        return queue[0] if queue else None

    def preemption_victim(self, candidates: Sequence["Request"], server: "PagedServer",
                          for_req: Optional["Request"] = None) -> "Request":
        return candidates[-1]  # latest admission

    def on_admit(self, req: "Request", server: "PagedServer") -> None:
        pass

    def on_emit(self, req: "Request", server: "PagedServer") -> None:
        pass

    def on_finish(self, req: "Request", server: "PagedServer") -> None:
        pass


class YoungestFirstPolicy(SchedulingPolicy):
    """The default policy, by its name."""


@dataclass
class Request:
    """One generation request moving through the scheduler."""

    uid: int
    prompt: np.ndarray  # [Lp] int32, immutable
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    tenant: str = "default"
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    consumed: int = 0  # prefill progress over context()
    pending: Optional[int] = None  # sampled but not yet written token
    done: bool = False
    admissions: int = 0  # > 1 means the request was preempted and resumed
    prefix_cached: int = 0  # context tokens attached from the prefix index
    spec_drafted: int = 0  # draft tokens this request sent to verification
    spec_accepted: int = 0  # of those, accepted
    t_submit: float = 0.0  # server-clock stamps for TTFT / TPOT
    t_first: Optional[float] = None
    t_finish: Optional[float] = None
    _ctx_buf: Optional[np.ndarray] = field(default=None, repr=False)
    _ctx_len: int = field(default=0, repr=False)

    def context(self) -> np.ndarray:
        """The prompt plus everything emitted (what a re-admission
        recomputes), as a read-only view of a capacity-doubling buffer."""
        n = self.prompt.size + len(self.generated)
        buf = self._ctx_buf
        if buf is None or buf.size < n:
            grown = np.empty(max(16, 2 * n), np.int32)
            grown[: self.prompt.size] = self.prompt
            grown[self.prompt.size : n] = self.generated
            self._ctx_buf = buf = grown
        elif self._ctx_len < n:
            buf[self._ctx_len : n] = self.generated[self._ctx_len - self.prompt.size :]
        self._ctx_len = n
        view = buf[:n]
        view.flags.writeable = False
        return view

    def output(self) -> np.ndarray:
        return self.context().copy()


class PagedServer:
    """Owns the page pool and the admit → ragged step loop, or, with
    ``ragged=False``, the admit → prefill chunks → bucketed decode loop."""

    def __init__(
        self,
        cfg: TransformerConfig,
        params,
        page_size: int = 16,
        num_pages: int = 0,
        max_slots: int = 8,
        slot_buckets: Optional[Sequence[int]] = None,
        max_seq_len: int = 0,
        prefill_chunk: int = 32,
        attn_impl: str = "auto",
        dtype=None,
        device=None,
        prefix_cache: bool = False,
        policy: Optional[SchedulingPolicy] = None,
        metrics: Optional[MetricsRegistry] = None,
        ragged: bool = True,
        multi_step=None,
        spec_decode=None,
        drafter: Optional[Drafter] = None,
        journal: Optional[RequestJournal] = None,
        clock=None,
        tp=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        # tensor-parallel serving (inference/tp.py:TPServing): this rank's shard of the weights, pools of
        # its kv heads, every host structure whole (JAX scheduler.py:246-283)
        self.tp = tp
        if tp is not None:
            if "moe" in params.get("layers", {}) and tp.degree > 1:
                raise NotImplementedError(
                    "tensor-parallel MoE serving is not supported: expert "
                    "placement is the 'expert' mesh axis, not a TP weight split"
                )
            if not ragged:
                raise ValueError(
                    "tensor-parallel serving runs the ragged path: enable "
                    "paged_kv.ragged (the bucketed oracle is single-rank)"
                )
            params = tp.shard_params(cfg, params)
        self.params = params
        self._fingerprint = 0  # CRC-32 of every step's host arrays, in order
        self._fingerprint_steps = 0
        self.tracer = NULL_TRACER  # span names mirror the JAX server's; recording is not ported yet
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.prefill_chunk = int(prefill_chunk)
        self.attn_impl = canonical_attn_impl(attn_impl)
        self.prefix_cache = bool(prefix_cache)
        self.policy = policy or YoungestFirstPolicy()
        self.ragged = bool(ragged)
        # multi-step windows (paged_kv.multi_step, a MultiStepConfig or a dict)
        self.ms_enable = bool(_knob(multi_step, "enable", False))
        self.ms_horizon = int(_knob(multi_step, "horizon", 8))
        if self.ms_enable and not self.ragged:
            raise ValueError("multi_step windows run over the ragged serving path: enable paged_kv.ragged "
                             "(or disable paged_kv.multi_step)")
        if self.ms_enable and self.ms_horizon < 2:
            raise ValueError(f"multi_step.horizon must be >= 2 (1 is the single-step path), got {self.ms_horizon}")
        # drafts a window probe proposed, handed to the single step it fell back to
        self._predrafts: Optional[Dict[int, np.ndarray]] = None
        self.journal = journal
        # TTFT/TPOT stamps and the load harness's virtual time both read this clock
        self.clock = clock or time.perf_counter
        # speculation: a SpecDecodeConfig or a dict of knobs, or an explicit Drafter (either enables it)
        self.max_draft = int(_knob(spec_decode, "max_draft", 4))
        lens = [int(n) for n in (_knob(spec_decode, "spec_lens", None) or [])]
        self.spec_lens = sorted(set(lens)) or [self.max_draft]
        if drafter is None and _knob(spec_decode, "enable", False):
            drafter = NGramDrafter(ngram_order=int(_knob(spec_decode, "ngram_order", 3)))
        self.drafter = drafter
        if self.drafter is not None and (self.max_draft < 1 or any(n < 1 for n in self.spec_lens)):
            raise ValueError(f"speculation needs max_draft >= 1 and spec_lens >= 1, got "
                             f"max_draft={self.max_draft} spec_lens={self.spec_lens}")
        if self.drafter is not None and self.attn_impl != "plain":
            # decode rows and verify rows score through different attention calls on a card (K4 at
            # width 1 and at width draft_cap + 1; bucketed, K5 rounds and plain verify passes), so an
            # argmax near-tie could resolve differently in the two
            logger.warning(f"speculative serving with attn_impl={self.attn_impl!r}: greedy streams are exact "
                           "per attention path; pin attn_impl='plain' for a strict byte-identical guarantee "
                           "against speculation-off serving")
        # drafts are clamped to the widest verify (bucketed) or the decode-row width (ragged)
        self._draft_cap = min(self.max_draft, self.spec_lens[-1])
        # the two ragged widths: decode and verify rows need 1 + draft_cap slots, prefill chunks
        # the chunk; a step takes the narrow one unless it carries a chunk row
        self._ragged_w_decode = (self._draft_cap + 1) if self.drafter is not None else 1
        self._ragged_w_mixed = max(self.prefill_chunk, self._ragged_w_decode)
        max_seq = int(max_seq_len or cfg.max_seq_len)
        if num_pages <= 0:
            # worst-case sizing: every slot at max length, plus the trash
            # page — no preemption can ever trigger
            num_pages = max_slots * (-(-max_seq // page_size)) + 1
        self.pool = PagePool(cfg if tp is None else tp.local_cfg(cfg), num_pages, page_size, max_slots,
                             max_seq_len=max_seq, dtype=dtype, device=self.device)
        buckets = sorted(set(int(b) for b in (slot_buckets or _default_buckets(max_slots))))
        if buckets[-1] < max_slots:
            buckets.append(max_slots)
        if any(b < 1 for b in buckets):
            raise ValueError(f"slot buckets must be >= 1, got {buckets}")
        self.buckets = buckets
        self._steps: Dict = {}  # ragged step callables by window width
        self._window = None  # the window callable, built at the first window (a WindowGraph on a card)
        if not self.ragged:
            self._prefill_fn = build_paged_prefill(cfg, attn_impl=self.attn_impl)
            self._decode_fn = build_paged_decode_step(cfg, attn_impl=self.attn_impl)
            self._verify_fns: Dict = {}  # bucketed verify callables by draft width K
        self._queue: deque[Request] = deque()
        self._active: List[Request] = []  # admission order (oldest first)
        self._results: Dict[int, np.ndarray] = {}
        self._next_uid = 0
        self._tenant_stats: Dict[str, Dict] = {}
        # (tenant, ttft_ms, tpot_ms or None, n_tokens) a finished request: the load harness's goodput input
        self._finished_log: deque = deque(maxlen=65536)
        # migrated-out records since the last full compaction (the journal's garbage counter)
        self._migrated_since_compact = 0
        # requests that migrated to a journal-less replica: this journal keeps their only durable claim
        # (the state at the move) until the fleet reports them finished
        self._foreign_claims: Dict[int, JournaledRequest] = {}
        self.stats = {
            "admitted": 0,
            "preempted": 0,
            "finished": 0,
            "recovered": 0,  # live requests rebuilt from the journal
            "migrated_out": 0,  # live requests extracted for a fleet migration
            "migrated_in": 0,  # live requests adopted from another replica
            "journal_compactions": 0,  # full-state rewrites of the journal
            "prefix_cached_tokens": 0,  # context tokens attached, not prefilled
            "prefill_chunks": 0,
            "ragged_steps": 0,  # single-step calls (ragged mode)
            "window_steps": 0,  # multi-step windows, one call (one graph replay on a card) each
            "window_captures": 0,  # CUDA graphs captured for windows (0 on the CPU)
            # every step call: ragged steps, windows, bucketed prefill chunks and decode rounds
            "dispatches": 0,
            "emitted_tokens": 0,
            # why a window did not form (admission waiting, a row mid prefill, page-pool pressure) or
            # ended before its horizon (EOS, token budget), or a row drafted; "pool" and "budget" call
            # for opposite remedies (grow the pool, shorten the horizon)
            "window_break_reasons": {"admission": 0, "prefill": 0, "draft": 0, "eos": 0, "budget": 0, "pool": 0},
            # ragged: steps that carried plain-decode rows; bucketed: decode rounds
            "decode_steps": 0,
            # ragged: steps that carried verify rows; bucketed: verify rounds
            "spec_rounds": 0,
            "spec_drafted": 0,  # draft tokens sent to verification
            "spec_accepted": 0,  # of those, accepted
            # spec_accept_hist[n]: (request, round) pairs whose accepted prefix was n drafts long
            "spec_accept_hist": [0] * (self._draft_cap + 1),
        }

    # --- request intake -------------------------------------------------
    def _tenant(self, name: str) -> Dict:
        ts = self._tenant_stats.get(name)
        if ts is None:
            ts = self._tenant_stats[name] = {
                "submitted": 0, "finished": 0, "tokens": 0,
                "ttft_ms": deque(maxlen=4096), "tpot_ms": deque(maxlen=4096),
            }
        return ts

    def queued_count(self, tenant: Optional[str] = None) -> int:
        if tenant is None:
            return len(self._queue)
        return sum(1 for r in self._queue if r.tenant == tenant)

    def live_count(self, tenant: Optional[str] = None) -> int:
        if tenant is None:
            return len(self._active)
        return sum(1 for r in self._active if r.tenant == tenant)

    def submit(self, prompt, max_new_tokens: int = 32, eos_token_id: Optional[int] = None,
               tenant: str = "default") -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = prompt.size + int(max_new_tokens)
        if total > self.pool.max_seq_len:
            raise ValueError(
                f"prompt {prompt.size} + max_new_tokens {max_new_tokens} exceeds "
                f"the serving max_seq_len {self.pool.max_seq_len}"
            )
        if self.pool.pages_for(total) > self.pool.num_pages - 1:
            raise ValueError(
                f"request needs {self.pool.pages_for(total)} pages but the pool "
                f"holds {self.pool.num_pages - 1} allocatable"
            )
        uid = self._next_uid
        self._next_uid += 1
        now = self.clock()
        self._queue.append(Request(uid=uid, prompt=prompt, max_new_tokens=int(max_new_tokens),
                                   eos_token_id=eos_token_id, tenant=tenant, t_submit=now))
        self._tenant(tenant)["submitted"] += 1
        self.tracer.begin_async("request", uid, f"req{uid}", tenant=tenant)
        if self.journal is not None:
            self.journal.append_submit(uid, prompt, int(max_new_tokens), eos_token_id, tenant, t_submit=now)
            # durable at submit, not at the next step: an accepted request must survive a crash
            self.journal.sync()
        return uid

    def recover(self, states: Dict[int, JournaledRequest], next_uid: int = 0, migrated_in: bool = False) -> int:
        """Rebuild the server from replayed journal state (a restart after a
        crash). Finished requests go straight to the results; every live one
        is re-queued with its journaled tokens pre-seeded, so its
        re-admission prefills ``prompt + generated`` on the cold chunk grid
        and the stream resumes byte-identically from its last emitted token
        (with prefix caching, shared prompts re-prefill almost free). Every
        replayed request is journaled again into this writer's fresh segment
        (live ones as seeded submits, finished ones as submit and finish),
        which alone replays to the same state, so the older segments are
        retired: the journal stays bounded across crash and recover cycles.
        Returns the number of live requests recovered.

        ``migrated_in=True`` is the live fleet's form (this server is a
        migration or re-route target): the requests keep their
        ``t_submit`` and ``t_first`` stamps (the fleet shares one clock, and
        a reset would drop the queue wait before the move from TTFT), the
        tenant ``submitted`` counter is not raised (the source counted the
        request), and the requests count under ``migrated_in``, not
        ``recovered``."""
        recovered = 0
        for uid in sorted(states):
            st = states[uid]
            if st.done:
                self._results[uid] = np.concatenate([np.asarray(st.prompt, np.int32),
                                                     np.asarray(st.generated, np.int32)])
                if self.journal is not None:
                    self.journal.append_submit(uid, st.prompt, st.max_new_tokens, st.eos_token_id, st.tenant,
                                               generated=st.generated)
                    self.journal.append_finish(uid)
                continue
            # a fresh process restarts the clock, so its stamps are this server's; a migration keeps them
            keep = migrated_in and st.t_submit is not None
            req = Request(uid=uid, prompt=np.asarray(st.prompt, np.int32), max_new_tokens=int(st.max_new_tokens),
                          eos_token_id=st.eos_token_id, tenant=st.tenant, generated=[int(t) for t in st.generated],
                          t_submit=st.t_submit if keep else self.clock(),
                          t_first=st.t_first if migrated_in else None)
            self._queue.append(req)
            self.tracer.begin_async("request", uid, f"req{uid}", tenant=st.tenant)
            if not migrated_in:
                self._tenant(st.tenant)["submitted"] += 1
            if self.journal is not None:
                # the Request's own stamps: they are in this server's clock domain either way
                self.journal.append_submit(uid, st.prompt, st.max_new_tokens, st.eos_token_id, st.tenant,
                                           generated=st.generated, t_submit=req.t_submit, t_first=req.t_first)
            recovered += 1
        self._next_uid = max(self._next_uid, int(next_uid))
        self.stats["migrated_in" if migrated_in else "recovered"] += recovered
        if self.journal is not None:
            # the compaction is durable before the superseded segments go
            self.journal.sync()
            self.journal.retire_older_segments()
        return recovered

    def extract_request(self, uid: int) -> Optional[JournaledRequest]:
        """Take a live or queued request off this server and return its
        replay state: the source half of a fleet migration. The target
        re-admits it through ``recover(..., migrated_in=True)`` and
        re-prefills ``prompt + generated`` on the cold chunk grid, so the
        stream continues byte-identically. Nothing is journaled here: the
        hand-off (``finalize_migration``) comes after the target has seeded
        the request durably, so no instant leaves it in neither journal.
        None when the uid is not live here."""
        req = next((r for r in self._active if r.uid == uid), None)
        if req is not None:
            self.pool.free_slot(req.slot)
            req.slot = None
            req.pending = None
            req.consumed = 0
            self._active.remove(req)
        else:
            req = next((r for r in self._queue if r.uid == uid), None)
            if req is None:
                return None
            self._queue.remove(req)
        if self.drafter is not None:
            self.drafter.drop(uid)
        self.stats["migrated_out"] += 1
        self.tracer.end_async("request", uid, f"req{uid}", migrated=True, tokens=len(req.generated))
        return JournaledRequest(uid=req.uid, prompt=np.asarray(req.prompt, np.int32),
                                max_new_tokens=int(req.max_new_tokens), eos_token_id=req.eos_token_id,
                                tenant=req.tenant, generated=[int(t) for t in req.generated],
                                t_submit=req.t_submit, t_first=req.t_first)

    def restore_request(self, state: JournaledRequest) -> None:
        """Undo ``extract_request`` for a migration that found no target:
        re-queue the state here, stamps kept, and take back the migration
        counts (nothing moved)."""
        self.recover({state.uid: state}, 0, migrated_in=True)
        self.stats["migrated_out"] -= 1
        self.stats["migrated_in"] -= 1

    def retain_migrated_claim(self, uid: int, state: JournaledRequest) -> None:
        """The request migrated to a journal-less replica, which can never
        claim it durably: this journal keeps the claim (its state at the
        move) through every compaction until ``release_migrated_claim``.
        Tokens the target emits after the move are durable nowhere, which is
        what running a replica without a journal means."""
        if self.journal is None:
            return
        self._foreign_claims[uid] = state

    def release_migrated_claim(self, uid: int) -> None:
        """The migrated request finished and its output was delivered:
        disclaim it, so a later replay cannot bring it back."""
        if self._foreign_claims.pop(uid, None) is None:
            return
        if self.journal is not None:
            self.journal.append_migrate(uid)
            self.journal.sync()
            self._migrated_since_compact += 1
            self._maybe_compact_migrated()

    def _maybe_compact_migrated(self) -> None:
        """Compact once migrated-out records outnumber the live state worth
        rewriting (both disclaim paths share it), so the journal stays
        bounded however requests leave."""
        if self._migrated_since_compact > len(self._queue) + len(self._active):
            self.compact_journal()

    def finalize_migration(self, uid: int) -> None:
        """The source's journal hand-off once a migration landed on the
        target: the migrated-out record, durable at once (a later replay
        must not bring the request back), then a compaction only when
        migrated-out records outweigh the live state. A drain of N requests
        so costs O(N) journal writes in all."""
        if self.journal is None:
            return
        self.journal.append_migrate(uid)
        self.journal.sync()
        self._migrated_since_compact += 1
        self._maybe_compact_migrated()

    def compact_journal(self) -> int:
        """Journal this server's full current state into a fresh segment and
        retire every older one (``journal.begin_compaction``): claims kept
        for requests on journal-less replicas, queued and live requests as
        seeded submits, unclaimed results as submit and finish records of
        the output array (the replayed result is that array verbatim). The
        live-server form of ``recover``'s compaction. Returns the number of
        segments retired."""
        if self.journal is None:
            return 0
        self._migrated_since_compact = 0
        self.stats["journal_compactions"] += 1
        self.journal.begin_compaction()
        for st in self._foreign_claims.values():
            self.journal.append_submit(st.uid, st.prompt, st.max_new_tokens, st.eos_token_id, st.tenant,
                                       generated=st.generated, t_submit=st.t_submit, t_first=st.t_first)
        for req in list(self._queue) + list(self._active):
            self.journal.append_submit(req.uid, req.prompt, req.max_new_tokens, req.eos_token_id, req.tenant,
                                       generated=req.generated, t_submit=req.t_submit, t_first=req.t_first)
        for uid, out in self._results.items():
            self.journal.append_submit(uid, out, 1, None, "default")
            self.journal.append_finish(uid)
        self.journal.sync()
        return self.journal.retire_older_segments()

    def has_work(self) -> bool:
        return bool(self._queue or self._active)

    def prefilling(self) -> bool:
        """A request waits for admission or a running row is mid prefill
        (False once every row decodes: the steady state where windows form)."""
        return bool(self._queue) or any(r.pending is None for r in self._active)

    def result(self, uid: int) -> Optional[np.ndarray]:
        """A finished output, left in place (``take_result`` removes it)."""
        return self._results.get(uid)

    def take_result(self, uid: int) -> Optional[np.ndarray]:
        """Pop a finished output (a long-lived server keeps none)."""
        return self._results.pop(uid, None)

    # --- one scheduler iteration ---------------------------------------
    def step(self) -> None:
        """Admit what fits, then the round's device work: in ragged mode ONE
        step covering every active row's next tokens (prefill chunks,
        decode rows and verify rows together), or, with ``multi_step`` armed
        and the running set stable, ONE window of ``horizon`` decode rounds;
        in bucketed mode one prefill call per chunk, then one decode or
        verify round over the running set. Then the chaos point
        ``serve.mid_step`` (a kill there loses only tokens that recovery
        re-derives) and one ``journal.sync()``."""
        with self.tracer.span("serve.step"):
            with self.tracer.span("serve.admit"):
                self._admit()
            if self.ragged:
                if not (self.ms_enable and self._ragged_window()):
                    self._ragged_step(drafts=self._take_predrafts())
            else:
                with self.tracer.span("serve.prefill"):
                    self._prefill_step()
                with self.tracer.span("serve.decode"):
                    self._decode_step()
            chaos.point("serve.mid_step")
            if self.journal is not None:
                with self.tracer.span("serve.journal_sync"):
                    self.journal.sync()
        self.metrics.counter("serve.steps").inc()

    def run(self) -> Dict[int, np.ndarray]:
        while self.has_work():
            self.step()
        return self._results

    def serve(self, prompts: Sequence, max_new_tokens=32, eos_token_id: Optional[int] = None,
              tenant: str = "default") -> List[np.ndarray]:
        """Submit a batch (scalar or per-request ``max_new_tokens``), run to
        completion, return outputs in submission order."""
        if isinstance(max_new_tokens, (int, np.integer)):
            max_new_tokens = [max_new_tokens] * len(prompts)
        if len(max_new_tokens) != len(prompts):
            raise ValueError(f"{len(prompts)} prompts but {len(max_new_tokens)} max_new_tokens")
        uids = [
            self.submit(p, max_new_tokens=int(n), eos_token_id=eos_token_id, tenant=tenant)
            for p, n in zip(prompts, max_new_tokens)
        ]
        self.run()
        return [self.take_result(u) for u in uids]

    # --- phases ---------------------------------------------------------
    def _admit(self) -> None:
        while self._queue:
            req = self.policy.next_admission(self._queue, self)
            if req is None:
                break
            ctx = req.context()
            # reserve the whole context plus the first decode write; with
            # prefix caching the pool first attaches the longest indexed
            # prefix (capped at ctx.size - 1 tokens)
            slot = self.pool.alloc_slot(ctx.size + 1, prefix_tokens=ctx if self.prefix_cache else None)
            if slot is None:
                break
            if self._queue[0] is req:
                self._queue.popleft()
            else:
                self._queue.remove(req)
            req.slot = slot
            cached = int(self.pool.seq_lens[slot])
            req.consumed = cached
            req.prefix_cached = cached
            self.stats["prefix_cached_tokens"] += cached
            req.pending = None
            req.admissions += 1
            self._active.append(req)
            self.stats["admitted"] += 1
            self.tracer.instant_async("request", req.uid, "admit", slot=slot, prefix_cached=cached)
            self.policy.on_admit(req, self)

    def _next_chunk_len(self, req: "Request", ctx_size: int) -> int:
        """Tokens the request's next prefill chunk covers; a prefix attach
        that landed mid chunk-grid realigns to the cold-prefill chunk
        boundaries, so every position is computed by the same geometry."""
        C = self.prefill_chunk
        start = req.consumed
        real = min(C, ctx_size - start)
        if start % C:
            real = min(real, C - start % C)
        return real

    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """One host->device copy of several small int32 arrays, returned as
        contiguous views of one device buffer; the arrays also extend the
        step fingerprint."""
        flat = np.concatenate([np.ascontiguousarray(a, np.int32).ravel() for a in arrays])
        self._fingerprint = zlib.crc32(flat.tobytes(), self._fingerprint)
        self._fingerprint_steps += 1
        dev = torch.from_numpy(flat).to(self.device, non_blocking=True)
        out, i = [], 0
        for a in arrays:
            out.append(dev[i : i + a.size].view(a.shape))
            i += a.size
        return out

    def _step_fn(self, W: int):
        fn = self._steps.get(W)
        if fn is None:
            fn = self._steps[W] = build_ragged_step(self.cfg, W, attn_impl=self.attn_impl, tp=self.tp)
        return fn

    # --- the bucketed rounds ----------------------------------------------
    def _prefill_step(self) -> None:
        """One prefill call for each prefilling row's next chunk; a row
        whose prompt completes emits its first token (the chunk's one host
        fetch)."""
        C = self.prefill_chunk
        for req in [r for r in self._active if r.pending is None and not r.done]:
            ctx = req.context()
            start = req.consumed
            real = self._next_chunk_len(req, ctx.size)
            if not self.pool.prepare_write(req.slot, start + real):
                # unreachable: admission reserved the whole context and
                # prefill never writes into attached (shared) pages
                raise RuntimeError(f"prefill write barrier failed for slot {req.slot} ({start}..{start + real})")
            chunk = np.zeros((1, C), np.int32)
            chunk[0, :real] = ctx[start : start + real]
            pt, _ = self.pool.rows([req.slot])
            d_chunk, d_table, d_start = self._to_device(chunk, pt, np.asarray([start], np.int32))
            tok = self._prefill_fn(self.params, d_chunk, self.pool.cache.k_pages, self.pool.cache.v_pages,
                                   d_table, d_start, real - 1)
            self.stats["dispatches"] += 1
            self.pool.advance(req.slot, real)
            req.consumed = start + real
            if self.prefix_cache:
                self.pool.register_prefix(req.slot, ctx, req.consumed)
            self.stats["prefill_chunks"] += 1
            if req.consumed == ctx.size:
                self._emit(req, int(tok[0]))

    def _decode_step(self) -> None:
        running = [r for r in self._active if r.pending is not None and not r.done]
        if not running:
            return
        if self.drafter is not None:
            drafts = self._propose_drafts(running)
            if any(d.size for d in drafts.values()):
                self._verify_round(running, drafts)
                return
            # nothing drafted anywhere: the plain one-token round
        self._plain_decode_step(running)

    def _plain_decode_step(self, running: List[Request]) -> None:
        """One decode round: every running row's pending token, padded to
        the smallest slot bucket; the round's one host fetch is the
        ``[bucket]`` next tokens."""
        running = self._reserve_for_growth(running, {})
        if not running:
            return
        bucket, page_table, lengths = self._dispatch_rows(running)
        tokens = np.zeros(bucket, np.int32)
        tokens[: len(running)] = [r.pending for r in running]
        d_tokens, d_table, d_lengths = self._to_device(tokens, page_table, lengths)
        out = self._decode_fn(self.params, d_tokens, self.pool.cache.k_pages, self.pool.cache.v_pages,
                              d_table, d_lengths)
        self.stats["decode_steps"] += 1
        self.stats["dispatches"] += 1
        out = out.cpu().numpy()
        for i, req in enumerate(running):
            self.pool.advance(req.slot, 1)
            self._emit(req, int(out[i]))
            if self.prefix_cache and not req.done:
                # publish any page this write just filled
                self.pool.register_prefix(req.slot, req.context(), int(self.pool.seq_lens[req.slot]))

    # --- the ragged one-call step -----------------------------------------
    def _take_predrafts(self) -> Optional[Dict[int, np.ndarray]]:
        """Drafts a failed window probe already proposed this step (the
        drafter is asked at most once a step: it may keep state)."""
        drafts, self._predrafts = self._predrafts, None
        return drafts

    def _ragged_step(self, drafts: Optional[Dict[int, np.ndarray]] = None) -> None:
        """ONE step for the whole round: every active row contributes a
        prefill chunk, its pending decode token, or its pending token and
        its drafts (``drafts``: a window probe's, else asked here)."""
        rows = [r for r in self._active if not r.done]
        if not rows:
            return
        with self.tracer.span("serve.pack") as pack_span:
            if drafts is None:
                drafts = {}
                if self.drafter is not None:
                    drafts = self._propose_drafts([r for r in rows if r.pending is not None])
            chunk_len: Dict[int, int] = {}
            need: Dict[int, int] = {}
            for r in rows:
                if r.pending is None:
                    chunk_len[r.uid] = need[r.uid] = self._next_chunk_len(r, r.context().size)
                else:
                    d = drafts.get(r.uid)
                    if d is None:
                        d = drafts[r.uid] = np.zeros(0, np.int32)
                    need[r.uid] = d.size + 1
            rows = self._reserve_for_growth(rows, need)
            if not rows:
                return
            # the two widths: 1 + draft_cap for decode and verify steps, the chunk's when a row prefills
            W = self._ragged_w_mixed if any(r.pending is None for r in rows) else self._ragged_w_decode
            # pad to the fixed row budget; lengths == consumed for prefill rows
            R, page_table, lengths = self._dispatch_rows(rows, pad_to=self.pool.max_slots)
            tokens = np.zeros((R, W), np.int32)
            q_lens = np.zeros(R, np.int32)
            for i, r in enumerate(rows):
                if r.pending is None:
                    real = chunk_len[r.uid]
                    tokens[i, :real] = r.context()[r.consumed : r.consumed + real]
                    q_lens[i] = real
                else:
                    d = drafts[r.uid]
                    tokens[i, 0] = r.pending
                    tokens[i, 1 : 1 + d.size] = d
                    q_lens[i] = 1 + d.size
            pack_span.set(rows=len(rows), width=W)
        with self.tracer.span("serve.dispatch", rows=len(rows), width=W):
            d_tokens, d_table, d_lengths, d_qlens = self._to_device(tokens, page_table, lengths, q_lens)
            out = self._step_fn(W)(
                self.params, d_tokens, self.pool.cache.k_pages, self.pool.cache.v_pages,
                d_table, d_lengths, d_qlens,
            )
        self.stats["ragged_steps"] += 1
        self.stats["dispatches"] += 1
        with self.tracer.span("serve.emit"):
            self._settle_ragged_rows(rows, out, chunk_len, q_lens)

    def _settle_ragged_rows(self, rows, out, chunk_len, q_lens) -> None:
        """The step's single host fetch, then per-row advance/emit/publish."""
        out = out.cpu().numpy()  # [R, W+1]: accepted counts + greedy tokens
        had_decode = had_spec = False
        for i, r in enumerate(rows):
            if r.pending is None:
                real = chunk_len[r.uid]
                ctx = r.context()
                self.pool.advance(r.slot, real)
                r.consumed += real
                self.stats["prefill_chunks"] += 1
                if self.prefix_cache:
                    self.pool.register_prefix(r.slot, ctx, r.consumed)
                if r.consumed == ctx.size:
                    # the first generated token: greedy after the chunk's last real position
                    self._emit(r, int(out[i, real]))
                continue
            d = int(q_lens[i]) - 1
            if d:
                had_spec = True
            else:
                had_decode = True
            self._settle_spec_row(r, d, int(out[i, 0]), out[i])
        if had_decode:
            self.stats["decode_steps"] += 1
        if had_spec:
            self.stats["spec_rounds"] += 1

    # --- the multi-step window (one call = N decode rounds) ----------------
    def _window_break(self, reason: str) -> None:
        self.stats["window_break_reasons"][reason] += 1

    def _window_fn(self):
        """The window over ``max_slots`` rows and ``ms_horizon`` rounds (every
        window has that shape), built at the first window: a CUDA graph on a
        card, the eager rounds on the CPU and under tensor parallelism (the
        collectives cannot be captured)."""
        if self._window is None:
            rows = self.pool.max_slots
            window = build_ragged_multistep(self.cfg, rows, 1, self.ms_horizon, attn_impl=self.attn_impl,
                                            tp=self.tp)
            if self.device.type == "cuda" and not self._tp_active():
                self._window = WindowGraph(window, self.params, self.pool.cache.k_pages, self.pool.cache.v_pages,
                                           rows, self.pool.max_pages_per_slot)
            else:
                def eager(tokens, page_table, lengths, live, eos_ids, budgets):
                    args = self._to_device(tokens, page_table, lengths, live, eos_ids, budgets)
                    return window(self.params, args[0], self.pool.cache.k_pages, self.pool.cache.v_pages,
                                  *args[1:]).cpu().numpy()
                self._window = eager
        return self._window

    def _ragged_window(self) -> bool:
        """Serve this step as ONE window of ``ms_horizon`` plain-decode
        rounds, if the running set is stable: nothing queued, no row mid
        prefill, some row with a budget of at least a horizon left, and
        every row's pages for the whole window reservable WITHOUT
        preemption. Otherwise record the break reason and return False: the
        caller takes the single-step path, whose streams are byte-identical
        (the window freezes rows in the program exactly where single steps
        would retire them). With a drafter the probe asks it once: any row
        with drafts breaks the window ("draft"), and the drafts go to the
        single step (``_take_predrafts``). Each row's EOS id and token
        budget ride in as arrays. After the window settles, the chaos point
        ``serve.mid_window``: its tokens are in the journal's buffer, none
        durable."""
        rows = [r for r in self._active if not r.done]
        if not rows:
            return False
        if self._queue:
            # an admission is waiting: a window would hold its TTFT back for
            # up to N rounds, so serve single steps until the queue drains
            self._window_break("admission")
            return False
        if any(r.pending is None for r in rows):
            self._window_break("prefill")
            return False
        H = self.ms_horizon
        if max(r.max_new_tokens - len(r.generated) for r in rows) < H:
            # every row would freeze before the horizon: single steps are cheaper
            self._window_break("budget")
            return False
        if self.drafter is not None:
            # stash the proposals whichever way the probe goes: the single step takes them rather
            # than asking the drafter twice in one step
            self._predrafts = drafts = self._propose_drafts(rows)
            if any(d.size for d in drafts.values()):
                self._window_break("draft")
                return False
        # reserve the whole window's growth, min(H, remaining budget) a row (the in-window budget
        # freeze bounds a row's writes, so a near-finished row never asks for room past max_seq_len)
        # and WITHOUT preemption: pool pressure is a scheduling event, and the single step owns it
        need = {r.uid: min(H, r.max_new_tokens - len(r.generated)) for r in rows}
        if self._reserve_for_growth(rows, need, preempt=False) is None:
            self._window_break("pool")
            return False
        # the window runs: drop the (all-empty) stash, so a later step asks the drafter afresh
        self._predrafts = None
        with self.tracer.span("serve.window", rows=len(rows), horizon=H):
            with self.tracer.span("serve.pack") as pack_span:
                R, page_table, lengths = self._dispatch_rows(rows, pad_to=self.pool.max_slots)
                tokens = np.zeros(R, np.int32)
                live = np.zeros(R, np.int32)
                eos_ids = np.full(R, -1, np.int32)
                budgets = np.zeros(R, np.int32)
                for i, r in enumerate(rows):
                    tokens[i] = r.pending
                    live[i] = 1
                    if r.eos_token_id is not None:
                        eos_ids[i] = r.eos_token_id
                    budgets[i] = r.max_new_tokens - len(r.generated)  # >= 1
                pack_span.set(rows=len(rows), horizon=H)
            with self.tracer.span("serve.dispatch", rows=len(rows), width=1, horizon=H):
                fn = self._window_fn()
                captures = isinstance(fn, WindowGraph) and fn.graph is None
                out = fn(tokens, page_table, lengths, live, eos_ids, budgets)
            self.stats["window_steps"] += 1
            self.stats["window_captures"] += int(captures)
            self.stats["dispatches"] += 1
            with self.tracer.span("serve.emit"):
                self._settle_window_rows(rows, out, H)
            # a kill inside the window's host phase: the window's tokens are buffered, none durable;
            # recovery re-derives them by the greedy re-prefill
            chaos.point("serve.mid_window")
        return True

    def _settle_window_rows(self, rows, out, horizon: int) -> None:
        """The window's one host fetch (``[R, 1+N]``: each row's emitted
        count, then its tokens), then per-row advance, emit and publish.
        Rows that froze before the horizon name the break (EOS or budget);
        pages reserved past a live row's length go back to the pool, so a
        parked reservation never starves the next admission."""
        eos_broke = budget_broke = False
        for i, r in enumerate(rows):
            n = int(out[i, 0])
            self.pool.advance(r.slot, n)
            for tok in out[i, 1 : 1 + n]:
                self._emit(r, int(tok))
            if r.done and n < horizon:
                if r.eos_token_id is not None and r.generated and r.generated[-1] == r.eos_token_id:
                    eos_broke = True
                else:
                    budget_broke = True
            if not r.done:
                if self.prefix_cache:
                    self.pool.register_prefix(r.slot, r.context(), int(self.pool.seq_lens[r.slot]))
                self.pool.trim_reservation(r.slot)
        if eos_broke:
            self._window_break("eos")
        if budget_broke:
            self._window_break("budget")

    def _reserve_for_growth(self, running: List[Request], need: Dict[int, int],
                            preempt: bool = True) -> Optional[List[Request]]:
        """Make every running row writable for its next ``need[uid]`` tokens
        (page growth plus the copy-on-write barrier), preempting the
        policy's victim when the pool is dry. Mutates and returns
        ``running`` (preempted rows leave the round).

        ``preempt=False`` is the window's mode (a whole horizon's pages a
        row, up front): on the first row the pool cannot host, every
        reservation this call made is handed back (``trim_reservation``)
        and None is returned, so the caller takes the single-step path."""
        idx = 0
        while idx < len(running):
            req = running[idx]
            grow = need.get(req.uid, 1)
            while not self.pool.prepare_write(req.slot, int(self.pool.seq_lens[req.slot]) + grow):
                if not preempt:
                    for r in running[: idx + 1]:
                        self.pool.trim_reservation(r.slot)
                    return None
                candidates = [r for r in self._active if r is not req]
                if not candidates:
                    raise RuntimeError(
                        f"page pool exhausted by a single sequence (len "
                        f"{int(self.pool.seq_lens[req.slot])}): the pool holds "
                        f"{self.pool.num_pages - 1} pages x {self.pool.page_size} tokens"
                    )
                victim = self.policy.preemption_victim(candidates, self, for_req=req)
                self._preempt(victim)
                if victim in running:
                    vi = running.index(victim)
                    running.remove(victim)
                    if vi < idx:
                        idx -= 1
            idx += 1
        return running

    def _dispatch_rows(self, running: List[Request], pad_to: Optional[int] = None):
        """(rows, page_table, lengths) padded to ``pad_to`` rows (default: the
        smallest slot bucket covering the set); padding rows are dead (-1
        tables / length 0)."""
        pad_to = pad_to or min(b for b in self.buckets if b >= len(running))
        page_table = np.full((pad_to, self.pool.max_pages_per_slot), -1, np.int32)
        lengths = np.zeros(pad_to, np.int32)
        rows_pt, rows_len = self.pool.rows([r.slot for r in running])
        n = len(running)
        page_table[:n] = rows_pt
        lengths[:n] = rows_len
        return pad_to, page_table, lengths

    def _settle_spec_row(self, req: Request, d: int, acc: int, out_row) -> None:
        """Accounting for one decode or verify row (``d`` drafts, ``acc``
        accepted, bounded by ``d`` in the step), shared by the ragged step
        and the bucketed verify round: advance all ``d + 1`` written
        positions, roll the rejected tail's pages back, count the
        speculation, emit the accepted prefix and the bonus token (stopping
        at EOS or the budget), and republish the prefix from the
        rolled-back length, so a rejected draft's page is never published."""
        self.pool.advance(req.slot, d + 1)
        self.pool.rollback(req.slot, d - acc)
        self.stats["spec_drafted"] += d
        self.stats["spec_accepted"] += acc
        req.spec_drafted += d
        req.spec_accepted += acc
        if d:
            hist = self.stats["spec_accept_hist"]
            hist[min(acc, len(hist) - 1)] += 1
        for tok in out_row[1 : acc + 2]:
            self._emit(req, int(tok))
            if req.done:
                break
        if self.prefix_cache and not req.done:
            self.pool.register_prefix(req.slot, req.context(), int(self.pool.seq_lens[req.slot]))

    # --- speculative rounds ---------------------------------------------
    def _propose_drafts(self, running: List[Request]) -> Dict[int, np.ndarray]:
        """Host-side drafting: up to ``_draft_cap`` tokens a request, clamped
        to its remaining budget less one (the bonus token needs a slot),
        which also keeps every write inside ``max_seq_len``."""
        drafts: Dict[int, np.ndarray] = {}
        for req in running:
            budget = req.max_new_tokens - len(req.generated)  # >= 1 while running
            k = min(self._draft_cap, budget - 1)
            d = np.zeros(0, np.int32)
            if k > 0:
                d = np.asarray(self.drafter.propose(req.uid, req.context(), k), np.int32).reshape(-1)[:k]
            drafts[req.uid] = d
        return drafts

    def _verify_fn(self, K: int):
        fn = self._verify_fns.get(K)
        if fn is None:
            fn = self._verify_fns[K] = build_paged_verify_step(self.cfg, K, attn_impl=self.attn_impl)
        return fn

    def _verify_round(self, running: List[Request], drafts: Dict[int, np.ndarray]) -> None:
        """One bucketed speculative round: reserve every row's drafts and
        bonus slot, ONE verify call of the smallest compiled width covering
        the longest draft, then each row's accepted prefix and bonus token;
        the rejected tails roll back. The round's one host fetch is the
        ``[bucket, K+2]`` packed result."""
        running = self._reserve_for_growth(running, {uid: d.size + 1 for uid, d in drafts.items()})
        if not running:
            return
        d_max = max(drafts[r.uid].size for r in running)
        # preemption may have evicted every drafting row: any width serves then
        K = next((n for n in self.spec_lens if n >= d_max), self.spec_lens[-1])
        bucket, page_table, lengths = self._dispatch_rows(running)
        tokens = np.zeros((bucket, K + 1), np.int32)
        draft_lens = np.zeros(bucket, np.int32)
        for i, req in enumerate(running):
            d = drafts[req.uid]
            tokens[i, 0] = req.pending
            tokens[i, 1 : 1 + d.size] = d
            draft_lens[i] = d.size
        d_tokens, d_table, d_lengths, d_dlens = self._to_device(tokens, page_table, lengths, draft_lens)
        out = self._verify_fn(K)(self.params, d_tokens, self.pool.cache.k_pages, self.pool.cache.v_pages,
                                 d_table, d_lengths, d_dlens)
        self.stats["spec_rounds"] += 1
        self.stats["dispatches"] += 1
        out = out.cpu().numpy()
        for i, req in enumerate(running):
            self._settle_spec_row(req, int(draft_lens[i]), int(out[i, 0]), out[i])

    # --- bookkeeping ----------------------------------------------------
    def _emit(self, req: Request, token: int) -> None:
        """Record a newly sampled token (journaled, with the first token's
        stamp) and retire the request on EOS or budget (the token is
        included)."""
        if req.t_first is None:
            req.t_first = self.clock()
            self.tracer.instant_async("request", req.uid, "first_token")
            if self.journal is not None:
                self.journal.append_first_token(req.uid, req.t_first)
        req.generated.append(token)
        req.pending = token
        self.stats["emitted_tokens"] += 1
        self.metrics.counter("serve.tokens").inc()
        if self.journal is not None:
            self.journal.append_emit(req.uid, token)
        self._tenant(req.tenant)["tokens"] += 1
        self.policy.on_emit(req, self)
        if (req.eos_token_id is not None and token == req.eos_token_id) or len(req.generated) >= req.max_new_tokens:
            self._finish(req)

    def _finish(self, req: Request) -> None:
        req.done = True
        req.t_finish = self.clock()
        self.pool.free_slot(req.slot)
        req.slot = None
        self._active.remove(req)
        self._results[req.uid] = req.output()
        self.stats["finished"] += 1
        ts = self._tenant(req.tenant)
        ts["finished"] += 1
        ttft_ms = (req.t_first - req.t_submit) * 1e3
        ts["ttft_ms"].append(ttft_ms)
        tpot_ms = None
        if len(req.generated) > 1:
            tpot_ms = (req.t_finish - req.t_first) * 1e3 / (len(req.generated) - 1)
            ts["tpot_ms"].append(tpot_ms)
            self.metrics.histogram("serve.tpot_ms").observe(tpot_ms)
        self._finished_log.append((req.tenant, ttft_ms, tpot_ms, len(req.generated)))
        self.metrics.histogram("serve.ttft_ms").observe(ttft_ms)
        self.tracer.end_async("request", req.uid, f"req{req.uid}", tokens=len(req.generated))
        if self.journal is not None:
            self.journal.append_finish(req.uid)
        self.policy.on_finish(req, self)
        if self.drafter is not None:
            self.drafter.drop(req.uid)

    def _preempt(self, req: Request) -> None:
        self.pool.free_slot(req.slot)
        req.slot = None
        req.pending = None
        req.consumed = 0
        self._active.remove(req)
        self._queue.appendleft(req)
        self.stats["preempted"] += 1
        self.tracer.instant_async("request", req.uid, "preempt", tokens=len(req.generated))

    def _tp_active(self) -> bool:
        return self.tp is not None and self.tp.degree > 1

    # --- observability ---------------------------------------------------
    def finished_log(self) -> List:
        """``(tenant, ttft_ms, tpot_ms or None, n_tokens)`` a finished
        request, oldest first (bounded): the load harness's goodput input."""
        return list(self._finished_log)

    def serve_stats(self) -> Dict:
        """Scheduler counters (``ragged_steps`` one per single step; the
        window block: ``window_steps``, ``window_horizon`` (0 when windows
        are off), ``window_captures``, ``window_break_reasons``,
        ``window_device_ms``: the device time of each window's graph replay,
        from CUDA events, ``{'count': 0}`` on the CPU), speculation
        (``spec_rounds``, ``spec_drafted``, ``spec_accepted``,
        ``spec_accept_hist`` and the derived ``spec_accept_rate`` and
        ``spec_mean_accepted_per_round``), pool
        occupancy and utilization, prefix-cache counters (``prefix``: hit
        rate, CoW copies, cached pages) and latency SLOs: aggregate and
        per-tenant p50/p99 TTFT (submit -> first token, queue wait
        included) and TPOT (per generated token after the first). Tensor
        parallelism: ``tp_degree``, ``tp_quantized_allreduce``,
        ``window_graph`` (whether windows replay a CUDA graph: never under
        tp), and ``step_fingerprint`` / ``fingerprint_steps`` (the CRC of
        every step's host arrays and the number of steps it covers, equal
        on every rank of a group)."""
        s = dict(self.stats)
        s["spec_accept_hist"] = list(self.stats["spec_accept_hist"])
        s["window_break_reasons"] = dict(self.stats["window_break_reasons"])
        drafted, rounds = s["spec_drafted"], s["spec_rounds"]
        s["spec_accept_rate"] = s["spec_accepted"] / drafted if drafted else 0.0
        s["spec_mean_accepted_per_round"] = s["spec_accepted"] / rounds if rounds else 0.0
        s["window_horizon"] = self.ms_horizon if self.ms_enable else 0
        s["window_device_ms"] = percentile_summary(
            self._window.device_ms if isinstance(self._window, WindowGraph) else ())
        s["dispatches_per_token"] = s["dispatches"] / s["emitted_tokens"] if s["emitted_tokens"] else 0.0
        s["tp_degree"] = self.tp.degree if self.tp is not None else 1
        s["tp_quantized_allreduce"] = bool(self.tp.quantized_allreduce) if self.tp is not None else False
        # windows under tensor parallelism replay no CUDA graph: their rounds run eagerly
        s["window_graph"] = self.ms_enable and self.device.type == "cuda" and not self._tp_active()
        s["step_fingerprint"] = f"{self._fingerprint:08x}"
        s["fingerprint_steps"] = self._fingerprint_steps
        s.update(
            live_tokens=self.pool.live_tokens(),
            used_pages=self.pool.used_pages(),
            free_pages=self.pool.free_pages(),
            live_hbm_bytes=self.pool.live_hbm_bytes(),
            pool_utilization=self.pool.utilization(),
        )
        all_ttft: List[float] = []
        all_tpot: List[float] = []
        tenants: Dict[str, Dict] = {}
        for name, ts in self._tenant_stats.items():
            all_ttft.extend(ts["ttft_ms"])
            all_tpot.extend(ts["tpot_ms"])
            tenants[name] = {
                "submitted": ts["submitted"],
                "finished": ts["finished"],
                "tokens": ts["tokens"],
                "ttft_ms": percentile_summary(ts["ttft_ms"]),
                "tpot_ms": percentile_summary(ts["tpot_ms"]),
            }
        s["ttft_ms"] = percentile_summary(all_ttft)
        s["tpot_ms"] = percentile_summary(all_tpot)
        s["tenants"] = tenants
        s["prefix"] = self.pool.prefix_stats()
        return s
