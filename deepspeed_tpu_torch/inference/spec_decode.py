"""Model-free speculative drafting for the paged serving engine.

Counterpart of ``deepspeed_tpu/inference/spec_decode.py`` (numpy only; the
port keeps its own copy). Speculative decoding splits a serving round into
host-side drafting and one device verify: a drafter proposes up to K
plausible next tokens per running request, and the verify rows (the ragged
step's ``q_len = 1 + d`` rows, or the bucketed ``build_paged_verify_step``)
score all K+1 positions at once and accept the longest prefix that equals
the model's own greedy argmax, so the stream is byte-identical to
speculation-off decoding while each accepted draft saves a whole decode
step.

* ``Drafter``: the interface the scheduler drives. State is keyed by the
  request uid; the scheduler calls ``drop`` when a request finishes.
* ``NGramDrafter``: prompt-lookup drafting, the continuation after the most
  recent earlier occurrence of the context's own suffix n-gram, with an
  incremental per-request index (O(order) host work a new token).

A draft never has to be right, only cheap: a wrong one costs one rejected
row of the verify, a missing one makes the round a plain decode.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# per n-gram key: how many most-recent occurrence starts to keep (the newest
# occurrence is usually the suffix itself, so keep a few behind it)
_OCCURRENCES_KEPT = 4


class Drafter:
    """Interface between the scheduler and a draft source.

    ``propose(uid, context, k)`` returns up to ``k`` int32 draft tokens
    continuing ``context`` (the request's prompt and everything emitted);
    returning fewer, or none, is always legal. ``drop(uid)`` releases any
    per-request state once the request finishes."""

    def propose(self, uid: int, context: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError

    def drop(self, uid: int) -> None:  # noqa: B027 - optional hook
        pass


class _NGramIndex:
    """One request's incremental n-gram index: for every order 1..N, the
    most recent start positions of each n-gram seen so far."""

    __slots__ = ("toks", "idx")

    def __init__(self, order: int):
        self.toks: List[int] = []
        self.idx: List[Dict[tuple, List[int]]] = [dict() for _ in range(order)]

    def extend(self, new_tokens) -> None:
        order = len(self.idx)
        for t in new_tokens:
            self.toks.append(int(t))
            i = len(self.toks) - 1
            for o in range(1, min(order, i + 1) + 1):
                key = tuple(self.toks[i - o + 1 : i + 1])
                starts = self.idx[o - 1].setdefault(key, [])
                starts.insert(0, i - o + 1)  # newest first
                del starts[_OCCURRENCES_KEPT:]


class NGramDrafter(Drafter):
    """Prompt-lookup drafting: propose the continuation that followed the
    most recent earlier occurrence of the context's suffix n-gram, trying
    orders ``ngram_order`` down to 1 (longer matches first)."""

    def __init__(self, ngram_order: int = 3):
        if ngram_order < 1:
            raise ValueError(f"ngram_order must be >= 1, got {ngram_order}")
        self.order = int(ngram_order)
        self._state: Dict[int, _NGramIndex] = {}

    def propose(self, uid: int, context: np.ndarray, k: int) -> np.ndarray:
        empty = np.zeros(0, np.int32)
        context = np.asarray(context, np.int32).reshape(-1)
        n = context.size
        if k < 1 or n < 2:
            return empty
        st = self._state.get(uid)
        if st is None or len(st.toks) > n:
            # a new request, or a context that shrank (the scheduler never
            # makes one: preemption keeps emitted tokens): rebuild
            st = self._state[uid] = _NGramIndex(self.order)
        st.extend(context[len(st.toks) :])
        for o in range(min(self.order, n - 1), 0, -1):
            key = tuple(int(t) for t in context[n - o :])
            for start in st.idx[o - 1].get(key, ()):
                cont = start + o
                if cont < n:  # skip the suffix's own occurrence (no future)
                    return context[cont : cont + k].copy()
        return empty

    def drop(self, uid: int) -> None:
        self._state.pop(uid, None)
