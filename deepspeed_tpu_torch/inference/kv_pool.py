"""Block-pool KV cache for paged serving, with page-level prefix sharing.

Counterpart of ``deepspeed_tpu/inference/kv_pool.py``. The cache is one
shared pool of fixed-size pages ``[L, num_pages, NKV, page_size, D]`` per K
and V plus a per-sequence page table, so device memory holds live tokens
rounded up to a page, and any free page can serve any sequence.

* ``PagedKVCache`` — the device tensors. Unlike the JAX package, where the
  pools are donated into every serving program and come back as new
  arrays, the port updates them **in place**: the serving step scatters
  each layer's new k/v into ``k_pages[l]`` with an index-put, and a
  copy-on-write is an in-place page copy.
* ``PagePool`` — the host-side allocator, a near-verbatim copy: free list,
  per-slot page tables and live lengths (numpy int32; they ride into each
  step as plain arrays), and the prefix index (chain hash per full page,
  refcounts, copy-on-write barrier, cached LRU of released prefix pages)
  and ``defrag``, which compacts live pages into the lowest ids by one
  gather a pool, written back into the pools' own storage.

Page 0 is the reserved TRASH page: it is never allocated, table sentinels
(-1) clamp onto it, and dead-slot writes land there, so a padded row can
never corrupt a live sequence's pages. Duplicate writes to page 0 within
one step are harmless only because page 0 is never read live.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models.config import TransformerConfig
from deepspeed_tpu_torch.models.transformer import DTYPES

TRASH_PAGE = 0

# root of every prefix hash chain (only equality of chain keys matters)
_ROOT_CHAIN = 0x9E3779B9


class PagedKVCache(NamedTuple):
    """Device page pool, one stacked tensor per K and V, layout
    ``[L, num_pages, NKV, page_size, D]``: each layer slice is exactly the
    ``[NP, NKV, P, D]`` pool the attention kernel takes."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def bytes_per_token(self) -> int:
        """Device bytes one cached token costs across all layers (K + V)."""
        L, _, NKV, _, D = self.k_pages.shape
        return 2 * L * NKV * D * self.k_pages.element_size()

    def hbm_bytes(self) -> int:
        return 2 * self.k_pages.numel() * self.k_pages.element_size()


def init_paged_cache(cfg: TransformerConfig, num_pages: int, page_size: int, dtype=None,
                     device=None) -> PagedKVCache:
    """Allocate the device page pools (zeros) on ``device`` (``cuda`` by
    default; raises without a card)."""
    device = resolve_device(device)
    if dtype is None:
        dtype = DTYPES[cfg.dtype]
    shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page_size, cfg.head_dim)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
    )


class PagePool:
    """Host-side page allocator over a ``PagedKVCache``.

    A *slot* is one concurrently-running sequence (a row of the serving
    step); each slot owns a page-table row of ``max_pages_per_slot``
    entries. ``seq_lens[slot]`` counts tokens already written. Pages are
    refcounted: prefix sharing lets one page appear in many tables, and a
    page becomes reclaimable when its last reference drops. Every mutation
    of the tables, free list, refcounts or prefix index goes through the
    pool's own methods."""

    def __init__(self, cfg: TransformerConfig, num_pages: int, page_size: int, max_slots: int,
                 max_seq_len: Optional[int] = None, dtype=None, device=None):
        if page_size < 1 or num_pages < 2:
            raise ValueError("need page_size >= 1 and num_pages >= 2 (page 0 is reserved)")
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len or cfg.max_seq_len)
        self.max_pages_per_slot = -(-self.max_seq_len // self.page_size)
        self.cache = init_paged_cache(cfg, num_pages, page_size, dtype=dtype, device=device)
        # LIFO free list keeps hot pages hot; page 0 stays out of circulation
        self._free = list(range(num_pages - 1, TRASH_PAGE, -1))
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self.page_table = np.full((max_slots, self.max_pages_per_slot), -1, np.int32)
        self.seq_lens = np.zeros(max_slots, np.int32)
        self._owned = np.zeros(max_slots, np.int32)  # pages held per slot
        # --- prefix sharing state ---------------------------------------
        self._refcount = np.zeros(num_pages, np.int32)  # table refs per page
        self._hash_index: dict = {}  # chain key -> page id (full-page content)
        self._page_hash: dict = {}  # page id -> chain key (reverse map)
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # ref-0 indexed, LRU
        # per slot: chain key per leading full page whose content-chain is known
        self._chain_keys: List[List[int]] = [[] for _ in range(max_slots)]
        self.stats = {
            "prefix_lookups": 0,
            "prefix_query_tokens": 0,  # prompt tokens offered to match_prefix
            "prefix_hit_tokens": 0,  # tokens served by attaching cached pages
            "prefix_hit_pages": 0,
            "registered_pages": 0,
            "cow_copies": 0,
            "index_invalidations": 0,  # exclusive indexed pages rewritten
            "cache_evictions": 0,  # cold cached pages reclaimed for allocation
        }

    # --- capacity accounting -------------------------------------------
    @property
    def num_pages(self) -> int:
        return self.cache.num_pages

    def free_pages(self) -> int:
        """Reclaimable pages: truly free plus cached (refcount-0 prefix pages)."""
        return len(self._free) + len(self._cached)

    def used_pages(self) -> int:
        """Pages referenced by at least one live slot."""
        return self.num_pages - 1 - self.free_pages()

    def cached_pages(self) -> int:
        """Refcount-0 prefix pages parked on the LRU (reclaimable)."""
        return len(self._cached)

    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size)

    def live_tokens(self) -> int:
        return int(self.seq_lens.sum())

    def live_hbm_bytes(self) -> int:
        """Device bytes pinned by live sequences (page-granular)."""
        return self.used_pages() * self.page_size * self.cache.bytes_per_token

    def utilization(self) -> float:
        """Live tokens over allocated page capacity."""
        cap = self.used_pages() * self.page_size
        return self.live_tokens() / cap if cap else 0.0

    @torch.no_grad()
    def set_cache(self, new_k: torch.Tensor, new_v: torch.Tensor) -> None:
        """Install page arrays (JAX ``kv_pool.py:304``, the one sanctioned
        external write). They are copied into the pools' own storage, as
        ``defrag`` moves pages: a captured window graph holds the pools'
        addresses and keeps replaying into them. A shape or dtype other than
        the pools' raises."""
        for name, new, pages in (("k", new_k, self.cache.k_pages), ("v", new_v, self.cache.v_pages)):
            if tuple(new.shape) != tuple(pages.shape) or new.dtype != pages.dtype:
                raise ValueError(f"set_cache: new {name} pages {tuple(new.shape)} {new.dtype} do not match the "
                                 f"pool's {tuple(pages.shape)} {pages.dtype}")
        for new, pages in ((new_k, self.cache.k_pages), (new_v, self.cache.v_pages)):
            if new.data_ptr() != pages.data_ptr():
                pages.copy_(new)

    # --- page acquisition / release -------------------------------------
    def _acquire_page(self) -> Optional[int]:
        """One page off the free list, or the coldest cached prefix page."""
        if self._free:
            return self._free.pop()
        if self._cached:
            page, _ = self._cached.popitem(last=False)  # oldest first
            self._drop_index(int(page))
            self.stats["cache_evictions"] += 1
            return int(page)
        return None

    def _release_page(self, page: int) -> None:
        """Last reference dropped: indexed pages park on the cached LRU, the
        rest return to the free list."""
        if page in self._page_hash:
            self._cached[page] = None
        else:
            self._free.append(page)

    def _drop_index(self, page: int) -> None:
        key = self._page_hash.pop(page, None)
        if key is not None and self._hash_index.get(key) == page:
            del self._hash_index[key]

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy page ``src`` over page ``dst`` in every layer of both pools,
        in place: a copy-on-write costs one page's bytes."""
        for pages in (self.cache.k_pages, self.cache.v_pages):
            pages[:, dst].copy_(pages[:, src])

    # --- prefix index ----------------------------------------------------
    def _block_key(self, chain: int, block: np.ndarray) -> int:
        return hash((chain, np.ascontiguousarray(block, np.int32).tobytes()))

    def match_prefix(self, tokens) -> List[Tuple[int, int]]:
        """Longest indexed full-page prefix of ``tokens`` as
        ``[(page_id, chain_key), ...]``, capped at ``len(tokens) - 1`` tokens
        so at least one token is always left to prefill."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        P = self.page_size
        max_blocks = min(max(tokens.size - 1, 0) // P, self.max_pages_per_slot)
        out: List[Tuple[int, int]] = []
        chain = _ROOT_CHAIN
        for b in range(max_blocks):
            key = self._block_key(chain, tokens[b * P : (b + 1) * P])
            page = self._hash_index.get(key)
            if page is None:
                break
            out.append((int(page), key))
            chain = key
        return out

    def register_prefix(self, slot: int, tokens, upto: Optional[int] = None) -> int:
        """Publish ``slot``'s leading full pages into the prefix index
        (incremental: pages already chained are skipped). When a block's
        content is already indexed under another page, the existing entry
        wins and this slot's page stays private. Returns the number of full
        pages chained."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        live = int(self.seq_lens[slot])
        upto = live if upto is None else min(int(upto), live, tokens.size)
        P = self.page_size
        n_full = upto // P
        chain_list = self._chain_keys[slot]
        chain = chain_list[-1] if chain_list else _ROOT_CHAIN
        i = len(chain_list)
        while i < n_full:
            key = self._block_key(chain, tokens[i * P : (i + 1) * P])
            page = int(self.page_table[slot, i])
            if key not in self._hash_index and page not in self._page_hash:
                self._hash_index[key] = page
                self._page_hash[page] = key
                self.stats["registered_pages"] += 1
            chain_list.append(key)
            chain = key
            i += 1
        return n_full

    def prefix_stats(self) -> dict:
        """Counters plus ``prefix_hit_rate`` = fraction of looked-up prompt
        tokens served by attaching cached pages."""
        s = dict(self.stats)
        s["indexed_pages"] = len(self._page_hash)
        s["cached_pages"] = self.cached_pages()
        q = s["prefix_query_tokens"]
        s["prefix_hit_rate"] = s["prefix_hit_tokens"] / q if q else 0.0
        return s

    # --- slot lifecycle -------------------------------------------------
    def can_admit(self, n_tokens: int) -> bool:
        """A free slot exists and the pool can hold ``n_tokens`` now (before
        any prefix credit: attaching cached pages only helps)."""
        return (
            bool(self._free_slots)
            and n_tokens <= self.max_seq_len
            and self.pages_for(n_tokens) <= self.free_pages()
        )

    def alloc_slot(self, n_tokens: int = 0, prefix_tokens=None) -> Optional[int]:
        """Claim a slot, pre-reserving pages for ``n_tokens``; None if the
        pool cannot host it now. With ``prefix_tokens`` the longest indexed
        full-page prefix is attached first (refcount raised, ``seq_lens``
        starts at the attached length)."""
        if not self._free_slots:
            return None
        want = max(int(n_tokens), 1)
        if want > self.max_seq_len:
            return None
        matched: List[Tuple[int, int]] = []
        if prefix_tokens is not None:
            matched = self.match_prefix(prefix_tokens)
        # attached cached pages leave the reclaimable set, so discount them
        fresh = self.pages_for(want) - len(matched)
        avail = self.free_pages() - sum(1 for p, _ in matched if p in self._cached)
        if fresh > avail:
            return None
        slot = self._free_slots.pop()
        if prefix_tokens is not None:
            # counted only on successful admission
            self.stats["prefix_lookups"] += 1
            self.stats["prefix_query_tokens"] += int(np.asarray(prefix_tokens).reshape(-1).size)
        self.seq_lens[slot] = 0
        self._chain_keys[slot] = []
        for i, (page, key) in enumerate(matched):
            self.page_table[slot, i] = page
            if self._refcount[page] == 0:
                self._cached.pop(page, None)
            self._refcount[page] += 1
            self._owned[slot] += 1
            self._chain_keys[slot].append(key)
        if matched:
            self.seq_lens[slot] = len(matched) * self.page_size
            self.stats["prefix_hit_pages"] += len(matched)
            self.stats["prefix_hit_tokens"] += len(matched) * self.page_size
        if n_tokens and not self.ensure(slot, n_tokens):
            self.free_slot(slot)
            return None
        return slot

    def ensure(self, slot: int, new_len: int) -> bool:
        """Grow ``slot``'s table to cover ``new_len`` tokens, all or nothing."""
        if new_len > self.max_seq_len:
            return False
        need = self.pages_for(new_len) - self._owned[slot]
        if need <= 0:
            return True
        if need > self.free_pages():
            return False
        for _ in range(int(need)):
            page = self._acquire_page()
            self.page_table[slot, self._owned[slot]] = page
            self._refcount[page] = 1
            self._owned[slot] += 1
        return True

    def prepare_write(self, slot: int, new_len: int) -> bool:
        """Write barrier: make positions ``[seq_lens[slot], new_len)``
        writable and every page in that span EXCLUSIVE and UNINDEXED
        (shared pages get a private copy-on-write duplicate; exclusive
        indexed pages leave the index). All or nothing: False means nothing
        was allocated or copied and the caller should preempt and retry."""
        cur = int(self.seq_lens[slot])
        if new_len > self.max_seq_len:
            return False
        if new_len <= cur:
            return True
        P = self.page_size
        first = cur // P
        last_w = (new_len - 1) // P
        owned = int(self._owned[slot])
        span = range(first, min(last_w + 1, owned))
        shared = [i for i in span if self._refcount[self.page_table[slot, i]] > 1]
        grow = max(self.pages_for(new_len) - owned, 0)
        if grow + len(shared) > self.free_pages():
            return False
        if not self.ensure(slot, new_len):
            return False
        for i in shared:
            src = int(self.page_table[slot, i])
            dst = self._acquire_page()
            self._copy_page(src, dst)
            self.page_table[slot, i] = dst
            self._refcount[dst] = 1
            self._refcount[src] -= 1
            if self._refcount[src] == 0:
                self._release_page(src)
            self.stats["cow_copies"] += 1
        for i in span:
            page = int(self.page_table[slot, i])
            if page in self._page_hash:
                self._drop_index(page)
                self.stats["index_invalidations"] += 1
        # pages from the first written one on are no longer a published prefix
        if first < len(self._chain_keys[slot]):
            del self._chain_keys[slot][first:]
        return True

    def advance(self, slot: int, n_tokens: int) -> None:
        """Record ``n_tokens`` newly written to ``slot`` (pages must be ensured)."""
        new_len = int(self.seq_lens[slot]) + int(n_tokens)
        assert self.pages_for(new_len) <= self._owned[slot], (
            f"slot {slot}: advancing to {new_len} tokens past its "
            f"{int(self._owned[slot])} allocated pages"
        )
        self.seq_lens[slot] = new_len

    def rollback(self, slot: int, n_tokens: int) -> int:
        """Un-write the last ``n_tokens`` of ``slot`` and release every page
        past the new length (refcount-aware). Returns pages released."""
        n_tokens = int(n_tokens)
        new_len = int(self.seq_lens[slot]) - n_tokens
        if n_tokens < 0 or new_len < 0:
            raise ValueError(f"rollback({slot}, {n_tokens}): slot holds {int(self.seq_lens[slot])} tokens")
        self.seq_lens[slot] = new_len
        keep = self.pages_for(new_len)
        freed = 0
        while self._owned[slot] > keep:
            self._owned[slot] -= 1
            i = int(self._owned[slot])
            page = int(self.page_table[slot, i])
            self.page_table[slot, i] = -1
            self._refcount[page] -= 1
            if self._refcount[page] == 0:
                self._release_page(page)
            freed += 1
        del self._chain_keys[slot][min(len(self._chain_keys[slot]), keep):]
        return freed

    def trim_reservation(self, slot: int) -> int:
        """Release the pages reserved past the slot's live length: a
        multi-step window reserves ``prepare_write(slot, len + N)`` before
        its one dispatch, and rows that freeze early (EOS, budget) or a
        window that falls back before dispatching hand the unused tail back
        here. ``rollback``'s refcount rules (a zero-token rollback). Returns
        pages released."""
        return self.rollback(slot, 0)

    def free_slot(self, slot: int) -> int:
        """Release the slot and drop its page references; returns how many
        pages the slot held."""
        n = int(self._owned[slot])
        for i in range(n):
            page = int(self.page_table[slot, i])
            self._refcount[page] -= 1
            if self._refcount[page] == 0:
                self._release_page(page)
        self.page_table[slot, :] = -1
        self.seq_lens[slot] = 0
        self._owned[slot] = 0
        self._chain_keys[slot] = []
        self._free_slots.append(slot)
        return n

    # --- maintenance ----------------------------------------------------
    def integrity_check(self) -> None:
        """Verify every allocatable page is exactly one of {free, cached,
        referenced}, refcounts equal table references, cached pages are
        indexed, and live lengths fit owned pages. Raises RuntimeError."""
        refs: dict = {}
        for s in range(self.max_slots):
            owned = int(self._owned[s])
            if self.pages_for(int(self.seq_lens[s])) > owned:
                raise RuntimeError(f"pool integrity: slot {s} holds {int(self.seq_lens[s])} tokens but only {owned} pages")
            for i in range(owned):
                p = int(self.page_table[s, i])
                if p <= TRASH_PAGE or p >= self.num_pages:
                    raise RuntimeError(f"pool integrity: slot {s} table entry {i} is {p}")
                refs[p] = refs.get(p, 0) + 1
        free = set(self._free)
        cached = set(int(p) for p in self._cached)
        referenced = set(refs)
        for name_a, set_a, name_b, set_b in (
            ("free", free, "cached", cached),
            ("free", free, "referenced", referenced),
            ("cached", cached, "referenced", referenced),
        ):
            overlap = set_a & set_b
            if overlap:
                raise RuntimeError(f"pool integrity: page {min(overlap)} is both {name_a} and {name_b}")
        missing = set(range(TRASH_PAGE + 1, self.num_pages)) - free - cached - referenced
        if missing:
            raise RuntimeError(f"pool integrity: page {min(missing)} leaked")
        for p, n in refs.items():
            if int(self._refcount[p]) != n:
                raise RuntimeError(f"pool integrity: page {p} refcount {int(self._refcount[p])} but {n} table reference(s)")
        for p in cached:
            if p not in self._page_hash:
                raise RuntimeError(f"pool integrity: cached page {p} is not in the prefix index")

    def defrag(self) -> int:
        """Compact live pages into the lowest ids after the trash page, in
        first-reference order (slot by slot, then the cached LRU), and
        rewrite tables, refcounts, the prefix index, the LRU and the free
        list to follow. Live means referenced by a slot or parked on the
        cached LRU (its bytes still serve prefix matches); a shared page
        moves once. The page data moves by one gather a pool, copied back
        into the pools' own storage: a captured window graph holds their
        addresses and must keep replaying into them. Returns the number of
        pages moved."""
        live: List[int] = []
        seen = set()
        for s in range(self.max_slots):
            for i in range(int(self._owned[s])):
                p = int(self.page_table[s, i])
                if p not in seen:
                    seen.add(p)
                    live.append(p)
        live += [int(p) for p in self._cached]  # refcount 0: never in a table
        perm = np.arange(self.num_pages, dtype=np.int64)  # new id -> old id
        remap = {}  # old id -> new id
        nxt = TRASH_PAGE + 1
        for old in live:
            remap[old] = nxt
            perm[nxt] = old
            nxt += 1
        # the tail: the free pages, in id order
        perm[nxt:] = [p for p in range(TRASH_PAGE + 1, self.num_pages) if p not in remap]
        moves = sum(1 for old, new in remap.items() if old != new)
        if moves == 0:
            return 0
        gather = torch.from_numpy(perm).to(self.cache.k_pages.device)
        for pages in (self.cache.k_pages, self.cache.v_pages):
            pages.copy_(pages[:, gather])
        for s in range(self.max_slots):
            for i in range(int(self._owned[s])):
                self.page_table[s, i] = remap[int(self.page_table[s, i])]
        new_rc = np.zeros_like(self._refcount)
        for old, new in remap.items():
            new_rc[new] = self._refcount[old]
        self._refcount = new_rc
        self._page_hash = {remap[p]: k for p, k in self._page_hash.items()}
        self._hash_index = {k: remap[p] for k, p in self._hash_index.items()}
        self._cached = OrderedDict((remap[int(p)], None) for p in self._cached)
        self._free = list(range(self.num_pages - 1, nxt - 1, -1))
        return moves

    # --- dispatch views -------------------------------------------------
    def rows(self, slots) -> Tuple[np.ndarray, np.ndarray]:
        """(page_table_rows, seq_lens) for a list of slots as int32 arrays."""
        idx = np.asarray(slots, np.int32)
        return self.page_table[idx], self.seq_lens[idx]
