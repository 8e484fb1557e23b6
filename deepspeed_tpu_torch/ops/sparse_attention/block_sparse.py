"""Fused block-sparse attention: the forward (K7) and backward (K8, K9).

Counterpart of ``deepspeed_tpu/ops/sparse_attention/pallas_block_sparse.py``.
The three Pallas kernels there become three CUDA kernels in
``csrc/block_sparse_attention.cu``, built with ``nvcc`` on first use and
bound through ``ctypes`` (``ops/native.py``):

* K7 ``_fwd_kernel`` (``:78``): for each q block, attention over the kv
  blocks of its compacted row list; O and the fp32 log-sum-exp of each row;
* K8 ``_dq_kernel`` (``:163``): dQ over the same row lists, from LSE and
  Δ = rowsum(dO∘O);
* K9 ``_dkv_kernel`` (``:194``): dK and dV over the transposed column lists.

``build_block_tables`` (``:44``) compacts a ``[nq, nk]`` layout into padded
live lists; ``block_tables`` keeps them as int32 tensors per (layout,
device), so a step makes no host-to-device copy (JAX builds them once at
trace time). ``build_fwd_units`` and ``build_dkv_units`` turn the row and
column lists into the work lists of the tensor-core variants: 16-row q
tiles (K7 and K8 share one table) or key tiles (K9), grouped four to a unit
where their blocks list the same blocks of the other side, and lists longer
than ``list_cap`` cut into chunks whose fp32 partials a second pass combines
in chunk order; ``fwd_units`` and ``dkv_units`` keep them per (layout,
block, device).
``fused_block_sparse_attention(q, k, v, layout, block, causal, scale)`` is
the counterpart of ``pallas_block_sparse_attention`` (``:316``):
``[B, NH, T, D]`` inputs, a shared layout (leading dim 1) folds heads into
the batch, per-head layouts make one call per head. It is differentiable: a
``torch.autograd.Function`` whose forward runs K7 and saves ``(q, k, v, o,
lse)`` and the tables, and whose backward computes Δ in fp32 with plain torch
ops (JAX computes it in XLA outside the kernels, ``:232``) and runs K8 and
K9 (K8 on the forward's unit table). LSE is a plain ``[B·NH, T]`` fp32 array (``[BN, T, 128]`` lane-broadcast
on the TPU).

Each kernel has a plain PyTorch version here (``sparse_fwd_plain``,
``sparse_dq_plain``, ``sparse_dkv_plain``) with the Pallas kernels' math,
which differs from the flash kernels': q, k, v and dO are widened to fp32 and
P and dS stay fp32 through every product; scores are scaled after the
product; the causal mask inside a pair uses the finite ``NEG_INF`` and masked
probabilities are zeroed explicitly, so a row with no live score gives O = 0,
LSE = ``NEG_INF`` and dQ = 0. The plain K7 and K8 gather each row's listed
kv blocks; the plain K9 walks the live (k block, q block) pairs of the column
lists and sums them into dK and dV with ``index_add_``. A CPU tensor takes the
plain versions; a CUDA tensor launches the kernels or raises
(``impl="plain"`` asks for the plain versions on the card, as the comparison
arm). The kernels take ``D`` in ``HEAD_DIMS`` and blocks that are a multiple
of 8 up to ``MAX_BLOCK``; any other size on a CUDA tensor raises
``NotImplementedError``.

K7-K9 have two variants in the CUDA source, chosen by dtype: bf16 and
fp16 run on the tensor cores (``mma.sync``; the fp32 P and dS enter their
products as hi + lo pairs in the input dtype, so the fp32 numerics hold to
about 2⁻¹⁶), fp32 keeps the FMA kernels as the card's parity path.
``sparse_fwd_chunked_plain`` and ``sparse_dq_chunked_plain`` are the
tensor-core K7's chunk-and-merge and K8's chunk-and-sum arithmetic in plain
torch (CPU tests only). ``launches_fwd``, ``launches_dq`` and
``launches_dkv`` count the kernels' calls and nothing else (K7's merge and
K8's and K9's reduction passes are part of their calls);
``launches_fwd_tc``, ``launches_dq_tc`` and ``launches_dkv_tc`` count the
calls that the CUDA entry reports as the tensor-core variant.
Nothing CUDA is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.transformer.flash_attention import _DTYPE_CODES, _use_kernel

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
MAX_BLOCK = 128

UNIT_WARPS = 4  # tiles of a K7 or K9 unit (one warp each)
UNIT_TILE = 16  # rows of a tile

launches_fwd = 0  # K7 calls since the caller last set it to 0 (its merge pass included)
launches_fwd_tc = 0  # of those, calls of the tensor-core variant (bf16, fp16)
launches_dq = 0  # K8 calls (its reduction pass included)
launches_dq_tc = 0  # of those, calls of the tensor-core variant (bf16, fp16)
launches_dkv = 0  # K9 calls (its reduction pass included)
launches_dkv_tc = 0  # of those, calls of the tensor-core variant (bf16, fp16)

_entries = {}
_tables = {}  # (layout shape, layout bytes, device) -> (row_idx, row_cnt, col_idx, col_cnt)
_units = {}  # (build function name, layout shape, layout bytes, block, device) -> Units
_TABLE_CACHE_SIZE = 256


# --- block tables --------------------------------------------------------------
def build_block_tables(layout_h: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Compact a [nq, nk] bool layout into padded live lists.

    Returns (row_idx [nq, Lr], row_cnt [nq], col_idx [nk, Lc], col_cnt [nk]).
    """
    layout_h = np.asarray(layout_h, dtype=bool)

    def compact(mat):
        live = [np.nonzero(mat[r])[0] for r in range(mat.shape[0])]
        width = max(1, max((len(l) for l in live), default=1))
        idx = np.zeros((mat.shape[0], width), dtype=np.int32)
        cnt = np.zeros((mat.shape[0],), dtype=np.int32)
        for r, l in enumerate(live):
            idx[r, : len(l)] = l
            cnt[r] = len(l)
        return idx, cnt

    row_idx, row_cnt = compact(layout_h)
    col_idx, col_cnt = compact(layout_h.T)
    return row_idx, row_cnt, col_idx, col_cnt


def block_tables(layout_h: np.ndarray, device) -> Tuple[torch.Tensor, ...]:
    """``build_block_tables`` as int32 tensors on ``device``, built once per
    (layout, device) and kept."""
    layout_h = np.ascontiguousarray(np.asarray(layout_h, dtype=bool))
    device = torch.device(device)
    key = (layout_h.shape, layout_h.tobytes(), str(device))
    tables = _tables.get(key)
    if tables is None:
        if len(_tables) >= _TABLE_CACHE_SIZE:
            _tables.clear()
        tables = _tables[key] = tuple(torch.from_numpy(t).to(device) for t in build_block_tables(layout_h))
    return tables


class Units(NamedTuple):
    """The work list of the tensor-core K7 and K8 (``side`` "rows") or K9
    (``side`` "cols") for one (layout, block): ``units`` int32 ``[U, 3 + 2
    · UNIT_WARPS]`` rows of (list block, start, length, tile starts,
    workspace slots), heaviest first; ``reduce`` int32 ``[R, 3]`` rows of
    (block, first slot, chunks) for the split blocks; the workspace's slots;
    the chunk cap; the block; the number of blocks on the tiled side (q
    blocks for K7 and K8, key blocks for K9)."""

    units: object
    reduce: object
    n_slots: int
    cap: int
    block: int
    n_blocks: int
    side: str


def list_cap(cnt: np.ndarray) -> int:
    """Longest list chunk a unit takes: twice the mean list length, at least
    8. The heavy lists of a layout (a global key column lists every q block,
    a global q row every key block) are cut to about the length of an
    average one, so no single unit outlasts the rest of the launch."""
    mean = float(np.mean(cnt)) if np.size(cnt) else 0.0
    return max(8, int(np.ceil(2.0 * mean)))


def _build_units(idx: np.ndarray, cnt: np.ndarray, block: int, side: str) -> Units:
    """Units over the compacted lists ``idx`` / ``cnt`` of one side: each of
    its blocks is cut into ``UNIT_TILE``-row tiles (the last one partial when
    ``block`` is not a multiple of 16). Blocks whose lists are equal are
    grouped, so that a unit's warps share each staged tile of the other
    side. A list longer than ``list_cap`` is cut into balanced chunks of at
    most the cap; each chunk of a split block writes fp32 partials to its
    own workspace slot, and a second pass combines a block's slots in chunk
    order (deterministic). A unit is (the list's block, chunk start, chunk
    length, up to ``UNIT_WARPS`` tile start rows, their slots or -1 where the
    unit owns the whole list); unused warps carry -1. Units are ordered by
    chunk length, longest first. A block with an empty list still has a unit
    of length 0, which writes its zeros."""
    cap = list_cap(cnt)
    subs = -(-block // UNIT_TILE)
    groups = {}
    for b in range(cnt.shape[0]):
        groups.setdefault(tuple(idx[b, : cnt[b]].tolist()), []).append(b)
    units, reduce, n_slots = [], [], 0
    for lst, blocks in groups.items():
        n_chunks = max(1, -(-len(lst) // cap))
        bounds = [len(lst) * c // n_chunks for c in range(n_chunks + 1)]
        base = {}
        if n_chunks > 1:
            for b in blocks:
                base[b] = n_slots
                reduce.append((b, n_slots, n_chunks))
                n_slots += n_chunks
        tiles = [(b, b * block + UNIT_TILE * sub) for b in blocks for sub in range(subs)]
        for c in range(n_chunks):
            for i in range(0, len(tiles), UNIT_WARPS):
                grp = tiles[i: i + UNIT_WARPS]
                pad = [-1] * (UNIT_WARPS - len(grp))
                units.append([blocks[0], bounds[c], bounds[c + 1] - bounds[c]] + [t for _, t in grp] + pad
                             + [base[b] + c if n_chunks > 1 else -1 for b, _ in grp] + pad)
    units = np.asarray(units, dtype=np.int32).reshape(-1, 3 + 2 * UNIT_WARPS)
    units = units[np.argsort(-units[:, 2], kind="stable")]
    reduce = np.asarray(reduce, dtype=np.int32).reshape(-1, 3)
    return Units(units, reduce, n_slots, cap, block, cnt.shape[0], side)


def build_fwd_units(layout_h: np.ndarray, block: int) -> Units:
    """K7's and K8's units for a ``[nq, nk]`` layout at this block size, in
    numpy: 16-row q tiles grouped four to a unit where their q blocks list
    the same key blocks, over the row lists of ``build_block_tables``. A
    split q block's chunks write (acc, m, l) partials that K7's merge pass
    combines with K4's formula, and fp32 dQ partials that K8's reduction
    sums in chunk order."""
    row_idx, row_cnt, _, _ = build_block_tables(layout_h)
    return _build_units(row_idx, row_cnt, block, "rows")


def build_dkv_units(layout_h: np.ndarray, block: int) -> Units:
    """K9's units for a ``[nq, nk]`` layout at this block size, in numpy:
    16-row key tiles grouped four to a unit where their key blocks list the
    same q blocks, over the column lists of ``build_block_tables``. A split
    key block's chunks write fp32 dK and dV partials that the reduction sums
    in chunk order."""
    _, _, col_idx, col_cnt = build_block_tables(layout_h)
    return _build_units(col_idx, col_cnt, block, "cols")


def _cached_units(build, layout_h: np.ndarray, block: int, device) -> Units:
    layout_h = np.ascontiguousarray(np.asarray(layout_h, dtype=bool))
    device = torch.device(device)
    key = (build.__name__, layout_h.shape, layout_h.tobytes(), int(block), str(device))
    found = _units.get(key)
    if found is None:
        if len(_units) >= _TABLE_CACHE_SIZE:
            _units.clear()
        built = build(layout_h, int(block))
        found = _units[key] = built._replace(units=torch.from_numpy(built.units).to(device),
                                             reduce=torch.from_numpy(built.reduce).to(device))
    return found


def fwd_units(layout_h: np.ndarray, block: int, device) -> Units:
    """``build_fwd_units`` with its tables as int32 tensors on ``device``,
    built once per (layout, block, device) and kept."""
    return _cached_units(build_fwd_units, layout_h, block, device)


def dkv_units(layout_h: np.ndarray, block: int, device) -> Units:
    """``build_dkv_units`` with its tables as int32 tensors on ``device``,
    built once per (layout, block, device) and kept."""
    return _cached_units(build_dkv_units, layout_h, block, device)


# --- plain versions ------------------------------------------------------------
def _blocks(x: torch.Tensor, blk: int) -> torch.Tensor:
    """``[BN, T, ...]`` → ``[BN, T / blk, blk, ...]``."""
    return x.reshape(x.shape[0], x.shape[1] // blk, blk, *x.shape[2:])


def _row_mask(row_idx, row_cnt, blk: int, causal: bool) -> torch.Tensor:
    """``[nq, blk, L, blk]``: listed entries of each row list, and under the
    causal mask only (row, key) pairs with row >= key (global positions)."""
    nq, width = row_idx.shape
    dev = row_idx.device
    listed = torch.arange(width, device=dev)[None, :] < row_cnt[:, None].long()  # [nq, L]
    mask = listed[:, None, :, None].expand(nq, blk, width, blk)
    if causal:
        offs = torch.arange(blk, device=dev)
        rows = torch.arange(nq, device=dev)[:, None] * blk + offs  # [nq, blk]
        cols = row_idx.long()[:, :, None] * blk + offs  # [nq, L, blk]
        mask = mask & (rows[:, :, None, None] >= cols[:, None, :, :])
    return mask


def _row_scores(q, k, row_idx, row_cnt, scale: float, blk: int, causal: bool):
    """fp32 scores of each q block against its listed kv blocks,
    ``[BN, nq, blk, L, blk]``, masked to ``NEG_INF``, and the mask."""
    kg = _blocks(k.float(), blk)[:, row_idx.long()]  # [BN, nq, L, blk, D]
    s = torch.einsum("bqid,bqljd->bqilj", _blocks(q.float(), blk), kg) * scale
    mask = _row_mask(row_idx, row_cnt, blk, causal)
    return s.masked_fill(~mask, NEG_INF), mask


def _fwd_partials_plain(q, k, v, row_idx, row_cnt, scale: float, blk: int, causal: bool):
    """Each row's softmax partial over its listed kv blocks, fp32: ``m`` the
    largest live scaled score (``NEG_INF`` where none is live), ``l = Σ
    exp(s - m)`` and ``acc = Σ exp(s - m)·v`` over the live scores, as
    ``[BN, T]``, ``[BN, T]`` and ``[BN, T, D]``."""
    BN, T, D = q.shape
    s, mask = _row_scores(q, k, row_idx, row_cnt, scale, blk, causal)
    nq, width = row_idx.shape
    s = s.reshape(BN, nq, blk, width * blk)
    mask = mask.reshape(nq, blk, width * blk)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1)
    vg = _blocks(v.float(), blk)[:, row_idx.long()].reshape(BN, nq, width * blk, D)
    acc = torch.einsum("bqik,bqkd->bqid", p, vg)
    return m.reshape(BN, T), l.reshape(BN, T), acc.reshape(BN, T, D)


def _fwd_finish(m, l, acc, dtype):
    """``(o in dtype, lse)`` from merged partials: ``o = acc / l`` and ``lse =
    m + log l``; a row with ``l == 0`` gives O = 0 and LSE = ``NEG_INF``."""
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    o = (acc / safe_l[..., None]).to(dtype)
    return o, torch.where(l == 0, torch.full_like(l, NEG_INF), m + torch.log(safe_l))


def sparse_fwd_plain(q, k, v, row_idx, row_cnt, scale: float, blk: int, causal: bool):
    """K7's function on ``[BN, T, D]``: ``(o in q's dtype, lse [BN, T] fp32)``."""
    return _fwd_finish(*_fwd_partials_plain(q, k, v, row_idx, row_cnt, scale, blk, causal), q.dtype)


def _chunk_tables(row_idx, units: Units, blk: int):
    """The row tables of each chunk of ``units`` (``build_fwd_units``), in
    chunk order: table c lists, for every q block, the c-th chunk of its row
    list (nothing where the block has fewer chunks; an unsplit block is its
    own single chunk)."""
    rows = np.asarray(units.units.cpu() if isinstance(units.units, torch.Tensor) else units.units)
    nq, width = row_idx.shape
    chunks = [set() for _ in range(nq)]
    for row in rows:
        for tile in row[3: 3 + UNIT_WARPS]:
            if tile >= 0:
                chunks[int(tile) // blk].add((int(row[1]), int(row[2])))
    chunks = [sorted(c) for c in chunks]
    ri = row_idx.cpu().numpy()
    tables = []
    for c in range(max(len(x) for x in chunks)):
        idx_c = np.zeros((nq, width), np.int32)
        cnt_c = np.zeros((nq,), np.int32)
        for qb, lst in enumerate(chunks):
            if c < len(lst):
                s0, n = lst[c]
                idx_c[qb, :n] = ri[qb, s0: s0 + n]
                cnt_c[qb] = n
        tables.append((torch.from_numpy(idx_c).to(row_idx.device), torch.from_numpy(cnt_c).to(row_idx.device)))
    return tables


def sparse_fwd_chunked_plain(q, k, v, row_idx, row_cnt, units: Units, scale: float, blk: int, causal: bool):
    """The tensor-core K7's arithmetic over its unit table in plain torch:
    each q block's list in the chunks ``units`` (``build_fwd_units``) give
    it, one fp32 partial ``(m, l, acc)`` a chunk, merged in chunk order with
    the merge kernel's formula (``M = max m`` over chunks with ``l > 0``,
    then ``L += exp(m - M)·l`` and ``O += exp(m - M)·acc`` chunk by chunk,
    ``O / L``). Returns ``(o, lse)`` as ``sparse_fwd_plain``; the CPU tests
    hold it against that and the Pallas kernel (no main path calls it)."""
    parts = [_fwd_partials_plain(q, k, v, idx_c, cnt_c, scale, blk, causal)
             for idx_c, cnt_c in _chunk_tables(row_idx, units, blk)]
    M = torch.stack([torch.where(l > 0, m, torch.full_like(m, NEG_INF)) for m, l, _ in parts]).amax(dim=0)
    L = torch.zeros_like(M)
    O = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        wgt = torch.where(l > 0, torch.exp(m - M), torch.zeros_like(M))
        L = L + wgt * l
        O = O + wgt[..., None] * acc
    return _fwd_finish(M, L, O, q.dtype)


def _dq_partial_plain(q, k, v, do, lse, delta, row_idx, row_cnt, scale: float, blk: int, causal: bool,
                      ds_dtype=None):
    """K8's sum over the listed kv blocks of each row list, in fp32
    ``[BN, T, D]``. ``ds_dtype`` rounds dS to that dtype before dS·K (K2's
    rule, not K8's: the foil the card checks hold K8's fp32 dS against)."""
    BN, T, D = q.shape
    s, mask = _row_scores(q, k, row_idx, row_cnt, scale, blk, causal)
    lse_b = _blocks(lse, blk)[:, :, :, None, None]
    p = torch.exp(s - lse_b).masked_fill(~mask, 0.0)
    vg = _blocks(v.float(), blk)[:, row_idx.long()]
    dp = torch.einsum("bqid,bqljd->bqilj", _blocks(do.float(), blk), vg)
    ds = p * (dp - _blocks(delta, blk)[:, :, :, None, None]) * scale
    if ds_dtype is not None:
        ds = ds.to(ds_dtype).float()
    kg = _blocks(k.float(), blk)[:, row_idx.long()]
    return torch.einsum("bqilj,bqljd->bqid", ds, kg).reshape(BN, T, D)


def sparse_dq_plain(q, k, v, do, lse, delta, row_idx, row_cnt, scale: float, blk: int, causal: bool,
                    ds_dtype=None):
    """K8's function: dQ in q's dtype. ``lse`` and ``delta`` are ``[BN, T]``
    fp32; ``ds_dtype`` as ``_dq_partial_plain``."""
    return _dq_partial_plain(q, k, v, do, lse, delta, row_idx, row_cnt, scale, blk, causal, ds_dtype).to(q.dtype)


def sparse_dq_chunked_plain(q, k, v, do, lse, delta, row_idx, row_cnt, units: Units, scale: float, blk: int,
                            causal: bool):
    """The tensor-core K8's arithmetic over K7's unit table in plain torch:
    each q block's list in the chunks ``units`` (``build_fwd_units``) give
    it, one fp32 dQ partial a chunk, summed in chunk order as the reduction
    kernel sums them, then rounded to q's dtype. Returns dQ as
    ``sparse_dq_plain``; the CPU tests hold it against that and the Pallas
    kernel (no main path calls it)."""
    dq = None
    for idx_c, cnt_c in _chunk_tables(row_idx, units, blk):
        part = _dq_partial_plain(q, k, v, do, lse, delta, idx_c, cnt_c, scale, blk, causal)
        dq = part if dq is None else dq + part
    return dq.to(q.dtype)


def sparse_dkv_plain(q, k, v, do, lse, delta, col_idx, col_cnt, scale: float, blk: int, causal: bool):
    """K9's function: ``(dK, dV)`` in k's and v's dtypes, summed over the
    live (k block, q block) pairs of the column lists."""
    BN, T, D = q.shape
    nk, width = col_idx.shape
    dev = col_idx.device
    listed = torch.arange(width, device=dev)[None, :] < col_cnt[:, None].long()
    kb, li = torch.nonzero(listed, as_tuple=True)  # one entry per live pair
    qb = col_idx.long()[kb, li]
    qg, dog = (_blocks(x.float(), blk)[:, qb] for x in (q, do))  # [BN, P, blk, D]
    kg, vg = (_blocks(x.float(), blk)[:, kb] for x in (k, v))
    lse_g, delta_g = (_blocks(x, blk)[:, qb][..., None] for x in (lse, delta))  # [BN, P, blk, 1]
    s = torch.einsum("bpid,bpjd->bpij", qg, kg) * scale  # [BN, P, blk (rows), blk (keys)]
    live = torch.ones(qb.shape[0], blk, blk, dtype=torch.bool, device=dev)
    if causal:
        offs = torch.arange(blk, device=dev)
        live = (qb[:, None] * blk + offs)[:, :, None] >= (kb[:, None] * blk + offs)[:, None, :]
    p = torch.exp(s - lse_g).masked_fill(~live, 0.0)
    dp = torch.einsum("bpid,bpjd->bpij", dog, vg)
    ds = p * (dp - delta_g) * scale
    dk = torch.zeros(BN, nk, blk, D, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dk.index_add_(1, kb, torch.einsum("bpij,bpid->bpjd", ds, qg))
    dv.index_add_(1, kb, torch.einsum("bpij,bpid->bpjd", p, dog))
    return dk.reshape(BN, T, D).to(k.dtype), dv.reshape(BN, T, D).to(v.dtype)


def sparse_delta(o, do):
    """Δ = rowsum(dO∘O) in fp32, ``[BN, T]`` (``pallas_block_sparse.py:232``)."""
    return (do.float() * o.float()).sum(-1)


# --- the CUDA kernels --------------------------------------------------------------
def _entry(name: str):
    fn = _entries.get(name)
    if fn is None:
        from deepspeed_tpu_torch.ops import native

        fn = getattr(native.load("block_sparse_attention"), name)
        fn.restype = ctypes.c_int
        n_ptrs = {"block_sparse_fwd": 10, "block_sparse_dq": 12, "block_sparse_dkv": 13}[name]
        fn.argtypes = (
            [ctypes.c_int]  # dtype code
            + [ctypes.c_void_p] * n_ptrs
            + [ctypes.c_int] * 3  # n_units, n_reduce, n_slots
            + [ctypes.c_int] * 6  # width, BN, T, D, blk, causal
            + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
            + [ctypes.POINTER(ctypes.c_int)]  # the variant launched
        )
        _entries[name] = fn
    return fn


def _check(q, k, v, blk: int, tables, *more):
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA block-sparse kernels take CUDA tensors, got q on {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16, float16)")
    if q.dim() != 3:
        raise ValueError(f"q must be [B*NH, T, D], got {tuple(q.shape)}")
    BN, T, D = q.shape
    if D not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {D} not supported by the block-sparse kernels "
                                  f"(supported: {HEAD_DIMS}; ROADMAP B)")
    if blk % 8 or not 8 <= blk <= MAX_BLOCK:
        raise NotImplementedError(f"block {blk} not supported by the block-sparse kernels "
                                  f"(a multiple of 8 up to {MAX_BLOCK}; ROADMAP B)")
    if T % blk:
        raise ValueError(f"seq len {T} not divisible by block {blk}")
    if BN > 65535:
        raise NotImplementedError(f"B*NH = {BN} above the kernels' grid limit of 65535")
    for name, t in (("k", k), ("v", v)) + tuple(more):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must match q {tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} must match q's {q.dtype}")
    idx, cnt = tables
    if idx.dtype != torch.int32 or cnt.dtype != torch.int32 or idx.device != q.device or \
            cnt.device != q.device or idx.dim() != 2 or idx.shape[0] != T // blk or \
            cnt.shape != (T // blk,) or not idx.is_contiguous():
        raise ValueError(f"block tables must be contiguous int32 [{T // blk}, width] and [{T // blk}] on "
                         f"{q.device}, got {tuple(idx.shape)} {idx.dtype} and {tuple(cnt.shape)} {cnt.dtype}")


def _check_residuals(q, do, lse, delta):
    BN, T, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (BN, T) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 [BN, T] = {(BN, T)}, got {tuple(t.shape)} {t.dtype}")


def _launch(name: str, q, ptrs, idx, units: Units, ws, blk: int, causal: bool, scale: float) -> int:
    """Launch ``name`` with the unit tables and workspace after the pointers;
    returns the variant the entry reports (0 FMA, 1 tensor cores)."""
    BN, T, D = q.shape
    fn = _entry(name)
    variant = ctypes.c_int(-1)
    ptrs = (*ptrs, units.units.data_ptr(), units.reduce.data_ptr(), 0 if ws is None else ws.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], *ptrs, units.units.shape[0], units.reduce.shape[0], units.n_slots,
                 idx.shape[1], BN, T, D, blk, int(bool(causal)), float(scale), stream, ctypes.byref(variant))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    return variant.value


def _workspace(q, units: Units, *inner):
    """The fp32 workspace of the split blocks' partials, ``[BN, n_slots,
    *inner]`` (bf16 and fp16 only; fp32 takes the FMA kernels), or None."""
    if q.dtype == torch.float32 or not units.n_slots:
        return None
    return torch.empty(q.shape[0], units.n_slots, *inner, dtype=torch.float32, device=q.device)


def sparse_fwd_kernel(q, k, v, row_idx, row_cnt, units: Units, scale: float, blk: int, causal: bool):
    """Launch K7 on the current stream: ``(o, lse)`` as ``sparse_fwd_plain``.
    ``units`` is ``fwd_units(layout, blk, device)`` of the layout whose row
    tables these are: the tensor-core variant (bf16, fp16) walks them and,
    where the layout has split q blocks, merges their fp32 partials from a
    workspace allocated here; fp32 takes the FMA variant and ignores them."""
    global launches_fwd, launches_fwd_tc
    _check_units(units, "rows", q, blk)
    _check(q, k, v, blk, (row_idx, row_cnt))
    BN, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(BN, T, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    variant = _launch("block_sparse_fwd", q, (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                              lse.data_ptr(), row_idx.data_ptr(), row_cnt.data_ptr()),
                      row_idx, units, _workspace(q, units, blk, D + 2), blk, causal, scale)
    launches_fwd += 1
    launches_fwd_tc += int(variant == 1)
    return o, lse


def sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, units: Units, scale: float, blk: int,
                     causal: bool):
    """Launch K8: dQ as ``sparse_dq_plain``. ``units`` is ``fwd_units(layout,
    blk, device)``, K7's table of the layout whose row tables these are: the
    tensor-core variant (bf16, fp16) walks it and, where the layout has
    split q blocks, sums their fp32 partials from a workspace allocated
    here; fp32 takes the FMA variant and ignores it."""
    global launches_dq, launches_dq_tc
    _check_units(units, "rows", q, blk)
    _check(q, k, v, blk, (row_idx, row_cnt), ("do", do), ("lse", lse), ("delta", delta))
    _check_residuals(q, do, lse, delta)
    D = q.shape[-1]
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    variant = _launch("block_sparse_dq", q, (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), row_idx.data_ptr(),
                                             row_cnt.data_ptr()),
                      row_idx, units, _workspace(q, units, blk, D), blk, causal, scale)
    launches_dq += 1
    launches_dq_tc += int(variant == 1)
    return dq


def _check_units(units: Units, side: str, q, blk: int):
    """``units`` must be this layout's table of ``side`` ("rows": ``fwd_units``
    for K7 and K8; "cols": ``dkv_units`` for K9) at this block, on q's
    device."""
    T = q.shape[-2] if q.dim() >= 2 else -1
    if not isinstance(units, Units) or units.side != side or units.block != blk or \
            units.n_blocks != T // blk or units.units.device != q.device or units.reduce.device != q.device:
        build = "fwd_units" if side == "rows" else "dkv_units"
        raise ValueError(f"this kernel needs the unit tables of its layout at block {blk} on {q.device} "
                         f"({build}(layout, {blk}, device))")


def sparse_dkv_kernel(q, k, v, do, lse, delta, col_idx, col_cnt, units: Units, scale: float, blk: int,
                      causal: bool):
    """Launch K9: ``(dK, dV)`` as ``sparse_dkv_plain``. ``units`` is
    ``dkv_units(layout, blk, device)`` of the layout whose column tables
    these are: the tensor-core variant (bf16, fp16) walks them and, where the
    layout has split key blocks, sums their fp32 partials from a workspace
    allocated here; fp32 takes the FMA variant and ignores them."""
    global launches_dkv, launches_dkv_tc
    _check_units(units, "cols", q, blk)
    _check(q, k, v, blk, (col_idx, col_cnt), ("do", do), ("lse", lse), ("delta", delta))
    _check_residuals(q, do, lse, delta)
    D = q.shape[-1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    variant = _launch("block_sparse_dkv", q, (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                              lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                              col_idx.data_ptr(), col_cnt.data_ptr()),
                      col_idx, units, _workspace(q, units, 2, blk, D), blk, causal, scale)
    launches_dkv += 1
    launches_dkv_tc += int(variant == 1)
    return dk, dv


# --- dispatch and autograd (``_use_kernel``: the flash module's rule) ----------------
class _BlockSparseAttention(torch.autograd.Function):
    """``_sparse_core`` (``pallas_block_sparse.py:297-313``) on ``[BN, T, D]``."""

    @staticmethod
    def forward(ctx, q, k, v, tables, units, scale: float, blk: int, causal: bool, impl: Optional[str]):
        row_idx, row_cnt, _, _ = tables
        kernel = _use_kernel(q, impl)
        if kernel:
            o, lse = sparse_fwd_kernel(q, k, v, row_idx, row_cnt, units[0], scale, blk, causal)
        else:
            o, lse = sparse_fwd_plain(q, k, v, row_idx, row_cnt, scale, blk, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.tables, ctx.units, ctx.scale, ctx.blk, ctx.causal, ctx.kernel = tables, units, scale, blk, causal, kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        row_idx, row_cnt, col_idx, col_cnt = ctx.tables
        do = do.contiguous()
        delta = sparse_delta(o, do)
        args = (ctx.scale, ctx.blk, ctx.causal)
        if ctx.kernel:
            dq = sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, ctx.units[0], *args)
            dk, dv = sparse_dkv_kernel(q, k, v, do, lse, delta, col_idx, col_cnt, ctx.units[1], *args)
        else:
            dq = sparse_dq_plain(q, k, v, do, lse, delta, row_idx, row_cnt, *args)
            dk, dv = sparse_dkv_plain(q, k, v, do, lse, delta, col_idx, col_cnt, *args)
        return dq, dk, dv, None, None, None, None, None, None


def fused_block_sparse_attention(q, k, v, layout, block: int, causal: bool = False, scale: Optional[float] = None,
                                 impl: Optional[str] = None) -> torch.Tensor:
    """Fused block-sparse attention over the layout's live blocks,
    differentiable in q, k and v.

    ``q``, ``k``, ``v``: ``[B, NH, T, D]``; ``layout``: ``[NH or 1, T/block,
    T/block]`` bool. T must be divisible by ``block`` and ``block`` a multiple
    of 8 (the JAX package's rules, ``ValueError`` otherwise). A shared layout
    (leading dim 1) folds heads into the batch; per-head layouts make one call
    per head (different live lists), as JAX does."""
    B, NH, T, D = q.shape
    if T % block:
        raise ValueError(f"seq len {T} not divisible by block {block}")
    if block % 8:
        raise ValueError(f"block {block} must be a multiple of 8 (TPU sublanes)")
    scale_f = float(scale) if scale is not None else 1.0 / float(np.sqrt(D))
    layout = np.asarray(layout, dtype=bool)

    def run(qbn, kbn, vbn, layout_h):
        tables = block_tables(layout_h, qbn.device)
        units = None
        if _use_kernel(qbn, impl):
            units = (fwd_units(layout_h, block, qbn.device), dkv_units(layout_h, block, qbn.device))
        return _BlockSparseAttention.apply(qbn.contiguous(), kbn.contiguous(), vbn.contiguous(), tables, units,
                                           scale_f, block, bool(causal), impl)

    if layout.shape[0] == 1:
        fold = lambda x: x.reshape(B * NH, T, D)  # noqa: E731
        return run(fold(q), fold(k), fold(v), layout[0]).reshape(B, NH, T, D)
    return torch.stack([run(q[:, h], k[:, h], v[:, h], layout[h]) for h in range(NH)], dim=1)
