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
trace time). ``build_dkv_units`` turns the column lists into K9's work
list for the tensor-core variant: 16-row key tiles, grouped four to a
unit where their key blocks list the same q blocks, and lists longer than
``dkv_cap`` cut into chunks whose fp32 partials are summed in chunk order;
``dkv_units`` keeps them per (layout, block, device).
``fused_block_sparse_attention(q, k, v, layout, block, causal, scale)`` is
the counterpart of ``pallas_block_sparse_attention`` (``:316``):
``[B, NH, T, D]`` inputs, a shared layout (leading dim 1) folds heads into
the batch, per-head layouts make one call per head. It is differentiable: a
``torch.autograd.Function`` whose forward runs K7 and saves ``(q, k, v, o,
lse)`` and the tables, and whose backward computes Δ in fp32 with plain torch
ops (JAX computes it in XLA outside the kernels, ``:232``) and runs K8 and
K9. LSE is a plain ``[B·NH, T]`` fp32 array (``[BN, T, 128]`` lane-broadcast
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

K9 has two variants in the CUDA source, chosen by dtype: bf16 and fp16 run
on the tensor cores (``mma.sync``; P and dS enter their products as hi + lo
pairs in the input dtype, so the fp32 numerics hold to about 2⁻¹⁶), fp32
keeps the FMA kernel as the card's parity path. ``launches_fwd``,
``launches_dq`` and ``launches_dkv`` count the kernels' calls and nothing
else (K9's reduction pass is part of its call); ``launches_dkv_tc`` counts
the K9 calls that the CUDA entry reports as the tensor-core variant.
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

DKV_WARPS = 4  # key tiles of a K9 unit (one warp each)
DKV_TILE = 16  # rows of a K9 key tile

launches_fwd = 0  # K7 launches since the caller last set it to 0
launches_dq = 0  # K8
launches_dkv = 0  # K9 calls (its reduction pass included)
launches_dkv_tc = 0  # of those, calls of the tensor-core variant (bf16, fp16)

_entries = {}
_tables = {}  # (layout shape, layout bytes, device) -> (row_idx, row_cnt, col_idx, col_cnt)
_units = {}  # (layout shape, layout bytes, block, device) -> DkvUnits
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


class DkvUnits(NamedTuple):
    """K9's work list for one (layout, block): ``units`` int32 ``[U, 3 + 2 ·
    DKV_WARPS]`` rows of (list key block, start, length, key-tile starts,
    workspace slots), heaviest first; ``reduce`` int32 ``[R, 3]`` rows of
    (key block, first slot, chunks) for the split key blocks; the workspace's
    slots; the chunk cap; the block; the number of key blocks."""

    units: object
    reduce: object
    n_slots: int
    cap: int
    block: int
    n_kb: int


def dkv_cap(col_cnt: np.ndarray) -> int:
    """Longest column-list chunk K9 takes as one unit: twice the mean list
    length, at least 8. The heavy columns of a layout (a global key column
    lists every q block) are cut to about the length of an average one, so
    no single unit outlasts the rest of the launch."""
    mean = float(np.mean(col_cnt)) if np.size(col_cnt) else 0.0
    return max(8, int(np.ceil(2.0 * mean)))


def build_dkv_units(layout_h: np.ndarray, block: int) -> DkvUnits:
    """K9's units for a ``[nq, nk]`` layout at this block size, in numpy.

    Each key block is cut into ``DKV_TILE``-row key tiles (the last one
    partial when ``block`` is not a multiple of 16). Key blocks whose column
    lists are equal are grouped, so that a unit's warps share each staged
    Q/dO tile. A list longer than ``dkv_cap`` is cut into balanced chunks of
    at most the cap; each chunk of a split key block writes fp32 partials to
    its own workspace slot, and the reduction sums a block's slots in chunk
    order (deterministic). A unit is (the list's key block, chunk start,
    chunk length, up to ``DKV_WARPS`` key-tile start rows, their slots or -1
    where the unit owns the whole list); unused warps carry -1. Units are
    ordered by chunk length, longest first. A key block with an empty list
    still has a unit of length 0, which writes its zero dK and dV."""
    _, _, col_idx, col_cnt = build_block_tables(layout_h)
    cap = dkv_cap(col_cnt)
    subs = -(-block // DKV_TILE)
    groups = {}
    for kb in range(col_cnt.shape[0]):
        groups.setdefault(tuple(col_idx[kb, : col_cnt[kb]].tolist()), []).append(kb)
    units, reduce, n_slots = [], [], 0
    for lst, kbs in groups.items():
        n_chunks = max(1, -(-len(lst) // cap))
        bounds = [len(lst) * c // n_chunks for c in range(n_chunks + 1)]
        base = {}
        if n_chunks > 1:
            for kb in kbs:
                base[kb] = n_slots
                reduce.append((kb, n_slots, n_chunks))
                n_slots += n_chunks
        tiles = [(kb, kb * block + DKV_TILE * sub) for kb in kbs for sub in range(subs)]
        for c in range(n_chunks):
            for i in range(0, len(tiles), DKV_WARPS):
                grp = tiles[i: i + DKV_WARPS]
                pad = [-1] * (DKV_WARPS - len(grp))
                units.append([kbs[0], bounds[c], bounds[c + 1] - bounds[c]] + [t for _, t in grp] + pad
                             + [base[kb] + c if n_chunks > 1 else -1 for kb, _ in grp] + pad)
    units = np.asarray(units, dtype=np.int32).reshape(-1, 3 + 2 * DKV_WARPS)
    units = units[np.argsort(-units[:, 2], kind="stable")]
    reduce = np.asarray(reduce, dtype=np.int32).reshape(-1, 3)
    return DkvUnits(units, reduce, n_slots, cap, block, col_cnt.shape[0])


def dkv_units(layout_h: np.ndarray, block: int, device) -> DkvUnits:
    """``build_dkv_units`` with its tables as int32 tensors on ``device``,
    built once per (layout, block, device) and kept."""
    layout_h = np.ascontiguousarray(np.asarray(layout_h, dtype=bool))
    device = torch.device(device)
    key = (layout_h.shape, layout_h.tobytes(), int(block), str(device))
    found = _units.get(key)
    if found is None:
        if len(_units) >= _TABLE_CACHE_SIZE:
            _units.clear()
        built = build_dkv_units(layout_h, int(block))
        found = _units[key] = built._replace(units=torch.from_numpy(built.units).to(device),
                                             reduce=torch.from_numpy(built.reduce).to(device))
    return found


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


def sparse_fwd_plain(q, k, v, row_idx, row_cnt, scale: float, blk: int, causal: bool):
    """K7's function on ``[BN, T, D]``: ``(o in q's dtype, lse [BN, T] fp32)``."""
    BN, T, D = q.shape
    s, mask = _row_scores(q, k, row_idx, row_cnt, scale, blk, causal)
    nq, width = row_idx.shape
    s = s.reshape(BN, nq, blk, width * blk)
    mask = mask.reshape(nq, blk, width * blk)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    vg = _blocks(v.float(), blk)[:, row_idx.long()].reshape(BN, nq, width * blk, D)
    o = (torch.einsum("bqik,bqkd->bqid", p, vg) / safe_l).reshape(BN, T, D).to(q.dtype)
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF), m + torch.log(safe_l)).reshape(BN, T)
    return o, lse


def sparse_dq_plain(q, k, v, do, lse, delta, row_idx, row_cnt, scale: float, blk: int, causal: bool):
    """K8's function: dQ in q's dtype. ``lse`` and ``delta`` are ``[BN, T]``
    fp32."""
    BN, T, D = q.shape
    s, mask = _row_scores(q, k, row_idx, row_cnt, scale, blk, causal)
    lse_b = _blocks(lse, blk)[:, :, :, None, None]
    p = torch.exp(s - lse_b).masked_fill(~mask, 0.0)
    vg = _blocks(v.float(), blk)[:, row_idx.long()]
    dp = torch.einsum("bqid,bqljd->bqilj", _blocks(do.float(), blk), vg)
    ds = p * (dp - _blocks(delta, blk)[:, :, :, None, None]) * scale
    kg = _blocks(k.float(), blk)[:, row_idx.long()]
    return torch.einsum("bqilj,bqljd->bqid", ds, kg).reshape(BN, T, D).to(q.dtype)


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
        n_ptrs = {"block_sparse_fwd": 7, "block_sparse_dq": 9, "block_sparse_dkv": 13}[name]
        dkv = name == "block_sparse_dkv"
        fn.argtypes = (
            [ctypes.c_int]  # dtype code
            + [ctypes.c_void_p] * n_ptrs
            + [ctypes.c_int] * (3 if dkv else 0)  # n_units, n_reduce, n_slots
            + [ctypes.c_int] * 6  # width, BN, T, D, blk, causal
            + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
            + ([ctypes.POINTER(ctypes.c_int)] if dkv else [])  # the variant launched
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


def _launch(name: str, q, ptrs, idx, blk: int, causal: bool, scale: float, counts=(), out=()) -> None:
    BN, T, D = q.shape
    fn = _entry(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], *ptrs, *counts, idx.shape[1], BN, T, D, blk, int(bool(causal)),
                 float(scale), stream, *out)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def sparse_fwd_kernel(q, k, v, row_idx, row_cnt, scale: float, blk: int, causal: bool):
    """Launch K7 on the current stream: ``(o, lse)`` as ``sparse_fwd_plain``."""
    global launches_fwd
    _check(q, k, v, blk, (row_idx, row_cnt))
    BN, T, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(BN, T, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    _launch("block_sparse_fwd", q, (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                    row_idx.data_ptr(), row_cnt.data_ptr()), row_idx, blk, causal, scale)
    launches_fwd += 1
    return o, lse


def sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, scale: float, blk: int, causal: bool):
    """Launch K8: dQ as ``sparse_dq_plain``."""
    global launches_dq
    _check(q, k, v, blk, (row_idx, row_cnt), ("do", do), ("lse", lse), ("delta", delta))
    _check_residuals(q, do, lse, delta)
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    _launch("block_sparse_dq", q, (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                   delta.data_ptr(), dq.data_ptr(), row_idx.data_ptr(), row_cnt.data_ptr()),
            row_idx, blk, causal, scale)
    launches_dq += 1
    return dq


def _check_units(units: DkvUnits, q, blk: int):
    T = q.shape[1]
    if not isinstance(units, DkvUnits) or units.block != blk or units.n_kb != T // blk or \
            units.units.device != q.device or units.reduce.device != q.device:
        raise ValueError(f"K9 needs the unit tables of this layout at block {blk} on {q.device} "
                         f"(dkv_units(layout, {blk}, device))")


def sparse_dkv_kernel(q, k, v, do, lse, delta, col_idx, col_cnt, units: DkvUnits, scale: float, blk: int,
                      causal: bool):
    """Launch K9: ``(dK, dV)`` as ``sparse_dkv_plain``. ``units`` is
    ``dkv_units(layout, blk, device)`` of the layout whose column tables
    these are: the tensor-core variant (bf16, fp16) walks them and, where the
    layout has split key blocks, sums their fp32 partials from a workspace
    allocated here; fp32 takes the FMA variant and ignores them."""
    global launches_dkv, launches_dkv_tc
    _check(q, k, v, blk, (col_idx, col_cnt), ("do", do), ("lse", lse), ("delta", delta))
    _check_residuals(q, do, lse, delta)
    _check_units(units, q, blk)
    BN, T, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    ws = None
    if q.dtype != torch.float32 and units.n_slots:
        ws = torch.empty(BN, units.n_slots, 2, blk, D, dtype=torch.float32, device=q.device)
    variant = ctypes.c_int(-1)
    _launch("block_sparse_dkv", q, (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                    delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), col_idx.data_ptr(),
                                    col_cnt.data_ptr(), units.units.data_ptr(), units.reduce.data_ptr(),
                                    0 if ws is None else ws.data_ptr()), col_idx, blk, causal, scale,
            counts=(units.units.shape[0], units.reduce.shape[0], units.n_slots), out=(ctypes.byref(variant),))
    launches_dkv += 1
    launches_dkv_tc += int(variant.value == 1)
    return dk, dv


# --- dispatch and autograd (``_use_kernel``: the flash module's rule) ----------------
class _BlockSparseAttention(torch.autograd.Function):
    """``_sparse_core`` (``pallas_block_sparse.py:297-313``) on ``[BN, T, D]``."""

    @staticmethod
    def forward(ctx, q, k, v, tables, units, scale: float, blk: int, causal: bool, impl: Optional[str]):
        row_idx, row_cnt, _, _ = tables
        kernel = _use_kernel(q, impl)
        o, lse = (sparse_fwd_kernel if kernel else sparse_fwd_plain)(q, k, v, row_idx, row_cnt, scale, blk, causal)
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
            dq = sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, *args)
            dk, dv = sparse_dkv_kernel(q, k, v, do, lse, delta, col_idx, col_cnt, ctx.units, *args)
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
        units = dkv_units(layout_h, block, qbn.device) if _use_kernel(qbn, impl) else None
        return _BlockSparseAttention.apply(qbn.contiguous(), kbn.contiguous(), vbn.contiguous(), tables, units,
                                           scale_f, block, bool(causal), impl)

    if layout.shape[0] == 1:
        fold = lambda x: x.reshape(B * NH, T, D)  # noqa: E731
        return run(fold(q), fold(k), fold(v), layout[0]).reshape(B, NH, T, D)
    return torch.stack([run(q[:, h], k[:, h], v[:, h], layout[h]) for h in range(NH)], dim=1)
