"""Tensor-parallel serving context: one rank of a sharded model per process.

Counterpart of ``deepspeed_tpu/inference/tp.py``. JAX runs every rank in
one program under ``shard_map`` on a ``model``-axis mesh; the port, like
the reference DeepSpeed, runs one process per rank over
``torch.distributed`` (``deepspeed_tpu_torch.comm``), and each rank runs
the same step body on its own local tensors (JAX's ``shard_program`` has
no counterpart).

* **weight sharding** (``shard_params``): column-parallel
  ``wq wk wv w_gate w_up w_in`` and their biases ``bq bk bv b_in`` (output
  features: a rank holds a contiguous block of heads), row-parallel
  ``wo w_out`` (input features), a vocab-column-parallel LM head (and its
  bias) when the vocabulary divides, everything else (embeddings, norms,
  the row biases) replicated. Int8 leaves (``compression/int8.py``) slice
  codes and scales together: a column weight's scales follow its output
  channels, a row weight's are whole on every rank. The tree is quantized
  before it is sliced, so the scales are global.
* **kv sharding**: the page pools hold ``NKV / tp`` kv heads
  (``local_cfg``); page tables and every other host structure stay whole
  on every rank, and every rank makes the same host decisions.
* **one clock and one check a step**: every rank runs the same host code,
  so every decision must see the same inputs on every rank, or the ranks
  wait in different collectives. ``step_sync`` is the one small
  collective a scheduler step makes: it gathers every rank's (clock
  reading, step fingerprint), raises ``TPDivergence`` when the
  fingerprints (the CRC of the host arrays every step shipped) differ,
  and returns rank 0's reading. ``SharedClock`` is the wall clock a
  server under tp reads (``PagedServer``'s default there): rank 0's
  reading at the last sync, the same value on every rank, so arrivals,
  admission, SLA stamps and timed events decide alike. A virtual clock
  (``utils/loadgen.VirtualClock``) is already the same on every rank.
* **collectives**: each row-parallel projection all-reduces its partial
  sums (``row_matmul``, its output features split into ``comm_chunks``,
  each chunk reduced on its own); ``quantized_allreduce`` swaps the fp
  all-reduce for the EQuARX-style int8 exchange (``quantized_all_reduce``:
  all-to-all, a local fp32 reduce, all-gather); greedy tokens resolve
  through ``argmax``, which all-gathers each rank's (max, global index)
  pair, so every rank picks the first global maximum.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.compression.int8 import QuantizedTensor, qmatmul, slice_out_channels

# the serving layout's classification (models/transformer.py leaf names)
_COLUMN = frozenset({"wq", "wk", "wv", "w_gate", "w_up", "w_in"})
_ROW = frozenset({"wo", "w_out"})
_COLUMN_BIAS = frozenset({"bq", "bk", "bv", "b_in"})
_SCALE_FLOOR = 1e-30
_INT32_MAX = 2**31 - 1


class TPDivergence(RuntimeError):
    """The ranks of a tensor-parallel group shipped different host arrays:
    their schedulers decided differently."""


def serving_tp(server) -> Optional["TPServing"]:
    """The ``TPServing`` of degree > 1 that ``server`` (a ``PagedServer``,
    its ``MultiTenantServer`` front, or a ``FleetRouter``'s replicas) runs
    under, else None."""
    replicas = getattr(server, "replicas", None)
    inners = [h.inner for h in replicas.values()] if replicas is not None else [getattr(server, "server", server)]
    for inner in inners:
        tp = getattr(inner, "tp", None)
        if tp is not None and tp.degree > 1:
            return tp
    return None


class SharedClock:
    """Rank 0's wall clock on every rank of a tensor-parallel group:
    ``clock()`` returns the seconds since the clock was made, as rank 0
    read them at the last ``sync`` (the same value on every rank; 0.0
    before the first). ``sync(fingerprint)`` is ``TPServing.step_sync``
    with this clock's reading."""

    def __init__(self, tp: "TPServing", base: Callable[[], float] = time.perf_counter):
        self.tp, self.base = tp, base
        self._t0 = base()
        self.now = 0.0

    def __call__(self) -> float:
        return self.now

    def sync(self, fingerprint: Optional[int] = None) -> float:
        self.now = self.tp.step_sync(fingerprint, self.base() - self._t0)
        return self.now


def require_ranks(tp_degree: int) -> None:
    """Raise unless a process group of at least ``tp_degree`` ranks is up."""
    if tp_degree < 1:
        raise ValueError(f"tp_degree must be >= 1, got {tp_degree}")
    if tp_degree == 1:
        return
    if not comm.is_initialized():
        raise ValueError(
            f"tensor-parallel degree {tp_degree} needs torch.distributed: call "
            "deepspeed_tpu_torch.comm.init_distributed on every rank first"
        )
    if comm.get_world_size() < tp_degree:
        raise ValueError(f"tp_degree={tp_degree} needs at least that many ranks, have {comm.get_world_size()}")


def serving_group(tp_degree: int):
    """The process group of the first ``tp_degree`` ranks: one
    tensor-parallel serving group (JAX ``serving_mesh``). ``None`` (the
    default group) when that is the whole world. Every rank of the world
    must call it (``torch.distributed.new_group``)."""
    require_ranks(tp_degree)
    if tp_degree == 1 or comm.get_world_size() == tp_degree:
        return None
    return comm.new_group(range(tp_degree))


# --- the quantized all-reduce: comm-free pieces -----------------------------------
def _tensor_div(x: torch.Tensor, d: float) -> torch.Tensor:
    # a tensor divisor: PyTorch turns a CUDA division by a Python scalar into a multiply by its
    # reciprocal, an ulp away from JAX's quotient
    return x / torch.full_like(x, d)


def _int8_codes(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)


def qar_quantize(x: torch.Tensor, degree: int):
    """Stage 1: the last dim of ``x`` split into ``degree`` chunks, as
    ``[degree, ..., F/degree]`` int8 codes with one fp32 scale a chunk,
    ``max|chunk| / 127`` floored at 1e-30 (shape ``[degree, 1, ..., 1]``)."""
    shp = x.shape
    xs = torch.movedim(x.reshape(shp[:-1] + (degree, shp[-1] // degree)), -2, 0).float()
    s = torch.amax(torch.abs(xs), dim=tuple(range(1, xs.ndim)), keepdim=True)
    s = torch.clamp_min(_tensor_div(s, 127.0), _SCALE_FLOOR)
    return _int8_codes(xs, s).contiguous(), s.contiguous()


def qar_reduce(q: torch.Tensor, s: torch.Tensor):
    """Stage 2, on the rank that owns a chunk: every source's codes of it
    (``q [degree, ..., F/degree]``, scales ``s``) dequantized and summed in
    fp32, then re-quantized with one scale: ``(codes, scale)``."""
    y = torch.sum(q.float() * s, dim=0)
    t = torch.clamp_min(_tensor_div(torch.amax(torch.abs(y)), 127.0), _SCALE_FLOOR)
    return _int8_codes(y, t), t


def qar_assemble(qg: torch.Tensor, tg: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Stage 3: every rank's reduced chunk (``qg [degree, ..., F/degree]``,
    scales ``tg [degree]``) back into the input's shape and dtype."""
    yg = qg.float() * tg.reshape((tg.shape[0],) + (1,) * (qg.ndim - 1))
    return torch.movedim(yg, 0, -2).reshape(shape).to(dtype)


def quantized_all_reduce_local(partials: List[torch.Tensor]) -> List[torch.Tensor]:
    """The quantized all-reduce's arithmetic over a list of per-rank
    partials, with the all-to-all and the all-gather done by indexing: what
    each rank's ``quantized_all_reduce`` returns, computed in one process
    (JAX ``tp.py:78-111`` line for line)."""
    degree = len(partials)
    x = partials[0]
    if degree == 1:
        return [x]
    if x.shape[-1] % degree:
        total = partials[0].clone()
        for p in partials[1:]:
            total = total + p
        return [total.clone() for _ in range(degree)]
    stage1 = [qar_quantize(p, degree) for p in partials]
    reduced = [qar_reduce(torch.stack([q[i] for q, _ in stage1]), torch.stack([s[i] for _, s in stage1]))
               for i in range(degree)]
    qg = torch.stack([q for q, _ in reduced])
    tg = torch.stack([t for _, t in reduced])
    return [qar_assemble(qg, tg, x.shape, x.dtype) for _ in range(degree)]


def quantized_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """EQuARX-style quantized all-reduce over ``group``: int8 codes of each
    of ``degree`` chunks of the last dim (one scale a chunk) go
    **all-to-all**, so rank i holds every rank's chunk i; it dequantizes
    and sums them in fp32, re-quantizes the sum, and the reduced chunks are
    **all-gathered**. A plain all-reduce when the last dim does not split
    ``degree`` ways. Within two int8 stages of the exact sum (each
    ``max|chunk| / 254`` elementwise)."""
    degree = comm.get_world_size(group)
    if degree == 1:
        return x
    if x.shape[-1] % degree:
        return comm.all_reduce(x.clone(), group=group)
    q, s = qar_quantize(x, degree)
    q_recv, s_recv = torch.empty_like(q), torch.empty_like(s)
    comm.all_to_all_single(q_recv, q, group=group)
    comm.all_to_all_single(s_recv, s, group=group)
    qy, t = qar_reduce(q_recv, s_recv)
    qg = torch.empty((degree,) + tuple(qy.shape), dtype=qy.dtype, device=qy.device)
    comm.all_gather_into_tensor(qg, qy[None].contiguous(), group=group)
    tg = torch.empty(degree, dtype=t.dtype, device=t.device)
    comm.all_gather_into_tensor(tg, t.reshape(1), group=group)
    return qar_assemble(qg, tg, x.shape, x.dtype)


class TPServing:
    """Tensor-parallel context of one rank: its group, degree and rank,
    the weight layout and the collectives the step bodies call.

    ``group=None`` is the serving group of the first ``degree`` ranks
    (``serving_group``; ``degree`` defaults to the world size). Build it on
    every rank, call ``shard_params`` once (which records the layout), and
    hand it to ``PagedServer(tp=...)``, ``generate(..., tp=...)`` or
    ``TransformerLM.apply(..., tp=...)``. ``degree == 1`` is a valid
    degenerate context (every reduce is the identity) and needs no process
    group."""

    def __init__(self, group=None, quantized_allreduce: bool = False, comm_chunks: int = 2,
                 degree: Optional[int] = None):
        if group is None:
            degree = int(degree if degree is not None else comm.get_world_size())
            group = serving_group(degree)
        else:
            degree = comm.get_world_size(group)
        self.group = group
        self.degree = int(degree)
        if self.degree > 1:
            rank = comm.get_rank()
            group_rank = comm.get_rank(group) if group is not None else rank
            if group_rank < 0:
                raise ValueError(f"rank {rank} is not in the tensor-parallel group of {self.degree} ranks")
            self.rank = group_rank
        else:
            self.rank = 0
        self.quantized_allreduce = bool(quantized_allreduce)
        self.comm_chunks = max(1, int(comm_chunks))
        self.shard_dims = None  # set by shard_params: flat path -> dim this rank slices, or None
        self.head_sharded = False  # vocab-column-parallel LM head in play
        self.quantized_weights = False

    def _src(self, group_rank: int = 0) -> int:
        """The global rank of ``group_rank`` (a broadcast's ``src``)."""
        if self.group is None:
            return group_rank
        return torch.distributed.get_global_rank(self.group, group_rank)

    # --- identity -----------------------------------------------------------
    def cache_key(self):
        return (self.degree, self.quantized_allreduce, self.comm_chunks, self.head_sharded,
                self.quantized_weights)

    # --- config and weights ---------------------------------------------------
    def validate_cfg(self, cfg) -> None:
        if cfg.num_heads % self.degree or cfg.num_kv_heads % self.degree:
            raise ValueError(
                f"tensor-parallel serving shards the head axes: num_heads="
                f"{cfg.num_heads} and num_kv_heads={cfg.num_kv_heads} must "
                f"both divide by tp={self.degree}"
            )

    def local_cfg(self, cfg):
        """This rank's view of the model config: ``NH / tp`` query heads
        against its ``NKV / tp`` kv heads of every page (hidden size,
        head_dim and the GQA group size are unchanged)."""
        if self.degree == 1:
            return cfg
        return dataclasses.replace(cfg, num_heads=cfg.num_heads // self.degree,
                                   num_kv_heads=cfg.num_kv_heads // self.degree)

    def leaf_dim(self, name: str, ndim: int, cfg) -> Optional[int]:
        """The dim this rank slices of a leaf named ``name`` with ``ndim``
        dims (``[L, in, out]`` stacked or ``[in, out]``), or None
        (replicated): JAX ``_leaf_spec``."""
        if name in _COLUMN:
            return ndim - 1
        if name in _ROW:
            return ndim - 2
        if name in _COLUMN_BIAS:
            return ndim - 1
        if name in ("lm_head", "lm_head_bias") and cfg.vocab_size % self.degree == 0:
            return ndim - 1
        return None

    def _slice(self, leaf, dim: int):
        if isinstance(leaf, QuantizedTensor):
            # the scales keep axis -2 as 1: a row weight's scales are whole on every rank
            sdim = dim if dim != leaf.ndim - 2 else None
            return QuantizedTensor(q=self._slice(leaf.q, dim),
                                   scale=leaf.scale if sdim is None else self._slice(leaf.scale, sdim))
        n = leaf.shape[dim] // self.degree
        return leaf.narrow(dim, self.rank * n, n).contiguous()

    def shard_params(self, cfg, params):
        """Validate the config, record the layout (``shard_dims``) and
        return this rank's slice of the tree (nested dicts of tensors or
        ``QuantizedTensor`` leaves, on their own devices); replicated leaves
        are the caller's, unchanged."""
        if self.degree > 1:
            self.validate_cfg(cfg)
        dims = {}

        def walk(prefix, name, tree, whole=False):
            if isinstance(tree, dict):
                # an MoE block runs on the replicated activation: its leaves stay whole on every rank
                return {k: walk(f"{prefix}{k}/", k, v, whole or k in ("moe", "moe_layers")) for k, v in tree.items()}
            path = prefix[:-1]
            dim = None if whole else self.leaf_dim(name, tree.ndim, cfg)
            dims[path] = dim
            if name == "lm_head" and dim is not None:
                self.head_sharded = self.degree > 1
            if isinstance(tree, QuantizedTensor):
                self.quantized_weights = True
            if dim is None or self.degree == 1:
                return tree
            return self._slice(tree, dim)

        out = walk("", "", params)
        self.shard_dims = dims
        return out

    def declared_collectives(self):
        """The collective kinds the serving steps make: the row-parallel
        all-reduces (the quantized exchange's all-to-all and all-gather
        instead, with the plain all-reduce when a projection does not
        split), and the sharded head's argmax all-gather."""
        if self.degree == 1:
            return []
        ops = {"all-reduce"}
        if self.quantized_allreduce:
            ops |= {"all-to-all", "all-gather"}
        if self.head_sharded:
            ops.add("all-gather")
        return sorted(ops)

    # --- the pieces the step bodies call -----------------------------------------
    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum the row-parallel partials across the group (fp all-reduce, or
        the quantized exchange under ``quantized_allreduce``)."""
        if self.degree == 1:
            return x
        if self.quantized_allreduce:
            return quantized_all_reduce(x, self.group)
        return comm.all_reduce(x, group=self.group)

    def row_matmul(self, h: torch.Tensor, w) -> torch.Tensor:
        """Row-parallel projection ``h_local @ w_local`` summed across the
        group; the output features split into ``comm_chunks`` (when they
        divide) and each chunk's partial sum is reduced on its own. The fp
        all-reduces go out asynchronously, so chunk j's reduce is in flight
        while chunk j + 1 multiplies, and all are waited for at the end
        (JAX leaves that overlap to XLA); the quantized exchange reduces
        each chunk in turn."""
        F = (w.q if isinstance(w, QuantizedTensor) else w).shape[-1]
        C = self.comm_chunks if self.comm_chunks > 1 and F % self.comm_chunks == 0 else 1
        if C == 1:
            return self.reduce(qmatmul(h, w))
        step = F // C

        def chunk(j):
            return qmatmul(h, slice_out_channels(w, j * step, step))

        if self.degree == 1 or self.quantized_allreduce:
            return torch.cat([self.reduce(chunk(j)) for j in range(C)], dim=-1)
        parts, works = [], []
        for j in range(C):
            parts.append(chunk(j))
            works.append(comm.all_reduce(parts[j], group=self.group, async_op=True))
        for work in works:
            work.wait()
        return torch.cat(parts, dim=-1)

    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy argmax over (possibly vocab-sharded) logits with
        ``torch.argmax``'s meaning: the first global index of the maximum.
        Each rank all-gathers only its local (max, global index) pair."""
        if self.degree == 1 or not self.head_sharded:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        v_local = logits.shape[-1]
        loc = torch.argmax(logits, dim=-1)
        val = torch.gather(logits, -1, loc[..., None])[..., 0]
        idx = loc + self.rank * v_local
        # one gather of both: fp32 holds the logit (bf16, fp16 or fp32) and an index below 2^24 exactly
        pair = torch.stack([val.float(), idx.float()])
        got = torch.empty((self.degree,) + tuple(pair.shape), dtype=pair.dtype, device=pair.device)
        comm.all_gather_into_tensor(got, pair[None], group=self.group)
        vals, idxs = got[:, 0], got[:, 1]
        best = torch.amax(vals, dim=0)
        cand = torch.where(vals == best, idxs, torch.full_like(idxs, float(_INT32_MAX)))
        return torch.amin(cand, dim=0).to(torch.int32)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """The full-vocabulary logits on every rank (an all-gather of the
        local slices along the last dim); the input when the head is whole."""
        if self.degree == 1 or not self.head_sharded:
            return logits
        parts = comm.all_gather(None, logits.contiguous(), group=self.group)
        return torch.cat(parts, dim=-1)

    def step_sync(self, fingerprint: Optional[int] = None, reading: float = 0.0) -> float:
        """One gather of every rank's ``(reading, fingerprint)``: raises
        ``TPDivergence`` unless the fingerprints agree (None: no check, on
        every rank alike), returns rank 0's reading. fp64 holds a CRC-32
        exactly; the pair rides on the host for gloo, on the card for
        nccl."""
        if self.degree == 1:
            return reading
        dev = torch.device("cuda", torch.cuda.current_device()) if comm.get_backend(self.group) == "nccl" \
            else torch.device("cpu")
        pair = torch.tensor([reading, -1.0 if fingerprint is None else float(fingerprint)], dtype=torch.float64,
                            device=dev)
        got = torch.empty((self.degree, 2), dtype=torch.float64, device=dev)
        comm.all_gather_into_tensor(got, pair[None], group=self.group)
        got = got.cpu()
        prints = got[:, 1].tolist()
        if any(p != prints[0] for p in prints):
            raise TPDivergence(f"tensor-parallel ranks disagree on the step fingerprint: "
                               f"{[f'{int(p) & 0xFFFFFFFF:08x}' for p in prints]}")
        return float(got[0, 0])

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Group rank 0's ``x`` onto every rank, in place."""
        if self.degree == 1:
            return x
        return comm.broadcast(x, src=self._src(0), group=self.group)

    def gather_leaf(self, leaf: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """A leaf sliced along ``dim`` reassembled whole on every rank."""
        if self.degree == 1 or dim is None:
            return leaf
        parts = comm.all_gather(None, leaf.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)


def gather_tree(tp: TPServing, params: Any) -> Any:
    """The whole tree from every rank's ``shard_params`` slice (the layout
    ``tp.shard_dims`` recorded), on every rank."""
    def walk(prefix, tree):
        if isinstance(tree, dict):
            return {k: walk(f"{prefix}{k}/", v) for k, v in tree.items()}
        return tp.gather_leaf(tree, tp.shard_dims.get(prefix[:-1]))

    return walk("", params)
