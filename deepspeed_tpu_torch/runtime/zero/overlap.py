"""ZeRO's data movement and its schedule, in eager form.

Counterpart of ``deepspeed_tpu/runtime/zero/overlap.py``. JAX declares the
shardings and its ``OverlapPlan`` pins where XLA gathers each scanned
layer's parameters (``gather_layer``, ahead of use by ``prefetch_layers``)
and where the gradient reduction of a layer runs (``reduce_grads``,
coalesced into ``reduce_bucket_size``-element buckets). The port moves the
data itself, one process a rank:

* **Row layout** (``runtime/comm/coalesced_collectives.py`` in JAX): a
  leaf sharded along dim ``d`` over ``world`` ranks, moved so that ``d``
  leads and flattened, is ``world`` equal rows, row ``r`` being rank
  ``r``'s block. Leaves of one dtype concatenate row-wise into one buffer,
  so a bucket is one all-gather (``gather_full``) or one reduce-scatter
  (``reduce_scatter_full``). Leaves replicated over the ranks reduce by an
  all-reduce.
* **Gradient buckets** (``GradBuckets``): full gradients are reduced in
  buckets of ``reduce_bucket_size`` elements. With ``overlap_comm`` (stage
  >= 2) each leaf joins a bucket the moment backward has accumulated its
  gradient and a full bucket goes out asynchronously while backward runs
  on; without it the buckets go out after backward. Each element's sum is
  the same either way.
* **The stage-3 parameter stream** (``OverlapPlan``): the compute
  parameters are stored sharded; the non-layer leaves are gathered once
  at the start of the forward, and each layer of the stacked ``[L, ...]``
  leaves is gathered just before it runs (``gather_layer``), with
  ``prefetch_layers`` layers issued ahead asynchronously (default 1 when
  ``overlap_comm``; capped by ``stage3_prefetch_bucket_size`` elements in
  flight). Autograd does not keep a layer's gathered weights: saved-tensor
  hooks record them by reference and backward gathers the layer again
  (prefetching the layer below), then frees it. Each gather's backward is
  the reduce-scatter of the layer's gradients into the rank's shard. A
  layer leaf whose sharded dim is the stacked ``L`` dim itself lives whole
  on one rank and is broadcast from it; its gradient is all-reduced and
  the owner keeps it. Under ``remat`` the gather runs inside the
  checkpointed layer, so its recomputation gathers again.

* **The a2a stage** (``A2AStage``, JAX ``overlap.py:102-114``): under an
  ``expert`` axis the plan names the axis the MoE dispatch and combine
  all-to-alls run over (``a2a_axis``, ``a2a_world``) and their wire format
  (``a2a_quantized``, the model config's ``moe_quantized_a2a``; None defers
  to the layer's own knob). The engine makes its plan (or, without a
  stage-3 stream, the stage alone) active around the training forward
  (``activate``), and ``moe/layer.py`` reads it through ``active_plan()``.

Every rank issues the same collectives in the same order: the schedule
depends only on shapes and the layer index.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime.zero.partition import shard_shape


def split_buckets(sizes: Sequence[int], cap: int) -> List[List[int]]:
    """Greedy element-capped grouping of indices in order (JAX
    ``_split_buckets``): every bucket holds at least one item, an oversized
    item rides alone."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_elems = 0
    cap = max(int(cap), 1)
    for i, n in enumerate(sizes):
        if cur and cur_elems + n > cap:
            buckets.append(cur)
            cur, cur_elems = [], 0
        cur.append(i)
        cur_elems += n
    if cur:
        buckets.append(cur)
    return buckets


def _rows(t: torch.Tensor, dim: int, world: int) -> torch.Tensor:
    """``t`` (full) in the row layout: ``[world, numel / world]``."""
    return t.movedim(dim, 0).reshape(world, -1)


def _from_rows(rows: torch.Tensor, full_shape: Tuple[int, ...], dim: int) -> torch.Tensor:
    moved = (full_shape[dim],) + tuple(s for i, s in enumerate(full_shape) if i != dim)
    return rows.reshape(moved).movedim(0, dim).contiguous()


class _Gathered:
    """An all-gather in flight; ``wait()`` returns the full tensors."""

    def __init__(self, work, out, shards, dims, world):
        self.work, self.out, self.shards, self.dims, self.world = work, out, shards, dims, world

    def wait(self) -> List[torch.Tensor]:
        self.work.wait()
        rows = self.out.view(self.world, -1)
        full, off = [], 0
        for s, d in zip(self.shards, self.dims):
            n = s.numel()
            shape = tuple(x * self.world if i == d else x for i, x in enumerate(s.shape))
            full.append(_from_rows(rows[:, off:off + n], shape, d))
            off += n
        return full


def gather_full(shards: Sequence[torch.Tensor], dims: Sequence[int], group=None, async_op: bool = False):
    """Every rank's block of each leaf (``shards[j]``, sharded along
    ``dims[j]``; one dtype) reassembled whole, in one all-gather. Returns
    the full tensors, or with ``async_op`` a handle whose ``wait()`` does."""
    world = comm.get_world_size(group)
    send = torch.cat([s.detach().movedim(d, 0).reshape(-1) for s, d in zip(shards, dims)])
    out = torch.empty(world * send.numel(), dtype=send.dtype, device=send.device)
    work = comm.all_gather_into_tensor(out, send, group=group, async_op=True)
    pending = _Gathered(work, out, list(shards), list(dims), world)
    return pending if async_op else pending.wait()


class _Scattered:
    """A reduce-scatter (or all-reduce) in flight; ``wait()`` returns this
    rank's block of each reduced leaf."""

    def __init__(self, work, out, shapes, dims, world):
        self.work, self.out, self.shapes, self.dims, self.world = work, out, shapes, dims, world

    def wait(self) -> List[torch.Tensor]:
        self.work.wait()
        res, off = [], 0
        for shape, d in zip(self.shapes, self.dims):
            if d is None:
                n = math.prod(shape)
                res.append(self.out[off:off + n].view(shape))
            else:
                sh = shard_shape(shape, d, self.world)
                n = math.prod(sh)
                res.append(_from_rows(self.out[off:off + n], sh, d))
            off += n
        return res


def reduce_scatter_full(grads: Sequence[torch.Tensor], dims: Sequence[Optional[int]], group=None,
                        async_op: bool = False):
    """The sum across the group of each full gradient, this rank's block of
    it along ``dims[j]`` (the whole sum where ``dims[j]`` is None). A
    bucket is all sharded or all replicated, of one dtype: one
    reduce-scatter, or one all-reduce."""
    world = comm.get_world_size(group)
    shapes = [tuple(g.shape) for g in grads]
    if all(d is None for d in dims):
        flat = torch.cat([g.reshape(-1) for g in grads])
        work = comm.all_reduce(flat, group=group, async_op=True)
        pending = _Scattered(work, flat, shapes, list(dims), world)
    else:
        send = torch.cat([_rows(g, d, world) for g, d in zip(grads, dims)], dim=1)
        out = torch.empty(send.shape[1], dtype=send.dtype, device=send.device)
        work = comm.reduce_scatter_tensor(out, send.reshape(-1), group=group, async_op=True)
        pending = _Scattered(work, out, shapes, list(dims), world)
    return pending if async_op else pending.wait()


class GradBuckets:
    """Full gradients reduced into ``bucket_elems``-element buckets (see the
    module docstring). ``add`` queues one leaf's gradient; with ``eager`` a
    full bucket is sent at once (asynchronously); ``finish`` sends the rest
    and returns ``{name: reduced}`` (this rank's block, or the whole sum
    for a replicated leaf)."""

    def __init__(self, dims: Dict[str, Optional[int]], bucket_elems: int, eager: bool, group=None):
        self.dims, self.cap, self.eager, self.group = dims, max(int(bucket_elems), 1), eager, group
        self._open: Dict[Tuple, List[Tuple[str, torch.Tensor]]] = {}
        self._sent: List[Tuple[List[str], object]] = []

    def add(self, name: str, grad: torch.Tensor) -> None:
        key = (grad.dtype, self.dims[name] is None)
        bucket = self._open.setdefault(key, [])
        if bucket and sum(g.numel() for _, g in bucket) + grad.numel() > self.cap:
            self._send(key)
            bucket = self._open.setdefault(key, [])
        bucket.append((name, grad))
        if self.eager and sum(g.numel() for _, g in bucket) >= self.cap:
            self._send(key)

    def _send(self, key) -> None:
        bucket = self._open.pop(key, [])
        if bucket:
            names = [n for n, _ in bucket]
            work = reduce_scatter_full([g for _, g in bucket], [self.dims[n] for n in names], self.group,
                                       async_op=True)
            self._sent.append((names, work))

    def finish(self) -> Dict[str, torch.Tensor]:
        for key in list(self._open):
            self._send(key)
        out = {}
        for names, work in self._sent:
            out.update(zip(names, work.wait()))
        self._sent = []
        return out


class _GatherFn(torch.autograd.Function):
    """Forward: the plan's gathered tensors of one key (a layer, or the
    non-layer leaves). Backward: their gradients reduced across the ranks
    into the plan (``OverlapPlan.reduce_key``). ``anchor``, a scalar that
    requires grad, is the node's one input, the same on every rank."""

    @staticmethod
    def forward(ctx, plan, key, anchor):  # noqa: ARG004
        ctx.plan, ctx.key = plan, key
        return tuple(plan.take(key))

    @staticmethod
    def backward(ctx, *grads):
        ctx.plan.reduce_key(ctx.key, grads)
        return None, None, None


class A2AStage:
    """The expert-parallel a2a stage of a plan (JAX ``overlap.py:102-114``):
    the axis the MoE dispatch and combine all-to-alls run over, its size,
    and their wire format (None: the layer's own ``quantized_a2a``)."""

    a2a_axis: Optional[str] = None
    a2a_world: int = 1
    a2a_quantized: Optional[bool] = None

    def set_a2a(self, topo, moe_quantized_a2a: Optional[bool] = None) -> "A2AStage":
        """Armed when the topology has a real expert axis (JAX
        ``overlap.py:339-343``)."""
        world = int(topo.axis_size("expert")) if topo is not None else 1
        self.a2a_axis = "expert" if world > 1 else None
        self.a2a_world = world
        self.a2a_quantized = moe_quantized_a2a
        return self

    @property
    def a2a_enabled(self) -> bool:
        return self.a2a_axis is not None and self.a2a_world > 1


_ACTIVE: List[A2AStage] = []


def active_plan() -> Optional[A2AStage]:
    """The plan (or a2a stage) of the engine whose forward is running."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def activate(plan: Optional[A2AStage]):
    """Make ``plan`` the active one within the block (nothing for None)."""
    if plan is None:
        yield
        return
    _ACTIVE.append(plan)
    try:
        yield
    finally:
        _ACTIVE.pop()


class OverlapPlan(A2AStage):
    """The stage-3 parameter stream of one engine (see the module
    docstring). ``params`` is the engine's compute store (shards and
    replicated leaves), ``dims`` each leaf's sharded dim (None:
    replicated), ``depth`` the layers gathered ahead of use."""

    def __init__(self, params: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]], num_layers: int,
                 depth: int, reduce_dtype: torch.dtype = torch.float32, group=None):
        self.params, self.dims, self.L, self.depth, self.group = params, dims, num_layers, depth, group
        self.reduce_dtype = reduce_dtype
        self.reduced: Dict[object, Dict[str, torch.Tensor]] = {}
        self.in_backward = False  # set by the engine around loss.backward()
        self.world, self.rank = comm.get_world_size(group), comm.get_rank(group)
        self.layer_keys = [k for k in params if k.startswith("layers/")]
        self.top_gathered = [k for k in params if not k.startswith("layers/") and dims[k] is not None]
        # layer leaves: gathered along a per-layer dim (d - 1), or owned whole (d == 0)
        self.layer_gathered = [k for k in self.layer_keys if dims[k] not in (None, 0)]
        self.layer_owned = [k for k in self.layer_keys if dims[k] == 0]
        self.anchor = torch.zeros((), device=next(iter(params.values())).device, requires_grad=True)
        self._pending: Dict[object, object] = {}
        self._pieces: Dict[str, Tuple[torch.Tensor, ...]] = {}
        self._bwd: Dict[int, Dict[str, torch.Tensor]] = {}

    # --- what a key gathers ---------------------------------------------------
    def _owner(self, i: int) -> Tuple[int, int]:
        per = self.L // self.world
        return i // per, i % per

    def _launch(self, key):
        """Issue the collectives of ``key`` asynchronously (one all-gather
        of its sharded pieces, one broadcast of its owned layer leaves)."""
        if key == "top":
            names = self.top_gathered
            return names, [], gather_full([self.params[k] for k in names], [self.dims[k] for k in names],
                                          self.group, async_op=True) if names else None, None
        i = key
        got = None
        if self.layer_gathered:
            got = gather_full([self.params[k][i] for k in self.layer_gathered],
                              [self.dims[k] - 1 for k in self.layer_gathered], self.group, async_op=True)
        owned = None
        if self.layer_owned:
            owner, local = self._owner(i)
            shapes = [tuple(self.params[k].shape[1:]) for k in self.layer_owned]
            ref = self.params[self.layer_owned[0]]
            if self.rank == owner:
                buf = torch.cat([self.params[k][local].detach().reshape(-1) for k in self.layer_owned])
            else:
                buf = torch.empty(sum(math.prod(s) for s in shapes), dtype=ref.dtype, device=ref.device)
            work = comm.broadcast(buf, src=comm.get_global_rank(self.group, owner), group=self.group, async_op=True)
            owned = (work, buf, shapes)
        return self.layer_gathered, self.layer_owned, got, owned

    @staticmethod
    def _finish(launched) -> Dict[str, torch.Tensor]:
        gathered_names, owned_names, got, owned = launched
        out = dict(zip(gathered_names, got.wait())) if got is not None else {}
        if owned is not None:
            work, buf, shapes = owned
            work.wait()
            off = 0
            for k, shape in zip(owned_names, shapes):
                n = math.prod(shape)
                out[k] = buf[off:off + n].view(shape).clone()  # one storage a leaf (the hooks key on it)
                off += n
        return out

    def prefetch(self, i: int) -> None:
        if i not in self._pending and 0 <= i < self.L:
            self._pending[i] = self._launch(i)

    def take(self, key) -> List[torch.Tensor]:
        """The gathered tensors of ``key``, in ``_names(key)`` order."""
        launched = self._pending.pop(key, None)
        if launched is None:
            launched = self._launch(key)
        got = self._finish(launched)
        return [got[k] for k in self._names(key)]

    def _names(self, key) -> List[str]:
        return self.top_gathered if key == "top" else self.layer_gathered + self.layer_owned

    # --- backward ---------------------------------------------------------------
    def reduce_key(self, key, grads) -> None:
        """The gradients of ``key``'s gathered tensors (None: unused, a zero
        gradient), in ``reduce_dtype``, summed across the ranks; this
        rank's piece of each is kept for ``collect_grads`` (none where it
        owns no piece)."""
        names = self._names(key)
        grads = [torch.zeros(like.shape, dtype=self.reduce_dtype, device=like.device) if g is None
                 else g.to(self.reduce_dtype) for g, like in zip(grads, self._like(key, names))]
        got = self.reduced.setdefault(key, {})
        n_gathered = len(self.top_gathered) if key == "top" else len(self.layer_gathered)
        if n_gathered:
            dims = [self.dims[k] - (0 if key == "top" else 1) for k in names[:n_gathered]]
            got.update(zip(names[:n_gathered], reduce_scatter_full(grads[:n_gathered], dims, self.group)))
        if key != "top" and self.layer_owned:
            owner, _ = self._owner(key)
            flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads[n_gathered:]]), group=self.group)
            off = 0
            for k, g in zip(names[n_gathered:], grads[n_gathered:]):
                if self.rank == owner:
                    got[k] = flat[off:off + g.numel()].view(g.shape)
                off += g.numel()

    def collect_grads(self) -> Dict[str, torch.Tensor]:
        """This rank's reduced gradient of every sharded leaf, in the
        shape of its shard (the layers' pieces stacked), and forget them."""
        out = {k: self.reduced["top"][k] for k in self.top_gathered if k in self.reduced.get("top", {})}
        for k in self.layer_gathered:
            out[k] = torch.stack([self.reduced[i][k] for i in range(self.L)])
        if self.layer_owned:
            mine = [i for i in range(self.L) if self._owner(i)[0] == self.rank]
            for k in self.layer_owned:
                out[k] = torch.stack([self.reduced[i][k] for i in mine])
        self.reduced = {}
        return out

    def _like(self, key, names) -> List[torch.Tensor]:
        """Empty tensors of the full shapes of ``key``'s gathered leaves."""
        res = []
        for k in names:
            p = self.params[k]
            d = self.dims[k]
            shape = list(p.shape) if key == "top" else list(p.shape[1:])
            if key == "top":
                shape[d] *= self.world
            elif d > 0:
                shape[d - 1] *= self.world
            res.append(torch.empty(shape, dtype=p.dtype, device=p.device))
        return res

    def regather(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s weights again for its backward (cached while the
        backward of that layer runs; the layer below prefetched)."""
        got = self._bwd.get(i)
        if got is None:
            self._bwd.clear()
            launched = self._pending.pop(("bwd", i), None) or self._launch(i)
            got = self._bwd[i] = self._finish(launched)
            if self.depth > 0 and i > 0 and ("bwd", i - 1) not in self._pending:
                self._pending[("bwd", i - 1)] = self._launch(i - 1)
        return got

    # --- the forward's entry points ---------------------------------------------
    def begin(self, train: bool) -> Dict[str, torch.Tensor]:
        """Start a forward: the whole non-layer leaves (gathered), and the
        stacked layer leaves unbound once into per-layer pieces."""
        self._pending.clear()
        self._bwd.clear()
        self._pieces = {k: self.params[k].unbind(0) for k in self.layer_keys}
        top = {k: p for k, p in self.params.items() if not k.startswith("layers/")}
        if self.top_gathered:
            grad = train and torch.is_grad_enabled()
            full = _GatherFn.apply(self, "top", self.anchor) if grad else self.take("top")
            top.update(zip(self.top_gathered, full))
        if self.depth > 0:
            for j in range(min(self.depth, self.L)):
                self.prefetch(j)
        return top

    def end_backward(self) -> None:
        """Drop what backward gathered (called after ``loss.backward()``)."""
        self._bwd.clear()
        for key in [k for k in self._pending if isinstance(k, tuple)]:
            self._finish(self._pending.pop(key))

    def _gathered_layer(self, i: int, grad: bool) -> Dict[str, torch.Tensor]:
        names = self._names(i)
        full = _GatherFn.apply(self, i, self.anchor) if grad else self.take(i)
        per = dict(zip(names, full))
        for k in self.layer_keys:
            if k not in per:  # replicated: this rank's own (whole) leaf
                per[k] = self._pieces[k][i]
        if not self.in_backward:  # a remat recomputation prefetches nothing
            for j in range(i + 1, min(i + 1 + self.depth, self.L)):
                self.prefetch(j)
        return {k.split("/", 1)[1]: v for k, v in per.items()}

    def run(self, i: int, fn: Callable, x: torch.Tensor, remat: bool):
        """Layer ``i``: ``fn(x, per_layer_weights)`` on the gathered weights
        (what ``fn`` returns: the block's output and its MoE loss)."""
        grad = torch.is_grad_enabled()
        if remat and grad:
            return checkpoint(lambda h: fn(h, _nest(self._gathered_layer(i, True))), x, use_reentrant=False)
        per = self._gathered_layer(i, grad)
        if not grad:
            return fn(x, _nest(per))
        gathered = set(self._names(i))
        ptrs = {per[k.split("/", 1)[1]].untyped_storage().data_ptr(): k.split("/", 1)[1] for k in gathered}

        def pack(t):
            name = ptrs.get(t.untyped_storage().data_ptr()) if t.layout == torch.strided else None
            if name is None:
                return t
            return (i, name, tuple(t.shape), t.stride(), t.storage_offset())

        def unpack(obj):
            if not isinstance(obj, tuple):
                return obj
            j, name, shape, stride, offset = obj
            return self.regather(j)["layers/" + name].as_strided(shape, stride, offset)

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            return fn(x, _nest(per))


def _nest(per: Dict[str, torch.Tensor]) -> Dict:
    """A layer's ``name -> tensor`` leaves as the nested tree the block
    reads (an MoE layer's ``moe/...`` leaves under ``moe``)."""
    out: Dict = {}
    for path, t in per.items():
        node = out
        *heads, name = path.split("/")
        for head in heads:
            node = node.setdefault(head, {})
        node[name] = t
    return out


def build_overlap_plan(zero_config, params: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]],
                       num_layers: int, reduce_dtype: torch.dtype = torch.float32, group=None, topo=None,
                       moe_quantized_a2a: Optional[bool] = None) -> Optional[OverlapPlan]:
    """The stage-3 stream, or None when nothing of the compute store is
    sharded. ``prefetch_layers`` None takes one layer of lookahead under
    ``overlap_comm`` (JAX's default), 0 gathers at use; the depth is capped
    so that the layers in flight hold at most ``stage3_prefetch_bucket_size``
    elements (never below one layer)."""
    if int(zero_config.stage) < 3 or all(d is None for d in dims.values()):
        return None
    depth = zero_config.prefetch_layers
    if depth is None:
        depth = 1 if zero_config.overlap_comm else 0
    depth = min(int(depth), int(num_layers))
    per_layer = sum(math.prod(params[k].shape[1:]) for k in params
                    if k.startswith("layers/") and dims[k] is not None)
    budget = int(zero_config.prefetch_bucket_size)
    if budget > 0 and per_layer > 0:
        while depth > 1 and depth * per_layer > budget:
            depth -= 1
    plan = OverlapPlan(params, dims, num_layers, depth, reduce_dtype, group)
    plan.set_a2a(topo, moe_quantized_a2a)
    return plan
