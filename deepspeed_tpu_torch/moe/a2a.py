"""The expert-parallel exchange: the MoE fast path across ranks.

Counterpart of ``deepspeed_tpu/moe/a2a.py``. JAX runs it under
``shard_map`` over the ``expert`` mesh axis; the port runs one process a
rank and does each shard's part itself:

* **Per-shard gating** (``ep_gate_dispatch``): each rank gates its own
  token shard against the local capacity ``ceil(S_local/E · cf)`` (with
  ``min_capacity``), so drops depend on the shard's tokens alone, and
  dispatches it into a local ``[E, C_l, H]`` buffer.
* **The dispatch and combine all-to-alls** (``exchange_shard``): one
  ``all_to_all_single`` over the expert group maps ``[E, C_l, H]`` to
  ``[E/e, e·C_l, H]``, the received blocks concatenated on the capacity
  dim in source-rank order (JAX's ``lax.all_to_all(..., split_axis=0,
  concat_axis=1, tiled=True)``); the combine is the inverse exchange, and
  the backward pass of each direction is the other direction.
* **The int8 wire** (``quantized_all_to_all``, JAX ``a2a.py:101-135``):
  one fp32 scale ``max(|row|, 1e-30)/127`` per (expert, slot) row, codes
  rounded half to even and clipped to ±127, two exchanges (codes and
  scales), decoded into the input dtype; the cotangent takes the inverse
  exchange in the same wire format. It is plain torch in both packages:
  no kernel.

``ep_fast_path`` is JAX's condition for taking this path. Where it does
not hold with tokens spread over ranks (data parallelism without an
expert axis), the layer gates the global batch as JAX's GSPMD program
does: ``gather_rows`` all-gathers the router logits and hands each rank
back the gradient of its own rows. The inference engine's forward holds
the whole batch on every rank and says so (``MoE.apply(...,
replicated=True)``); each rank then takes its shard at the layer
(``token_shard``) and all-gathers the shards' outputs after the combine.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.moe import sharded_moe

EXPERT_AXIS = "expert"

_SCALE_FLOOR = 1e-30  # an all-zero row must not divide by zero


def token_shard_axes(topo) -> Tuple[str, ...]:
    """Mesh axes the flattened ``[S, H]`` token dim is sharded over: the
    batch axes, then ``sequence`` (JAX ``a2a.py:61-70``)."""
    axes = [a for a in ("data_outer", "data", EXPERT_AXIS) if topo.axis_size(a) > 1]
    if topo.axis_size("sequence") > 1:
        axes.append("sequence")
    return tuple(axes)


def num_token_shards(topo) -> int:
    return math.prod(topo.axis_size(a) for a in token_shard_axes(topo))


def ep_fast_path(topo, num_experts: int, num_tokens: int) -> bool:
    """True when the expert-parallel path applies (JAX ``a2a.py:80-89``):
    a real expert axis that divides the expert count, and token shards of
    equal size (``num_tokens`` is the global count)."""
    if topo is None:
        return False
    e = topo.axis_size(EXPERT_AXIS)
    if e <= 1 or num_experts % e:
        return False
    n = num_token_shards(topo)
    return n > 1 and num_tokens % n == 0


def token_shard(tokens: torch.Tensor, topo) -> torch.Tensor:
    """This rank's shard of replicated ``[S, H]`` tokens: the rank-th of
    ``n`` contiguous row blocks (the token axes span the world)."""
    n = num_token_shards(topo)
    s = tokens.shape[0] // n
    return tokens[topo.rank * s:(topo.rank + 1) * s]


# --- collectives with their autograd duals ------------------------------------
def _all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int, group) -> torch.Tensor:
    """``x`` split into ``e`` blocks along ``split_axis``, block ``j`` sent
    to rank ``j`` of ``group``, the received blocks concatenated along
    ``concat_axis`` in source-rank order."""
    e = comm.get_world_size(group)
    if e == 1:
        return x
    send = torch.stack(x.chunk(e, dim=split_axis))
    recv = torch.empty_like(send)
    comm.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def _wire(x: torch.Tensor, split_axis: int, concat_axis: int, group, quantized: bool) -> torch.Tensor:
    if not quantized:
        return _all_to_all(x, split_axis, concat_axis, group)
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    # a tensor divisor: PyTorch turns a CUDA division by a Python scalar into a multiply by its reciprocal
    scale = torch.clamp(amax, min=_SCALE_FLOOR) / torch.full_like(amax, 127.0)  # [E, C, 1] side channel
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    qx = _all_to_all(q, split_axis, concat_axis, group)
    sx = _all_to_all(scale, split_axis, concat_axis, group)
    return (qx.float() * sx).to(x.dtype)


class _Exchange(torch.autograd.Function):
    """The exchange in one direction; its backward is the exchange in the
    other, in the same wire format."""

    @staticmethod
    def forward(ctx, x, split_axis: int, concat_axis: int, group, quantized: bool):
        ctx.args = (split_axis, concat_axis, group, quantized)
        return _wire(x, split_axis, concat_axis, group, quantized)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, group, quantized = ctx.args
        return _wire(g.contiguous(), concat_axis, split_axis, group, quantized), None, None, None, None


def quantized_all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int, group=None) -> torch.Tensor:
    """The all-to-all with JAX's int8 wire format, forward and backward."""
    return _Exchange.apply(x, split_axis, concat_axis, group, True)


def exchange_shard(x: torch.Tensor, topo, *, inverse: bool = False, quantized: bool = False) -> torch.Tensor:
    """``[E, C, H] ↔ [E/e, e·C, H]`` over the expert group: dispatch
    (``inverse=False``: split the experts, gather the capacity) or combine
    (``inverse=True``)."""
    split, concat = (1, 0) if inverse else (0, 1)
    return _Exchange.apply(x, split, concat, topo.expert_group, quantized)


class _GatherRows(torch.autograd.Function):
    """Every rank's ``x`` concatenated along dim 0 in rank order; the
    backward hands each rank the gradient of its own rows."""

    @staticmethod
    def forward(ctx, x, group):
        world = comm.get_world_size(group)
        ctx.rows = x.shape[0]
        ctx.rank = comm.get_rank(group)
        out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
        comm.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """``_GatherRows`` (the identity over one rank)."""
    if comm.get_world_size(group) == 1:
        return x
    return _GatherRows.apply(x, group)


# --- the per-rank halves of the fast path ---------------------------------------------
def ep_gate_dispatch(tokens: torch.Tensor, logits: torch.Tensor, topo, *, k: int, capacity_factor: float,
                     min_capacity: int, drop_tokens: bool = True, use_rts: bool = True,
                     noisy_gate_policy: Optional[str] = None, gumbel: Optional[torch.Tensor] = None,
                     rts_perm: Optional[torch.Tensor] = None, used_token_mask: Optional[torch.Tensor] = None,
                     quantized: bool = False):
    """This rank's gating of its token shard (``tokens [S_l, H]``,
    ``logits [S_l, E]``) at the local capacity, the dispatch into ``[E,
    C_l, H]`` and the dispatch all-to-all. Returns ``(dispatched [E/e,
    e·C_l, H], routing, l_aux, exp_counts)``: the shard's own load-balance
    loss and routed-token counts (the layer means and sums them)."""
    r = sharded_moe.topk_routing(logits, k, capacity_factor, min_capacity, drop_tokens=drop_tokens,
                                 noisy_gate_policy=noisy_gate_policy, use_rts=use_rts,
                                 used_token_mask=used_token_mask, gumbel=gumbel, rts_perm=rts_perm)
    d = exchange_shard(sharded_moe.dispatch(tokens, r), topo, quantized=quantized)
    return d, r, r.l_aux, r.exp_counts


def ep_combine(expert_out: torch.Tensor, routing: sharded_moe.Routing, topo, *,
               quantized: bool = False) -> torch.Tensor:
    """The combine all-to-all and the weighted un-dispatch: ``[E/e, e·C_l,
    H]`` expert outputs to this shard's ``[S_l, H]``."""
    return sharded_moe.combine(exchange_shard(expert_out, topo, inverse=True, quantized=quantized), routing)
