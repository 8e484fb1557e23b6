"""Top-k gating with capacity, dispatch and combine (the MoE core).

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py``. The gates follow JAX
op for op in fp32: the softmax, the argmax choices (the first maximum on
ties, as ``jnp.argmax``), the load-balance loss ``E · Σ mean(gates) ·
mean(mask1)``, each token's place in its expert's queue (token order, or
Random Token Selection's permutation), the capacity drop and the combine
weights. Every random draw is an argument (``gumbel``, ``rts_perm``; the
jitter in ``multiplicative_jitter``), so tests pass JAX's own noise in and
the model draws it from a device seed (``models/moe_transformer.py``).

JAX dispatches and combines with one-hot einsums over ``[S, E, C]``
(S·E·C·H multiply-adds, more than the experts' own GEMMs at full width).
Here the gates return a ``Routing``: each token's k assignments as
``(expert, slot, weight, kept)``. ``dispatch`` copies each kept token into
its slot (the einsum's value exactly: a slot takes one token);
``combine`` sums each token's k weighted expert rows in fp32 over the
weights cast to the output dtype, as the einsum casts them. ``top1gating``
/ ``top2gating`` / ``topkgating`` return JAX's dense tuple ``(l_aux,
combine_weights [S, E, C], dispatch_mask [S, E, C], exp_counts [E])`` built
from the routing, for the reference surface and the tests.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

_EPS32 = float(torch.finfo(torch.float32).eps)


class Routing(NamedTuple):
    """Each token's k assignments, ``[S, k]`` each: the expert, the slot
    in its capacity, the combine weight (fp32; 0 where not kept) and
    whether the assignment holds a slot (JAX's ``combine_weights > 0``)."""

    expert: torch.Tensor
    slot: torch.Tensor
    weight: torch.Tensor
    kept: torch.Tensor
    capacity: int
    num_experts: int
    l_aux: torch.Tensor
    exp_counts: torch.Tensor


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float, min_capacity: int) -> int:
    """Tokens per expert (JAX ``_capacity``)."""
    return max(math.ceil(num_tokens / num_experts * capacity_factor), min_capacity)


def multiplicative_jitter(x: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
    """The 'Jitter' gate policy: ``x`` times ``noise`` (uniform in ``[1 -
    eps, 1 + eps]``, fp32, drawn by the caller) in ``x``'s dtype."""
    return x if noise is None else x * noise.to(x.dtype)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms in ``(0, 1)``."""
    return -torch.log(-torch.log(u))


def _one_hot(indices: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot rows (a comparison: ``F.one_hot`` checks its input's
    range on the host, which a captured CUDA graph cannot do)."""
    return (indices[:, None] == torch.arange(n, device=indices.device)).to(torch.float32)


def _priority_locations(mask: torch.Tensor, perm: Optional[torch.Tensor]) -> torch.Tensor:
    """Each token's place in its expert's queue, ``[S, E]``: token order,
    or (Random Token Selection) the order of the permutation ``perm``."""
    if perm is None:
        return torch.cumsum(mask, dim=0) - mask
    perm = perm.long()
    permuted = mask[perm]
    inv = torch.argsort(perm)
    return (torch.cumsum(permuted, dim=0) - permuted)[inv]


def _aux(gates: torch.Tensor, mask1: torch.Tensor) -> torch.Tensor:
    E = gates.shape[1]
    return torch.sum(torch.mean(gates, dim=0) * torch.mean(mask1, dim=0)) * E


def _used(mask: torch.Tensor, used_token_mask: Optional[torch.Tensor]) -> torch.Tensor:
    return mask if used_token_mask is None else mask * used_token_mask[:, None].to(mask.dtype)


def top1_routing(logits: torch.Tensor, capacity_factor: float, min_capacity: int,
                 used_token_mask: Optional[torch.Tensor] = None, noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, use_rts: bool = True, gumbel: Optional[torch.Tensor] = None,
                 rts_perm: Optional[torch.Tensor] = None) -> Routing:
    """Top-1 gating (JAX ``top1gating``). ``gumbel`` ([S, E]) is added to
    the choice's logits under ``noisy_gate_policy="RSample"``; ``rts_perm``
    ([S]) ranks the tokens for the capacity drop under ``use_rts`` (JAX
    draws both only when it has an rng: in training)."""
    S, E = logits.shape
    capacity = _capacity(S, E, capacity_factor, min_capacity) if drop_tokens else S
    logits32 = logits.float()
    noisy = logits32 + gumbel if noisy_gate_policy == "RSample" and gumbel is not None else logits32
    gates = torch.softmax(logits32, dim=1)
    idx1 = torch.argmax(noisy, dim=1)
    mask1 = _used(_one_hot(idx1, E), used_token_mask)
    l_aux = _aux(gates, mask1)
    exp_counts = torch.sum(mask1, dim=0).to(torch.int32)
    loc1 = _priority_locations(mask1, rts_perm if use_rts and drop_tokens else None)
    mask1 = mask1 * (loc1 < capacity).to(mask1.dtype)
    slot1 = torch.sum(loc1 * mask1, dim=1).long()
    weight = torch.sum(gates * mask1, dim=1)[:, None]
    return Routing(idx1[:, None], slot1[:, None], weight, weight > 0, capacity, E, l_aux, exp_counts)


def top2_routing(logits: torch.Tensor, capacity_factor: float, min_capacity: int, drop_tokens: bool = True,
                 gumbel: Optional[torch.Tensor] = None, used_token_mask: Optional[torch.Tensor] = None) -> Routing:
    """Top-2 gating (JAX ``top2gating``): the first choice by the gates,
    the second by the logits plus ``gumbel`` (JAX's second-expert sampling,
    drawn in training) with the first masked; second choices queue behind
    every first choice; the two weights renormalised."""
    S, E = logits.shape
    capacity = _capacity(S, E, capacity_factor * 2.0, min_capacity) if drop_tokens else S
    logits32 = logits.float()
    gates = torch.softmax(logits32, dim=1)
    idx1 = torch.argmax(gates, dim=1)
    mask1 = _used(_one_hot(idx1, E), used_token_mask)
    second = logits32 + gumbel if gumbel is not None else logits32
    idx2 = torch.argmax(torch.where(mask1 > 0, torch.full_like(second, -math.inf), second), dim=1)
    mask2 = _used(_one_hot(idx2, E), used_token_mask)
    loc1 = torch.cumsum(mask1, dim=0) - mask1
    loc2 = torch.cumsum(mask2, dim=0) - mask2 + torch.sum(mask1, dim=0, keepdim=True)
    l_aux = _aux(gates, mask1)
    exp_counts = torch.sum(mask1 + mask2, dim=0).to(torch.int32)
    mask1 = mask1 * (loc1 < capacity).to(mask1.dtype)
    mask2 = mask2 * (loc2 < capacity).to(mask2.dtype)
    slot = torch.stack([torch.sum(loc1 * mask1, dim=1), torch.sum(loc2 * mask2, dim=1)], dim=1).long()
    g1 = torch.sum(gates * mask1, dim=1)
    g2 = torch.sum(gates * mask2, dim=1)
    denom = torch.clamp(g1 + g2, min=_EPS32)
    weight = torch.stack([g1 / denom, g2 / denom], dim=1)
    return Routing(torch.stack([idx1, idx2], dim=1), slot, weight, weight > 0, capacity, E, l_aux, exp_counts)


def topk_routing(logits: torch.Tensor, k: int, capacity_factor: float, min_capacity: int, drop_tokens: bool = True,
                 noisy_gate_policy: Optional[str] = None, use_rts: bool = True,
                 used_token_mask: Optional[torch.Tensor] = None, gumbel: Optional[torch.Tensor] = None,
                 rts_perm: Optional[torch.Tensor] = None) -> Routing:
    """The k-specific gate (JAX ``topkgating``); k is 1 or 2."""
    if k == 1:
        return top1_routing(logits, capacity_factor, min_capacity, used_token_mask=used_token_mask,
                            noisy_gate_policy=noisy_gate_policy, drop_tokens=drop_tokens, use_rts=use_rts,
                            gumbel=gumbel, rts_perm=rts_perm)
    if k == 2:
        return top2_routing(logits, capacity_factor, min_capacity, drop_tokens=drop_tokens, gumbel=gumbel,
                            used_token_mask=used_token_mask)
    raise ValueError(f"Only top-1 and top-2 gating are supported (got k={k})")


def dense_routing(r: Routing) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``(combine_weights [S, E, C], dispatch_mask [S, E, C])`` of a
    routing (each (s, e, c) holds at most one assignment, as in JAX's sum
    of the per-choice one-hot products)."""
    S, k = r.expert.shape
    combine_w = torch.zeros((S, r.num_experts, r.capacity), dtype=torch.float32, device=r.weight.device)
    rows = torch.arange(S, device=r.weight.device)[:, None].expand(S, k)
    combine_w = combine_w.index_put((rows, r.expert, r.slot.clamp(max=r.capacity - 1)),
                                    torch.where(r.kept, r.weight, torch.zeros_like(r.weight)), accumulate=True)
    return combine_w, combine_w > 0


def _dense_tuple(r: Routing):
    combine_w, dispatch_m = dense_routing(r)
    return r.l_aux, combine_w, dispatch_m, r.exp_counts


def top1gating(logits, capacity_factor, min_capacity, used_token_mask=None, noisy_gate_policy=None, drop_tokens=True,
               use_rts=True, gumbel=None, rts_perm=None):
    """JAX's ``top1gating`` tuple (see ``top1_routing``)."""
    return _dense_tuple(top1_routing(logits, capacity_factor, min_capacity, used_token_mask, noisy_gate_policy,
                                     drop_tokens, use_rts, gumbel, rts_perm))


def top2gating(logits, capacity_factor, min_capacity, drop_tokens=True, gumbel=None, used_token_mask=None):
    """JAX's ``top2gating`` tuple (see ``top2_routing``)."""
    return _dense_tuple(top2_routing(logits, capacity_factor, min_capacity, drop_tokens, gumbel, used_token_mask))


def topkgating(logits, k, capacity_factor, min_capacity, drop_tokens=True, noisy_gate_policy=None, use_rts=True,
               used_token_mask=None, gumbel=None, rts_perm=None):
    """JAX's ``topkgating`` tuple (see ``topk_routing``)."""
    return _dense_tuple(topk_routing(logits, k, capacity_factor, min_capacity, drop_tokens, noisy_gate_policy,
                                     use_rts, used_token_mask, gumbel, rts_perm))


def dispatch(tokens: torch.Tensor, r: Routing) -> torch.Tensor:
    """``[S, H]`` tokens to ``[E, C, H]`` expert inputs: each kept
    assignment's token copied into its slot, every other slot zero (JAX's
    ``einsum("sec,sh->ech")`` value bit for bit). Differentiable in
    ``tokens``."""
    E, C = r.num_experts, r.capacity
    S, H = tokens.shape
    k = r.expert.shape[1]
    pos = torch.where(r.kept, r.expert * C + r.slot, torch.full_like(r.slot, E * C))  # the extra row: dropped
    src = tokens[:, None, :].expand(S, k, H).reshape(S * k, H)
    out = tokens.new_zeros((E * C + 1, H)).index_copy(0, pos.reshape(-1), src)
    return out[: E * C].reshape(E, C, H)


def combine(expert_out: torch.Tensor, r: Routing, cast: bool = True) -> torch.Tensor:
    """``[E, C, H]`` expert outputs to ``[S, H]``: each token's kept rows
    times their weights (cast to the output dtype, as JAX casts the combine
    weights), summed in fp32 in assignment order, cast back (left in fp32
    with ``cast=False``: a partial sum over some experts)."""
    E, C, H = expert_out.shape
    dt = expert_out.dtype
    pos = torch.where(r.kept, r.expert * C + r.slot, torch.zeros_like(r.slot))
    w = torch.where(r.kept, r.weight, torch.zeros_like(r.weight)).to(dt).float()
    rows = expert_out.reshape(E * C, H)[pos.reshape(-1)].reshape(pos.shape + (H,)).float()
    out = rows[:, 0] * w[:, 0, None]
    for j in range(1, pos.shape[1]):
        out = out + rows[:, j] * w[:, j, None]
    return out.to(dt) if cast else out


def dispatch_dense(tokens: torch.Tensor, dispatch_mask: torch.Tensor) -> torch.Tensor:
    """JAX's ``dispatch`` einsum over a dense mask (the plain reference)."""
    return torch.einsum("sec,sh->ech", dispatch_mask.to(tokens.dtype), tokens)


def combine_dense(expert_out: torch.Tensor, combine_weights: torch.Tensor) -> torch.Tensor:
    """JAX's ``combine`` einsum over dense weights (the plain reference)."""
    return torch.einsum("sec,ech->sh", combine_weights.to(expert_out.dtype), expert_out)
