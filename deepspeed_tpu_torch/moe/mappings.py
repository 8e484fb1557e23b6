"""Tensor-parallel token mappings for MoE (counterpart of
``deepspeed_tpu/moe/mappings.py``; reference ``deepspeed/moe/mappings.py``).

``drop_tokens`` keeps this rank's chunk of a dim over the ``model`` group
and ``gather_tokens`` all-gathers the chunks back, each the other's
autograd dual: the gradient of a gather keeps the rank's chunk, the
gradient of a drop is gathered. Both are the identity without a live
topology (none is made here) or at a ``model`` axis of 1, as the reference
is without an mpu; an indivisible drop raises JAX's ``ValueError``.
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch import comm

MODEL_AXES = ("model",)


def _live_tp():
    """(topology, tp size) of the live topology, without making one."""
    from deepspeed_tpu_torch.parallel.mesh import live_topology

    topo = live_topology()
    if topo is None:
        return None, 1
    return topo, topo.axis_size("model")


def _gather(x: torch.Tensor, dim: int, topo) -> torch.Tensor:
    parts = comm.all_gather(None, x.contiguous(), group=topo.group(MODEL_AXES))
    return torch.cat(parts, dim=dim)


def _drop(x: torch.Tensor, dim: int, topo, tp: int) -> torch.Tensor:
    n = x.shape[dim] // tp
    return x.narrow(dim, topo.axis_rank(MODEL_AXES) * n, n).contiguous()


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, topo, tp):
        ctx.args = (dim, topo, tp)
        return _gather(x, dim, topo)

    @staticmethod
    def backward(ctx, g):
        dim, topo, tp = ctx.args
        return _drop(g, dim, topo, tp), None, None, None


class _DropTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, topo, tp):
        ctx.args = (dim, topo, tp)
        return _drop(x, dim, topo, tp)

    @staticmethod
    def backward(ctx, g):
        dim, topo, _tp = ctx.args
        return _gather(g, dim, topo), None, None, None


def gather_tokens(input_: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every ``model`` rank's chunk of ``dim`` concatenated in rank order."""
    topo, tp = _live_tp()
    if tp <= 1:
        return input_
    return _GatherTokens.apply(input_, dim, topo, tp)


def drop_tokens(input_: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This ``model`` rank's chunk of ``dim``."""
    topo, tp = _live_tp()
    if tp <= 1:
        return input_
    if input_.shape[dim] % tp != 0:
        raise ValueError(
            f"dimension {dim} ({input_.shape[dim]}) is not divisible by the "
            f"tensor-parallel world size ({tp})"
        )
    return _DropTokens.apply(input_, dim, topo, tp)


# reference private aliases
_gather_tokens = gather_tokens
_drop_tokens = drop_tokens
