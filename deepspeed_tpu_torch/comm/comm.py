"""Collectives over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/comm/comm.py`` for the subset the
tensor-parallel paths call (``inference/tp.py``, the engine's dense
tensor-parallel forward and ``generate``, and its pre-sharded checkpoint
save), under the same names. The JAX module rides ``jax.distributed`` and
returns host arrays; here, as in the reference DeepSpeed, one process runs
each rank and the collectives are ``torch.distributed``'s: a tensor
collective works in place on its output tensor (and returns it).

* ``init_distributed(dist_backend=...)`` takes the backend by name. The
  default is ``"nccl"``, the reference's for a CUDA device; ``"gloo"`` is
  asked for by name (the CPU tests, and two ranks that share one card).
  A failing ``nccl`` init raises: nothing turns it into gloo. The process
  group always gets a ``timeout``, so a rank whose peer died ends instead
  of waiting forever.
* Every collective is handed to the backend as it is, and an error
  raises. gloo takes CUDA tensors for each collective here (torch 2.11 on
  the H100 machine: all-reduce, all-gather, all-gather into a tensor,
  all-to-all and broadcast, in fp32, bf16, int8 and int32; gloo copies
  through host memory inside), so the port stages nothing itself.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.comm.reduce_op import ReduceOp

DEFAULT_TIMEOUT_S = 300.0

_TORCH_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.BAND: dist.ReduceOp.BAND,
    ReduceOp.BOR: dist.ReduceOp.BOR,
    ReduceOp.BXOR: dist.ReduceOp.BXOR,
}

# -- init ------------------------------------------------------------------
def init_distributed(
    dist_backend: Optional[str] = None,
    auto_mpi_discovery: bool = True,  # noqa: ARG001 - kept for API parity
    distributed_port: int = 29500,
    verbose: bool = True,  # noqa: ARG001
    timeout=None,
    init_method: Optional[str] = None,
    dist_init_required: Optional[bool] = None,  # noqa: ARG001
    config=None,  # noqa: ARG001
    rank: int = -1,
    world_size: int = -1,
) -> None:
    """Start this process's rank of the default process group.

    ``dist_backend`` names the backend (``"nccl"`` when None, as in the
    reference). ``rank`` / ``world_size`` default to the launcher's
    ``RANK`` / ``WORLD_SIZE``; ``init_method`` to ``env://`` over
    ``MASTER_ADDR`` / ``MASTER_PORT`` (``distributed_port`` when unset). A
    ``file://`` method rendezvouses through a file store. ``timeout`` is in
    seconds (or a ``timedelta``; default ``DEFAULT_TIMEOUT_S``). A second
    call with the group up does nothing."""
    if dist.is_initialized():
        return
    backend = dist_backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown dist backend {backend!r}: the port runs 'nccl' or 'gloo'")
    if rank < 0:
        rank = int(os.environ.get("RANK", 0))
    if world_size < 0:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if init_method is None:
        os.environ.setdefault("MASTER_ADDR", "localhost")
        os.environ.setdefault("MASTER_PORT", str(distributed_port))
        init_method = "env://"
    if timeout is None:
        timeout = DEFAULT_TIMEOUT_S
    if not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend=backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=timeout)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def destroy_process_group(group=None) -> None:
    if is_initialized():
        dist.destroy_process_group(group)


def get_rank(group=None) -> int:
    return dist.get_rank(group) if is_initialized() else 0


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def new_group(ranks: Sequence[int]):
    """A process group over ``ranks`` (every rank of the world must call it)."""
    return dist.new_group(ranks=list(ranks))


# -- collectives ------------------------------------------------------------
class _Done:
    """The work handle of a collective over one rank: nothing to wait for."""

    def wait(self) -> bool:
        return True


def barrier(group=None) -> None:
    if get_world_size(group) > 1:
        dist.barrier(group=group)


def all_reduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM, group=None, async_op: bool = False):
    """Reduce ``tensor`` across the group in place (``ReduceOp.AVG``: the
    sum divided by the group size); returns it, or with ``async_op`` the
    backend's work handle (``wait()`` before reading the tensor; not for
    ``AVG``)."""
    if get_world_size(group) == 1:
        return _Done() if async_op else tensor
    if op == ReduceOp.AVG:
        if async_op:
            raise ValueError("all_reduce: ReduceOp.AVG has no async form")
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
        tensor.div_(torch.full((), get_world_size(group), dtype=tensor.dtype, device=tensor.device))
        return tensor
    work = dist.all_reduce(tensor, op=_TORCH_OPS[op], group=group, async_op=async_op)
    return work if async_op else tensor


def all_gather(tensor_list: Optional[List[torch.Tensor]], tensor: torch.Tensor, group=None,
               async_op: bool = False) -> List[torch.Tensor]:
    """Every rank's ``tensor``, in rank order, into ``tensor_list`` (made
    when None); returns the list."""
    world = get_world_size(group)
    if tensor_list is None:
        tensor_list = [torch.empty_like(tensor) for _ in range(world)]
    if world == 1:
        tensor_list[0].copy_(tensor)
        return tensor_list
    dist.all_gather(tensor_list, tensor.contiguous(), group=group, async_op=async_op)
    return tensor_list


def all_gather_into_tensor(output_tensor: torch.Tensor, input_tensor: torch.Tensor, group=None,
                           async_op: bool = False) -> torch.Tensor:
    """Every rank's ``input_tensor`` concatenated along dim 0 into
    ``output_tensor`` (``world * input.shape[0]`` rows); returns it."""
    if get_world_size(group) == 1:
        return output_tensor.copy_(input_tensor.reshape(output_tensor.shape))
    dist.all_gather_into_tensor(output_tensor, input_tensor.contiguous(), group=group, async_op=async_op)
    return output_tensor


def broadcast(tensor: torch.Tensor, src: int = 0, group=None, async_op: bool = False) -> torch.Tensor:
    """``tensor`` of global rank ``src`` onto every rank, in place."""
    if get_world_size(group) == 1:
        return tensor
    dist.broadcast(tensor, src=src, group=group, async_op=async_op)
    return tensor


def broadcast_object_list(object_list: list, src: int = 0, group=None) -> None:
    if get_world_size(group) > 1:
        dist.broadcast_object_list(object_list, src=src, group=group)


def all_gather_object(obj: Any, group=None) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order."""
    world = get_world_size(group)
    if world == 1:
        return [obj]
    out: List[Any] = [None] * world
    dist.all_gather_object(out, obj, group=group)
    return out


def all_to_all_single(output: torch.Tensor, tensor: torch.Tensor, output_split_sizes=None,
                      input_split_sizes=None, group=None, async_op: bool = False) -> torch.Tensor:
    """Rank i receives chunk i (along dim 0) of every rank's ``tensor``,
    concatenated in source-rank order into ``output``; returns it."""
    if get_world_size(group) == 1:
        return output.copy_(tensor)
    dist.all_to_all_single(output, tensor.contiguous(), output_split_sizes, input_split_sizes, group=group,
                           async_op=async_op)
    return output
