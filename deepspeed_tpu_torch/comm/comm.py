"""Collectives over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/comm/comm.py`` for the surface the
tensor-parallel paths (``inference/tp.py``, the engine's dense
tensor-parallel forward and ``generate``, its pre-sharded checkpoint save)
and the ZeRO training paths (``runtime/engine.py``,
``runtime/zero/partition.py``) call, under the same names. The JAX module rides ``jax.distributed`` and
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
* ``reduce_scatter_tensor`` / ``reduce_scatter`` are
  ``torch.distributed``'s reduce-scatter on every backend: gloo takes it
  on CPU tensors and, in the H100 machine's torch 2.11, on CUDA tensors
  (async too), so no backend needs a stand-in.
* ``reduce`` and ``gather`` define their result on ``dst``, as in the
  reference; like JAX's they are computed on every rank (an all-reduce, an
  all-gather), a superset of the contract that any backend runs.
  ``all_reduce_coalesced`` flattens each dtype's tensors into one buffer
  and reduces it once; ``all_gather_coalesced`` gathers each tensor.
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
    if isinstance(getattr(group, "axis", None), tuple):  # a utils.groups.AxisGroup
        return group.rank
    return dist.get_rank(group) if is_initialized() else 0


def get_world_size(group=None) -> int:
    if isinstance(getattr(group, "axis", None), tuple):  # a utils.groups.AxisGroup
        return group.size
    return dist.get_world_size(group) if is_initialized() else 1


def get_local_rank() -> int:
    """The rank on this host (the launcher's ``LOCAL_RANK``, else 0)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def get_global_rank(group=None, group_rank: int = 0) -> int:
    """The global rank of ``group_rank`` within ``group``."""
    if group is None or not is_initialized():
        return group_rank
    return dist.get_global_rank(group, group_rank)


def get_world_group():
    """The default (world) group."""
    return dist.group.WORLD if is_initialized() else None


def get_backend(group=None) -> Optional[str]:
    """The backend's name (``"nccl"``, ``"gloo"``), None without a group."""
    return dist.get_backend(group) if is_initialized() else None


def is_available() -> bool:
    return dist.is_available()


def has_all_gather_into_tensor() -> bool:
    return True


def has_reduce_scatter_tensor() -> bool:
    return True


def has_coalescing_manager() -> bool:
    return False


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


def monitored_barrier(group=None, timeout=None, wait_all_ranks: bool = False) -> None:
    """A barrier that names the ranks that failed to reach it within
    ``timeout`` seconds (gloo's ``monitored_barrier``; other backends take
    the plain barrier, which ends at the group's own timeout)."""
    if get_world_size(group) == 1:
        return
    if get_backend(group) == "gloo":
        if timeout is not None and not isinstance(timeout, datetime.timedelta):
            timeout = datetime.timedelta(seconds=float(timeout))
        dist.monitored_barrier(group=group, timeout=timeout, wait_all_ranks=wait_all_ranks)
    else:
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
    ``output_tensor`` (``world * input.shape[0]`` rows); returns it, or with
    ``async_op`` the backend's work handle (``wait()`` before reading)."""
    if get_world_size(group) == 1:
        output_tensor.copy_(input_tensor.reshape(output_tensor.shape))
        return _Done() if async_op else output_tensor
    work = dist.all_gather_into_tensor(output_tensor, input_tensor.contiguous(), group=group, async_op=async_op)
    return work if async_op else output_tensor


def broadcast(tensor: torch.Tensor, src: int = 0, group=None, async_op: bool = False) -> torch.Tensor:
    """``tensor`` of global rank ``src`` onto every rank, in place; returns
    it, or with ``async_op`` the backend's work handle."""
    if get_world_size(group) == 1:
        return _Done() if async_op else tensor
    work = dist.broadcast(tensor, src=src, group=group, async_op=async_op)
    return work if async_op else tensor


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


def reduce(tensor: torch.Tensor, dst: int = 0, op: ReduceOp = ReduceOp.SUM, group=None) -> torch.Tensor:
    """``tensor`` reduced across the group; the reference defines the result
    on ``dst``, here every rank holds it (an all-reduce, as in JAX)."""
    return all_reduce(tensor, op=op, group=group)


def gather(tensor: torch.Tensor, gather_list: Optional[List[torch.Tensor]] = None, dst: int = 0,
           group=None) -> List[torch.Tensor]:
    """Every rank's ``tensor`` in rank order; filled into ``gather_list`` on
    ``dst`` (every rank gets the list back, an all-gather, as in JAX)."""
    gathered = all_gather(None, tensor, group=group)
    if gather_list is not None and get_rank(group) == dst:
        for out, got in zip(gather_list, gathered):
            out.copy_(got)
    return gathered


def reduce_scatter_tensor(output_tensor: torch.Tensor, tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                          group=None, async_op: bool = False):
    """Reduce ``tensor`` across the group and keep this rank's contiguous
    chunk of it along dim 0 in ``output_tensor``; returns it, or with
    ``async_op`` the backend's work handle (``ReduceOp.AVG``: the sum
    divided by the group size; not async)."""
    world = get_world_size(group)
    if world == 1:
        output_tensor.copy_(tensor.reshape(output_tensor.shape))
        return _Done() if async_op else output_tensor
    if op == ReduceOp.AVG:
        if async_op:
            raise ValueError("reduce_scatter_tensor: ReduceOp.AVG has no async form")
        dist.reduce_scatter_tensor(output_tensor, tensor.contiguous(), op=dist.ReduceOp.SUM, group=group)
        return output_tensor.div_(torch.full((), world, dtype=output_tensor.dtype, device=output_tensor.device))
    work = dist.reduce_scatter_tensor(output_tensor, tensor.contiguous(), op=_TORCH_OPS[op], group=group,
                                      async_op=async_op)
    return work if async_op else output_tensor


def reduce_scatter(output: torch.Tensor, input_list: Sequence[torch.Tensor], op: ReduceOp = ReduceOp.SUM,
                   group=None) -> torch.Tensor:
    """Reduce the per-rank list elementwise across the group and keep entry
    ``rank`` in ``output``; returns it."""
    return reduce_scatter_tensor(output, torch.stack([t.reshape(output.shape) for t in input_list]), op=op,
                                 group=group)


def all_reduce_coalesced(tensors: Sequence[torch.Tensor], op: ReduceOp = ReduceOp.SUM, group=None
                         ) -> List[torch.Tensor]:
    """Reduce every tensor of the list in place, one collective per dtype
    (each dtype's tensors flattened into one buffer); returns the list."""
    tensors = list(tensors)
    if get_world_size(group) == 1 or not tensors:
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_ts in by_dtype.values():
        flat = all_reduce(torch.cat([t.reshape(-1) for t in group_ts]), op=op, group=group)
        i = 0
        for t in group_ts:
            t.copy_(flat[i:i + t.numel()].view(t.shape))
            i += t.numel()
    return tensors


def all_gather_coalesced(tensor_list: Sequence[torch.Tensor], group=None) -> List[List[torch.Tensor]]:
    """For each tensor of the list, every rank's copy in rank order."""
    return [all_gather(None, t, group=group) for t in tensor_list]
