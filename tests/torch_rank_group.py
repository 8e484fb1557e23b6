"""Spawned gloo rank groups for the port's tensor-parallel CPU tests.

``start_ranks(fn, world, tmp_dir)`` spawns ``world`` processes (the
``spawn`` start method, one torch thread each); each joins one gloo process
group through a ``FileStore`` under ``tmp_dir`` (no TCP port, so parallel
test files cannot collide) with a process-group timeout, runs
``fn(rank, world, *args)`` and writes its result, or its traceback, to a pickle.
``join_ranks`` waits with a hard limit, kills every rank on a timeout,
and raises on any rank's failure, so a failing or hung rank fails the test
instead of hanging the suite. ``fn`` must be a module-level function of an
importable module.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import time
import traceback

PG_TIMEOUT_S = 60.0


def _rank_main(fn, rank: int, world: int, store: str, out: str, args) -> None:
    import torch

    torch.set_num_threads(1)
    try:
        from deepspeed_tpu_torch import comm

        comm.init_distributed("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                              timeout=PG_TIMEOUT_S)
        result = fn(rank, world, *args)
        comm.barrier()
        comm.destroy_process_group()
        payload = ("ok", result)
    except BaseException:  # the parent reports it; a rank never hangs the suite on its own error
        payload = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def _context(fn):
    """A fork server: a fresh interpreter (nothing of the caller's threads
    or JAX state) that imports torch, the port and ``fn``'s module once,
    then forks each rank from that state instead of paying the imports per
    rank."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "deepspeed_tpu_torch.inference.engine", "torch_rank_group", fn.__module__])
    return ctx


def start_ranks(fn, world: int, tmp_dir: str, *args):
    """Start the group; returns a handle for ``join_ranks``."""
    os.makedirs(tmp_dir, exist_ok=True)
    ctx = _context(fn)
    store = os.path.join(tmp_dir, f"store_{world}")
    outs = [os.path.join(tmp_dir, f"rank_{world}_{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, store, outs[r], args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs


def join_ranks(handle, limit_s: float = 240.0):
    """Every rank's result, in rank order."""
    procs, outs = handle
    deadline = time.monotonic() + limit_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results, errors = [], []
    for r, out in enumerate(outs):
        if not os.path.exists(out):
            errors.append(f"rank {r}: no result (exit code {procs[r].exitcode})")
            continue
        with open(out, "rb") as f:
            status, value = pickle.load(f)
        if status == "ok":
            results.append(value)
        else:
            errors.append(f"rank {r}:\n{value}")
    if hung:
        errors.insert(0, f"ranks {hung} still running after {limit_s} s: killed")
    if errors:
        raise AssertionError("\n".join(errors))
    return results
