#!/usr/bin/env python3
"""Phase 18a's bounds against planted faults, on one card.

    python3 tools/torch_ep_fault_probe.py [--seed N]

Runs ``chip_smoke.py``'s phases 18a-18d once and prints their records
(a breach of their bounds is printed as an ``ep_verdict`` line, not
raised). Then 18a's fp arm again on two gloo ranks that share the card,
once with each fault planted, against a fresh one-rank run on the same
global batch:

* ``expert_grad_zeroed``: rank 0's first local expert (expert 0 of 8)
  gets a zero gradient in every expert leaf, every step;
* ``combine_blocks_swapped``: the all-to-all that concatenates along dim 0
  (the combine, and the dispatch's backward) takes the received blocks in
  reverse source-rank order.

Each fault arm prints one ``ep_fault`` JSON line with ``_ep_rule``'s
numbers and ``caught``: whether 18a's bounds reject it. Prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import deepspeed_tpu_torch as dst  # noqa: E402
from deepspeed_tpu_torch import comm  # noqa: E402
from deepspeed_tpu_torch.moe import a2a  # noqa: E402
from deepspeed_tpu_torch.ops import native  # noqa: E402

ARMS = ("expert_grad_zeroed", "combine_blocks_swapped")


def _plant(arm, engine, rank):
    """Install ``arm``'s fault; returns the function that removes it."""
    if arm == "expert_grad_zeroed":
        hooks = []
        if rank == 0:
            for k, p in engine._params.items():
                if "moe/experts/" in k:  # [L, E_local, ...]: local expert 0 of every layer
                    hooks.append(p.register_hook(lambda g: g.index_fill(1, torch.tensor([0], device=g.device), 0)))
        return lambda: [h.remove() for h in hooks]
    orig = a2a._all_to_all

    def swapped(x, split_axis, concat_axis, group):
        out = orig(x, split_axis, concat_axis, group)
        if concat_axis != 0:
            return out
        return torch.cat(out.chunk(comm.get_world_size(group), dim=0)[::-1], dim=0)

    a2a._all_to_all = swapped
    return lambda: setattr(a2a, "_all_to_all", orig)


def _fault_rank(rank, store, result_path, work):
    import pickle
    import traceback

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dst.init_distributed("gloo", init_method=f"file://{store}", rank=rank, world_size=cs.EP,
                             timeout=cs.TP_PG_TIMEOUT_S)
        dev = torch.device("cuda", 0)
        cfg = cs._ep_train_cfg()
        gas = cs.EP_TRAIN["gradient_accumulation_steps"]
        data = cs._step_data(cfg.vocab_size, cfg.max_seq_len, gas * cs.EP_STEPS, cs.EP_ROWS, work["seed"] + 43, dev)
        out = {}
        for arm in ARMS:
            engine = cs._ep_engine(cfg, work["seed"], dev, dict(cs.EP_TRAIN, mesh={"expert": cs.EP}))
            remove = _plant(arm, engine, rank)
            rec, _walls = cs._drive(engine, data, cs.EP_STEPS)
            remove()
            out[arm] = dict(rec=rec, gaps=cs._ep_gaps(engine, f"{work['ref_dir']}/master{cs.EP_STEPS}"))
            del engine
            cs._free()
        comm.barrier()
        comm.destroy_process_group()
        payload = ("ok", {"train": out})
    except BaseException:  # the parent raises it
        payload = ("error", traceback.format_exc())
    with open(result_path, "wb") as f:
        pickle.dump(payload, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ep_fault_probe: this script needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    native.build_many(["ragged_paged_attention", "decode_attention", "flash_attention"])
    try:
        cs.phase_ep(args.seed, dev)
    except AssertionError as e:
        cs.emit(phase="ep_verdict", failed=str(e)[:6000])
    tmp = tempfile.mkdtemp(prefix="ep_fault_", dir="/dev/shm" if os.path.isdir("/dev/shm") else None)
    try:
        ref = cs._ep_train_ref(args.seed, dev, tmp)
        ranks = cs._spawn_ranks(_fault_rank, cs.EP, tmp, dict(seed=args.seed, ref_dir=tmp), cs.EP_LIMIT_S, "fault")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for arm in ARMS:
        bad = []
        rule = cs._ep_rule(arm, ranks[0]["train"][arm]["rec"], ref, cs._ep_pooled(ranks, arm), bad)
        cs.emit(phase="ep_fault", arm=arm, caught=bool(bad), rule=rule, losses=[x[0] for x in ranks[0]["train"][arm]["rec"]],
                one_rank=ref)
    return 0


if __name__ == "__main__":
    sys.exit(main())
