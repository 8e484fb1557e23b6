#!/usr/bin/env python3
"""Where bf16 streams with speculation or after recovery part from plain decoding.

    python3 tools/torch_spec_divergence.py [--seed N] [--new N]

On one CUDA card: llama-1B at full width and depth with chip_smoke.py's
seeded random weights, bf16, pages of 16, 8 slots, prefix cache on, the
steady traffic of chip_smoke's phase 9b (8 prompts of 128 tokens, ``--new``
new tokens each). Fresh single-step ragged servers, each against the first:

* ``off``: speculation off (the reference), then ``off again`` (the
  reference's repeatability);
* ``never drafts``: a drafter that proposes nothing, so every decode step
  runs at the verify width (1 + 4 slots) with one token a row: the width
  alone;
* ``oracle``: drafts of the reference's own next tokens (K = 4);
* ``recovered``: a journaled server killed at ``serve.mid_step`` after 40
  steps and recovered from the replayed journal (re-prefill of every
  generated token in chunks of 32).

Each server prints one JSON line: streams equal to the reference, and for
every stream that parts, the position, the reference's top-2 logit gap
there (the plain path in fp32 over the same bf16 weights) and whether
scoring that position at width 1 and at width 5 (8 live rows, K4) moves
its argmax. A line then scores the 8 streams at 8 positions at width 1 and
width 5 with 8 live rows (chip_smoke's ``width_logits``: contexts written
by one plain prefill, a step whose rows all carry ``q_len`` = width): the
largest logit difference and the rows whose argmax moved. Last, the width
probe: a speculation-off server run step by step, and before each of its
decode steps that step run on copies of its pools at width 1 and at width 5
with ``q_len`` 1 a row, as the two servers run it, through K4 and through
the plain attention: the steps whose logits or written k/v differ, with the
rows' lengths, and the count of equal steps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.inference.journal import RequestJournal  # noqa: E402
from deepspeed_tpu_torch.inference.scheduler import PagedServer  # noqa: E402
from deepspeed_tpu_torch.inference.spec_decode import Drafter  # noqa: E402
from deepspeed_tpu_torch.inference.decode import _paged_forward  # noqa: E402
from deepspeed_tpu_torch.models import TransformerLM, llama_config  # noqa: E402
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params  # noqa: E402
from deepspeed_tpu_torch.utils import chaos  # noqa: E402


class NeverDrafter(Drafter):
    def propose(self, uid, context, k):
        return np.zeros(0, np.int32)


def width_probe(cfg, server, impl):
    """The server's next decode step (every row decoding) at width 1 and at
    width 5, ``q_len`` 1 a row, on copies of its pools, with the pages the
    step writes reserved first as the server reserves them: the largest
    logit difference (slot 0), the rows whose argmax moved, and the largest
    difference of the k and v written at the rows' positions."""
    rows = server._reserve_for_growth([r for r in server._active if not r.done], {})  # the step's pages, as it will
    R, table, lengths = server._dispatch_rows(rows, pad_to=server.pool.max_slots)
    dev = server.pool.cache.k_pages.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    q_lens = np.zeros(R, np.int32)
    q_lens[: len(rows)] = 1
    out, written = [], []
    for W in (1, 5):
        tokens = np.zeros((R, W), np.int32)
        tokens[: len(rows), 0] = [r.pending for r in rows]
        kp, vp = server.pool.cache.k_pages.clone(), server.pool.cache.v_pages.clone()
        offs = np.arange(W)[None, :]
        with torch.no_grad():
            logits = _paged_forward(cfg, server.params, t(tokens), kp, vp, t(table), t(lengths[:, None] + offs), impl,
                                    write_valid=t(offs < q_lens[:, None]).bool(),
                                    kv_lens=t(np.where(q_lens > 0, lengths + q_lens, 0)), q_lens=t(q_lens))
        out.append(logits[: len(rows), 0].float())
        pos = lengths[: len(rows)]
        pages = t(table[np.arange(len(rows)), pos // cs.P]).long()
        written.append((kp[:, pages, :, torch.as_tensor(pos % cs.P, device=dev)].float(),
                        vp[:, pages, :, torch.as_tensor(pos % cs.P, device=dev)].float()))
    return dict(impl=impl, rows=len(rows), max_abs_logit_diff=float((out[0] - out[1]).abs().max()),
                argmax_moved=int((out[0].argmax(dim=1) != out[1].argmax(dim=1)).sum()),
                max_abs_k_diff=float((written[0][0] - written[1][0]).abs().max()),
                max_abs_v_diff=float((written[0][1] - written[1][1]).abs().max()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--new", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_spec_divergence: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = llama_config("1b")
    params = load_jax_params(TransformerLM(cfg), cs.init_params(cfg, args.seed), device=dev,
                             dtype=torch.bfloat16).param_tree()
    rs = np.random.default_rng(args.seed + 7)
    prompts = [rs.integers(0, cfg.vocab_size, 128, dtype=np.int32) for _ in range(8)]
    kw = dict(dtype=torch.bfloat16, prefix_cache=True, device=dev, **cs.SERVE)
    print(json.dumps(dict(card=torch.cuda.get_device_name(0), new=args.new)), flush=True)

    def report(name, outs, ref):
        parts = []
        for i, (a, b) in enumerate(zip(outs, ref)):
            diff = np.nonzero(a != b)[0]
            if diff.size:
                at = int(diff[0])
                w1, w5 = cs.width_logits(cfg, params, [b[:at]], [b[at : at + cs.SPEC_K]], dev)
                parts.append(dict(request=i, position=at - 128,
                                  plain_fp32_top2_gap=cs._top2_gap(cfg, params, b[:at], dev),
                                  width_moves_argmax=bool(w1.argmax() != w5.argmax())))
        print(json.dumps(dict(server=name, identical=cs._same(outs, ref), partings=parts)), flush=True)

    ref = PagedServer(cfg, params, **kw).serve(prompts, max_new_tokens=args.new)
    report("off again", PagedServer(cfg, params, **kw).serve(prompts, max_new_tokens=args.new), ref)
    report("never drafts", PagedServer(cfg, params, drafter=NeverDrafter(), spec_decode={"max_draft": cs.SPEC_K},
                                       **kw).serve(prompts, max_new_tokens=args.new), ref)
    oracle = cs.OracleDrafter(dict(enumerate(ref)), cfg.vocab_size)
    report("oracle", PagedServer(cfg, params, drafter=oracle, spec_decode={"max_draft": cs.SPEC_K},
                                 **kw).serve(prompts, max_new_tokens=args.new), ref)
    with tempfile.TemporaryDirectory(prefix="journal_") as jdir:
        server = PagedServer(cfg, params, journal=RequestJournal(jdir), **kw)
        for p in prompts:
            server.submit(p, max_new_tokens=args.new)
        chaos.install(chaos.ChaosSchedule([chaos.ChaosRule("serve.mid_step", hit=40)]))
        try:
            server.run()
        except chaos.ChaosKilled:
            pass
        finally:
            chaos.uninstall()
        del server
        states, next_uid = RequestJournal.replay(jdir)
        fresh = PagedServer(cfg, params, journal=RequestJournal(jdir), **kw)
        fresh.recover(states, next_uid)
        fresh.run()
        report("recovered", [fresh.take_result(u) for u in range(len(prompts))], ref)
    diffs, moved = [], 0
    for at in np.linspace(129, 128 + args.new - cs.SPEC_K, 8).astype(int):
        w1, w5 = cs.width_logits(cfg, params, [o[:at] for o in ref], [o[at : at + cs.SPEC_K] for o in ref], dev)
        diffs += (w1 - w5).abs().amax(dim=1).tolist()
        moved += int((w1.argmax(dim=1) != w5.argmax(dim=1)).sum())
    print(json.dumps(dict(width_logits="8 live rows, width 1 vs 5", positions=len(diffs),
                          max_abs_logit_diff=max(diffs), argmax_moved=moved)), flush=True)
    server = PagedServer(cfg, params, **kw)
    for p in prompts:
        server.submit(p, max_new_tokens=args.new)
    equal, differ, step = {"auto": 0, "plain": 0}, [], 0
    while server.has_work():
        if not server.prefilling():
            for impl in ("auto", "plain"):
                rec = width_probe(cfg, server, impl)
                if rec["max_abs_logit_diff"] or rec["max_abs_k_diff"] or rec["max_abs_v_diff"]:
                    rows = [r for r in server._active if not r.done]
                    differ.append(dict(step=step, lengths=[int(server.pool.seq_lens[r.slot]) for r in rows], **rec))
                else:
                    equal[impl] += 1
        server.step()
        step += 1
    print(json.dumps(dict(width_probe="each decode step at width 1 vs 5, q_len 1", steps=step, equal_steps=equal,
                          differing=differ[:12], differing_count=len(differ))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
