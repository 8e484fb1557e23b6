"""The tensor-parallel serving scenarios shared by
``test_torch_tp_serving.py`` and ``test_torch_tp_spec_windows_int8.py``.

Each scenario names a model, the waves of prompts and budgets it serves
and the server's knobs; ``port_run`` serves it on a port server (one rank
of a group, or single-rank at degree 1), ``jax_runs`` on JAX's
``TPServing(mesh=serving_mesh(tp))`` server on the 8-device CPU mesh, from
the same numpy-seeded tree, and ``collect`` starts a gloo rank group per
degree, builds both references while the ranks run, and gathers every
rank's results. JAX's tiny TP config
(``tests/unit/inference/test_tp_serving.py:53-60``), fp32. Every scenario
of a model shares one pool shape, so each JAX server reuses the programs
compiled before it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree
from deepspeed_tpu_torch.compression.int8 import quantize_params_int8
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.inference.spec_decode import Drafter
from deepspeed_tpu_torch.inference.tp import TPServing
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.models.transformer import init_params
from torch_rank_group import join_ranks, start_ranks

CFG = dict(
    vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=4, max_seq_len=64,
    norm="rmsnorm", position="rope", activation="swiglu", use_bias=False, tie_embeddings=False,
    flash_attention=False, dtype="float32",
)
MODELS = {"mha": (CFG, 0), "gqa": ({**CFG, "num_heads": 8, "num_kv_heads": 4}, 3)}
SERVER = dict(page_size=8, max_slots=4, prefill_chunk=8, num_pages=20)
DEGREES = (2, 4)
STAT_KEYS = ("tp_degree", "finished", "decode_steps", "ragged_steps", "preempted", "spec_rounds",
             "spec_accepted", "window_steps")


def prompts(n, seed=0, lo=3, hi=20):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, CFG["vocab_size"], (int(rs.randint(lo, hi)),)).astype(np.int32) for _ in range(n)]


def prefix_prompts():
    rs = np.random.RandomState(21)
    sys_tokens = rs.randint(0, 128, (19,)).astype(np.int32)
    return [np.concatenate([sys_tokens, rs.randint(0, 128, (3 + i,)).astype(np.int32)]) for i in range(4)]


MIXED, BUDGETS = prompts(6, seed=2), [10, 3, 7, 12, 1, 5]
# name -> (model, waves of (prompts, budgets), server knobs, extras)
SCENARIOS = {
    "mixed": ("mha", [(MIXED[:3], BUDGETS[:3]), (MIXED[3:], BUDGETS[3:])], {}, {}),
    "gqa": ("gqa", [(prompts(4, seed=6), 8)], {}, {}),
    "preempt": ("mha", [(prompts(4, seed=4, lo=28, hi=32), 12)], {}, {}),
    "prefix": ("mha", [(prefix_prompts()[:1], 4), (prefix_prompts()[1:], 4)], dict(prefix_cache=True), {}),
    "spec": ("mha", [(prompts(4, seed=5), 8)], dict(spec_decode={"max_draft": 2}), {"drafter": True}),
    "windows": ("mha", [(prompts(3, seed=7, lo=4, hi=9), 13)], dict(multi_step={"enable": True, "horizon": 4}), {}),
    "int8": ("mha", [(prompts(3, seed=11, lo=10, hi=11), 6)], {}, {"int8": True}),
    # JAX's quantized all-reduce serve (test_tp_serving.py:361-377); ranks only: its streams are allclose
    "quantized": ("mha", [(prompts(3, seed=9), 6)], {}, {}),
}


def tree(model):
    """The numpy-seeded tree both packages load (nested, fp32)."""
    cfg, seed = MODELS[model]
    return unflatten_tree(init_params(TransformerConfig(**cfg), seed))


class MixDrafter(Drafter):
    """Row uid drafts uid % 3 tokens: rounds carry 0-, 1- and 2-draft rows."""

    def propose(self, uid, context, k):
        return np.arange(min(k, uid % 3), dtype=np.int32)


def port_params(model, int8=False):
    from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params

    cfg = TransformerConfig(**MODELS[model][0])
    params = load_jax_params(TransformerLM(cfg), tree(model), device="cpu").param_tree()
    return cfg, quantize_params_int8(params) if int8 else params


def serve(server, waves):
    outs = []
    for batch, budgets in waves:
        outs += server.serve(batch, max_new_tokens=budgets)
    return [np.asarray(o).tolist() for o in outs]


def stats_of(st):
    return {k: st[k] for k in STAT_KEYS}


def port_run(name, degree, **tp_kw):
    model, waves, knobs, extra = SCENARIOS[name]
    cfg, params = port_params(model, int8=extra.get("int8", False))
    tp = TPServing(degree=degree, **tp_kw) if degree > 1 else None
    srv = PagedServer(cfg, params, attn_impl="plain", device="cpu", tp=tp,
                      drafter=MixDrafter() if extra.get("drafter") else None, **{**SERVER, **knobs})
    outs = serve(srv, waves)
    st = srv.serve_stats()
    return dict(outs=outs, stats=stats_of(st), fingerprint=st["step_fingerprint"],
                steps=st["fingerprint_steps"], used_pages=srv.pool.used_pages(),
                prefix_hit_pages=srv.pool.stats["prefix_hit_pages"], quantized=st["tp_quantized_allreduce"],
                window_graph=st["window_graph"])


# --- the JAX references -----------------------------------------------------------------
def jax_runs(degree, names):
    import jax.numpy as jnp

    from deepspeed_tpu.compression.int8 import quantize_params_int8 as jax_quantize
    from deepspeed_tpu.inference.scheduler import PagedServer as JaxServer
    from deepspeed_tpu.inference.spec_decode import Drafter as JaxDrafter
    from deepspeed_tpu.inference.tp import TPServing as JaxTP, serving_mesh
    from deepspeed_tpu.models.config import TransformerConfig as JaxConfig

    class JaxMixDrafter(JaxDrafter):
        def propose(self, uid, context, k):
            return np.arange(min(k, uid % 3), dtype=np.int32)

    out = {}
    for name in names:
        model, waves, knobs, extra = SCENARIOS[name]
        params = {k: jnp.asarray(v) for k, v in flatten_tree(tree(model)).items()}
        params = unflatten_tree(params)
        if extra.get("int8"):
            params = jax_quantize(params)
        srv = JaxServer(JaxConfig(**MODELS[model][0]), params, attn_impl="xla", dtype=jnp.float32,
                        tp=JaxTP(mesh=serving_mesh(degree)),
                        drafter=JaxMixDrafter() if extra.get("drafter") else None, **{**SERVER, **knobs})
        outs = serve(srv, waves)
        out[name] = dict(outs=outs, stats=stats_of(srv.serve_stats()))
    return out




def collect(rank_main, names, tmp):
    """Start a rank group per degree running ``rank_main(rank, world,
    tmp)``, build the JAX and single-rank references of ``names`` while
    they run, then every rank's results: ``{"tp1": ..., "jax": {degree:
    ...}, "port": {degree: [rank results]}}``."""
    handles = {d: start_ranks(rank_main, d, os.path.join(tmp, f"tp{d}"), tmp) for d in DEGREES}
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tp1 = {name: port_run(name, 1) for name in names}
        jax = {d: jax_runs(d, names) for d in DEGREES}
        port = {d: join_ranks(handles[d]) for d in DEGREES}
    finally:
        torch.set_num_threads(prev)
    return dict(tp1=tp1, jax=jax, port=port)


def check_streams(runs, scenario, degree):
    """Every rank's greedy streams byte-identical to JAX's TP server's and
    to the single-rank server's, the counters equal to JAX's, the pool
    empty after the run."""
    ref = runs["jax"][degree][scenario]
    assert ref["outs"] == runs["tp1"][scenario]["outs"]
    for rank, res in enumerate(runs["port"][degree]):
        got = res[scenario]
        assert got["outs"] == ref["outs"], f"rank {rank}"
        assert got["stats"] == ref["stats"], f"rank {rank}"
        assert got["used_pages"] == 0
    return runs["port"][degree][0][scenario]


def check_fingerprints(runs, degree, names):
    """Every rank shipped the same host arrays in the same steps."""
    ranks = runs["port"][degree]
    for name in names:
        prints = {(r[name]["fingerprint"], r[name]["steps"]) for r in ranks}
        assert len(prints) == 1 and ranks[0][name]["steps"] > 0, (name, prints)
