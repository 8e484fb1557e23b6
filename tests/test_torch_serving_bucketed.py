"""The port's bucketed serving oracle (``PagedServer(ragged=False)``)
against the JAX package's, on the CPU.

Weights, configs and traffic as in tests/test_torch_serving.py (the Llama
GQA and GPT-2 MHA forms in fp32, ragged prompts half of which share a
17-token prefix). The JAX server runs its XLA paths; the port runs the
plain K5 and the plain prefill attention.

* streams byte-identical to the JAX bucketed server through preemption
  (an undersized pool) and a warm pass that attaches cached prefixes, with
  equal ``decode_steps``, ``prefill_chunks`` and ``dispatches``;
* the port's bucketed streams equal its own ragged streams (the oracle's
  contract);
* ``init_inference(..., paged_kv={"ragged": False, "slot_buckets": ...})``
  serves through ``engine.serve`` as the JAX engine does.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.scheduler import PagedServer as JaxServer
from deepspeed_tpu.models import TransformerLM as JaxLM
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.models import TransformerLM
from tests.test_torch_serving import CONFIGS, SERVE_KW, _models, _port_tree, _prompts

COUNTERS = ("admitted", "preempted", "finished", "prefill_chunks", "decode_steps", "dispatches",
            "emitted_tokens", "ragged_steps")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bucketed_streams_match_jax(name):
    """Cold pass through an undersized pool (preemption in both), then a
    warm pass attaching cached prefixes: every stream byte-identical to
    the JAX bucketed server, every step counter equal; the port's ragged
    server gives the same streams."""
    jcfg, cfg, jparams, tree = _models(name)
    prompts = _prompts(cfg, 6, seed=2)
    budgets = [12, 3, 9, 14, 1, 7]
    kw = dict(SERVE_KW, num_pages=9)
    jserver = JaxServer(jcfg, jparams, attn_impl="xla", dtype=jnp.float32, ragged=False, **kw)
    ptree = _port_tree(cfg, tree)
    server = PagedServer(cfg, ptree, dtype=torch.float32, device="cpu", ragged=False, **kw)
    ragged = PagedServer(cfg, ptree, dtype=torch.float32, device="cpu", **kw)
    for pass_ in ("cold", "warm"):
        ref = jserver.serve(prompts, max_new_tokens=budgets)
        outs = server.serve(prompts, max_new_tokens=budgets)
        outs_r = ragged.serve(prompts, max_new_tokens=budgets)
        for i, (a, b, c) in enumerate(zip(outs, ref, outs_r)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{pass_} request {i}")
            np.testing.assert_array_equal(a, c, err_msg=f"{pass_} request {i} vs ragged")
    stats, jstats = server.serve_stats(), jserver.serve_stats()
    assert stats["preempted"] > 0 and stats["prefix"]["prefix_hit_tokens"] > 0
    for key in COUNTERS:
        assert stats[key] == jstats[key], key
    assert stats["ragged_steps"] == 0 and stats["dispatches"] == stats["decode_steps"] + stats["prefill_chunks"]
    assert stats["prefix"]["prefix_hit_tokens"] == jstats["prefix"]["prefix_hit_tokens"]
    assert server.pool.used_pages() == 0 and server.pool.live_tokens() == 0
    server.pool.integrity_check()


def test_default_buckets_match_jax():
    from deepspeed_tpu.inference.scheduler import _default_buckets as jax_buckets
    from deepspeed_tpu_torch.inference.scheduler import _default_buckets

    for n in (1, 2, 3, 5, 8, 12):
        assert _default_buckets(n) == jax_buckets(n)


def test_engine_serves_bucketed_like_jax_engine():
    """``init_inference`` accepts ``paged_kv.ragged=False`` and a bucket
    list; ``engine.serve`` streams and counters match the JAX engine's."""
    import deepspeed_tpu as ds

    jcfg, cfg, jparams, tree = _models("llama_gqa")
    paged = dict(SERVE_KW, attn_impl="xla", ragged=False, slot_buckets=[2, 3])
    jengine = ds.init_inference(JaxLM(jcfg), dtype="fp32", paged_kv=paged)
    jengine.set_params(jparams)
    jengine._ds_config = jcfg  # the JAX converted-family contract for serve()
    engine = dst.init_inference(TransformerLM(cfg), dtype="fp32", paged_kv=paged, device="cpu")
    engine.load_jax_params(tree)
    prompts = _prompts(cfg, 5, seed=9)
    budgets = [6, 10, 4, 8, 5]
    for _ in range(2):
        ref = jengine.serve(prompts, max_new_tokens=budgets)
        outs = engine.serve(prompts, max_new_tokens=budgets)
        for a, b in zip(outs, ref):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert engine._paged_server.buckets == jengine._paged_server.buckets == [2, 3, 4]
    stats, jstats = engine.serve_stats(), jengine.serve_stats()
    assert stats["finished"] == 10
    for key in ("decode_steps", "prefill_chunks", "dispatches"):
        assert stats[key] == jstats[key], key
