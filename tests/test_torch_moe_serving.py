"""The port's MoE serving against the JAX package's, on the CPU.

A tiny top-2 ``moe_llama`` (2 layers, width 64, 4 experts, GQA 4/2) in
fp32 whose eval capacity (factor 1, the program's B·T tokens over 4
experts, doubled for top-2) drops tokens, so each step's output depends on
the rows packed beside it: the port must pack its rows as JAX does.

* ``PagedServer`` ragged (K4's plain version), its multi-step windows and
  the bucketed oracle (K5's plain version and the prefill chunks), each
  through an undersized pool (preemption) and a warm pass over cached
  prefixes: every stream byte-identical to the JAX ``PagedServer`` (its
  XLA paths), in fp32, and ragged with int8 expert and attention weights
  (``quantize_params_int8``: ``[E, 1, I]`` scales);
* the inference engine: the eval loss within 1e-5 of the JAX engine's,
  greedy ``generate`` token for token, beam search runs;
* an interleaved (``moe_layer_freq`` 2) tree is refused by paged serving,
  as in JAX.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.compression.int8 import quantize_params_int8 as jax_quantize
from deepspeed_tpu.inference.scheduler import PagedServer as JaxServer
from deepspeed_tpu.models import moe_transformer as jmt
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params, unflatten_tree
from deepspeed_tpu_torch.compression.int8 import quantize_params_int8
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.models import moe_transformer as pmt
from deepspeed_tpu_torch.models.transformer import init_params

MOE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=64,
           flash_attention=False, dtype="float32", num_experts=4, moe_top_k=2, eval_capacity_factor=1.0,
           min_capacity=2, intermediate_size=96)
SERVE_KW = dict(page_size=8, max_slots=4, prefill_chunk=8, prefix_cache=True, num_pages=9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _tree():
    cfg = pmt.moe_llama_config("tiny", **MOE)
    return cfg, unflatten_tree(init_params(cfg, 0))


def _prompts(n=6, seed=2):
    """Ragged prompts; half share a 17-token prefix."""
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, 128, (17,)).astype(np.int32)
    return [np.concatenate([shared, t]) if i % 2 else t
            for i, t in enumerate(rs.randint(0, 128, (int(rs.randint(2, 14)),)).astype(np.int32) for _ in range(n))]


def _port_params(cfg, tree, int8):
    params = load_jax_params(pmt.MoETransformerLM(cfg), tree, device="cpu").param_tree()
    return quantize_params_int8(params) if int8 else params


SERVERS = {
    "ragged": dict(),
    "ragged-windows": dict(multi_step={"enable": True, "horizon": 4}),
    "bucketed": dict(ragged=False),
    "ragged-int8": dict(int8=True),
}


@pytest.mark.parametrize("name", sorted(SERVERS))
def test_moe_serve_streams_match_jax(name):
    kw = dict(SERVERS[name])
    int8 = kw.pop("int8", False)
    multi = kw.pop("multi_step", None)
    cfg, tree = _tree()
    jcfg = jmt.moe_llama_config("tiny", **MOE)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    if int8:
        jparams = jax_quantize(jparams)
    if multi is not None:
        kw["multi_step"] = multi
    jserver = JaxServer(jcfg, jparams, attn_impl="xla", dtype=jnp.float32, **kw, **SERVE_KW)
    server = PagedServer(cfg, _port_params(cfg, tree, int8), dtype=torch.float32, device="cpu", **kw, **SERVE_KW)
    prompts, budgets = _prompts(), [12, 3, 9, 14, 1, 7]
    for pass_ in ("cold", "warm"):
        ref = jserver.serve(prompts, max_new_tokens=budgets)
        outs = server.serve(prompts, max_new_tokens=budgets)
        for i, (a, b) in enumerate(zip(outs, ref)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{pass_} request {i}")
    stats = server.serve_stats()
    assert stats["preempted"] > 0 and stats["prefix"]["prefix_hit_tokens"] > 0
    if multi is not None:
        assert stats["window_steps"] > 0


def test_moe_inference_engine_loss_and_generate_match_jax():
    """The engine's eval loss within 1e-5 (fp32, other summation orders);
    greedy generate of 6 tokens token for token; beam search returns its
    shape."""
    cfg, tree = _tree()
    jengine = ds.init_inference(jmt.MoETransformerLM(jmt.moe_llama_config("tiny", **MOE)), dtype="fp32")
    jengine.set_params(jax.tree_util.tree_map(jnp.asarray, tree))
    engine = dst.init_inference(pmt.MoETransformerLM(cfg), dtype="fp32", device="cpu")
    engine.load_jax_params(tree)
    rs = np.random.RandomState(1)
    toks = rs.randint(0, 128, (2, 17)).astype(np.int32)
    np.testing.assert_allclose(float(engine(toks[:, :-1], toks[:, 1:])), float(jengine(toks[:, :-1], toks[:, 1:])),
                               rtol=1e-5)
    prompt = toks[:, :8]
    ref = np.asarray(jengine.generate(jnp.asarray(prompt), max_new_tokens=6))
    out = engine.generate(torch.from_numpy(prompt), max_new_tokens=6)
    np.testing.assert_array_equal(out.numpy(), ref)
    beams = engine.generate(torch.from_numpy(prompt), max_new_tokens=4, num_beams=2)
    assert tuple(beams.shape) == (2, 12)


def test_interleaved_moe_serving_is_refused_as_jax():
    cfg = pmt.moe_llama_config("tiny", **dict(MOE, moe_layer_freq=2))
    params = load_jax_params(pmt.MoETransformerLM(cfg), unflatten_tree(init_params(cfg, 0)), device="cpu")
    with pytest.raises(NotImplementedError, match="moe_layer_freq == 1"):
        PagedServer(cfg, params.param_tree(), dtype=torch.float32, device="cpu", **SERVE_KW)
