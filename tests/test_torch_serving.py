"""The port's ragged serving path against the JAX package's, on the CPU.

Weights come from the JAX ``TransformerLM.init`` (bias and norm leaves are
then perturbed with seeded numpy noise so every parameter matters) and
reach the port through ``load_jax_params``. Two configs: the GQA llama-style
``CFG`` of tests/unit/inference/test_ragged_serving.py, and a GPT-2-style
one (layernorm, learned positions, gelu, tied head, biases, MHA). Both run
in fp32.

* one ``build_ragged_step`` call on identical pools, tables and mixed rows
  gives the identical packed ``[R, W+1]`` output, logits within 1e-5 and
  the same pool writes (1e-5: the two frameworks sum matmuls in different
  orders; fp32 keeps that at a few ulps of values of order 1);
* ``serve()`` streams are byte-identical to the JAX ``PagedServer`` on the
  XLA path, through preemption (an undersized pool) and a warm second pass
  that attaches cached prefixes; both pools drain to zero used pages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import decode as jax_decode
from deepspeed_tpu.inference.scheduler import PagedServer as JaxServer
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models.config import TransformerConfig as JaxConfig
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.inference import decode
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

CONFIGS = {
    "llama_gqa": dict(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
        max_seq_len=64, norm="rmsnorm", position="rope", activation="swiglu",
        use_bias=False, tie_embeddings=False, flash_attention=False, dtype="float32",
    ),
    "gpt2_mha": dict(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
        norm="layernorm", position="learned", activation="gelu", use_bias=True,
        tie_embeddings=True, flash_attention=False, dtype="float32",
    ),
}
TOL = 1e-5
SERVE_KW = dict(page_size=8, max_slots=4, prefill_chunk=8, prefix_cache=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast and leaves the cores to
    the JAX tests running in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(name):
    """(jax cfg, port cfg, jax params, numpy tree) for one config."""
    jcfg = JaxConfig(**CONFIGS[name])
    params = JaxLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    rs = np.random.RandomState(7)

    def perturb(path, leaf):
        leaf = np.asarray(leaf, np.float32)
        name = path[-1].key
        if "norm" in name or name.startswith("b") or name.endswith("bias"):
            leaf = leaf + 0.05 * rs.randn(*leaf.shape).astype(np.float32)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, params)
    return jcfg, TransformerConfig(**CONFIGS[name]), jax.tree_util.tree_map(jnp.asarray, tree), tree


def _port_tree(cfg, tree):
    return load_jax_params(TransformerLM(cfg), tree, device="cpu").param_tree()


def _step_inputs(cfg, rs):
    """A mixed [R=4, W=8] window: a prefill chunk at start 0, a chunk
    mid-sequence, a decode row and a dead row, over random pools."""
    L, NKV, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    P, NP, maxp, R, W = 8, 20, cfg.max_seq_len // 8, 4, 8
    kp = rs.randn(L, NP, NKV, P, D).astype(np.float32)
    vp = rs.randn(L, NP, NKV, P, D).astype(np.float32)
    pt = np.full((R, maxp), -1, np.int32)
    pt[0, :1] = [3]
    pt[1, :3] = [7, 2, 11]
    pt[2, :4] = [5, 9, 13, 1]
    lengths = np.array([0, 16, 30, 0], np.int32)
    q_lens = np.array([8, 5, 1, 0], np.int32)
    tokens = rs.randint(0, cfg.vocab_size, (R, W)).astype(np.int32)
    return tokens, kp, vp, pt, lengths, q_lens


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ragged_step_matches_jax(name):
    jcfg, cfg, jparams, tree = _models(name)
    tokens, kp, vp, pt, lengths, q_lens = _step_inputs(cfg, np.random.RandomState(3))
    R, W = tokens.shape
    jstep = jax_decode.build_ragged_step(jcfg, R, W, 8, attn_impl="xla")
    j_out, j_k, j_v = jstep(jparams, jnp.asarray(tokens), jnp.asarray(kp), jnp.asarray(vp),
                            jnp.asarray(pt), jnp.asarray(lengths), jnp.asarray(q_lens))
    t = torch.from_numpy
    ptree = _port_tree(cfg, tree)
    k_t, v_t = t(kp.copy()), t(vp.copy())
    out = decode.build_ragged_step(cfg, W)(ptree, t(tokens), k_t, v_t, t(pt), t(lengths), t(q_lens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    # pool writes (page 0 is the trash page: duplicate writes, never read)
    np.testing.assert_allclose(k_t.numpy()[:, 1:], np.asarray(j_k)[:, 1:], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(v_t.numpy()[:, 1:], np.asarray(j_v)[:, 1:], rtol=TOL, atol=TOL)

    offs = np.arange(W, dtype=np.int32)
    positions = lengths[:, None] + offs[None, :]
    valid = offs[None, :] < q_lens[:, None]
    kv_lens = np.where(q_lens > 0, lengths + q_lens, 0).astype(np.int32)
    j_logits, _, _ = jax_decode._paged_forward(
        jcfg, jparams, jnp.asarray(tokens), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(positions), None, "xla", write_valid=jnp.asarray(valid),
        prefill_kv_lens=jnp.asarray(kv_lens), ragged_q_lens=jnp.asarray(q_lens),
    )
    logits = decode._paged_forward(
        cfg, ptree, t(tokens), t(kp.copy()), t(vp.copy()), t(pt), t(positions), "plain",
        write_valid=t(valid), kv_lens=t(kv_lens), q_lens=t(q_lens),
    )
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=TOL, atol=TOL)


def _prompts(cfg, n, seed):
    """Ragged prompts; half share a 17-token prefix (two full pages + 1)."""
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, cfg.vocab_size, (17,)).astype(np.int32)
    out = []
    for i in range(n):
        tail = rs.randint(0, cfg.vocab_size, (int(rs.randint(2, 14)),)).astype(np.int32)
        out.append(np.concatenate([shared, tail]) if i % 2 else tail)
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_serve_streams_match_jax(name):
    """Cold pass through an undersized pool (preemption in both), then a
    warm pass of the same prompts that attaches cached prefixes: every
    stream byte-identical to the JAX PagedServer (XLA path)."""
    jcfg, cfg, jparams, tree = _models(name)
    prompts = _prompts(cfg, 6, seed=2)
    budgets = [12, 3, 9, 14, 1, 7]
    kw = dict(SERVE_KW, num_pages=9)
    jserver = JaxServer(jcfg, jparams, attn_impl="xla", dtype=jnp.float32, **kw)
    server = PagedServer(cfg, _port_tree(cfg, tree), attn_impl="auto", dtype=torch.float32, device="cpu", **kw)
    for pass_ in ("cold", "warm"):
        ref = jserver.serve(prompts, max_new_tokens=budgets)
        outs = server.serve(prompts, max_new_tokens=budgets)
        for i, (a, b) in enumerate(zip(outs, ref)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{pass_} request {i}")
    stats, jstats = server.serve_stats(), jserver.serve_stats()
    assert stats["preempted"] > 0 and jstats["preempted"] > 0
    assert stats["prefix"]["prefix_hit_tokens"] > 0 and jstats["prefix"]["prefix_hit_tokens"] > 0
    for key in ("admitted", "preempted", "finished", "ragged_steps", "prefill_chunks", "emitted_tokens"):
        assert stats[key] == jstats[key], key
    assert stats["prefix"]["prefix_hit_tokens"] == jstats["prefix"]["prefix_hit_tokens"]
    assert server.pool.used_pages() == 0 and jserver.pool.used_pages() == 0
    assert server.pool.live_tokens() == 0
    server.pool.integrity_check()


def test_engine_serve_matches_jax_engine():
    """The user entry points: ``init_inference(..., device="cpu")`` +
    ``load_jax_params`` + ``serve`` against the JAX engine's ``serve`` on
    the same tree and paged_kv JSON (JAX names for attn_impl accepted)."""
    import deepspeed_tpu as ds

    jcfg, cfg, jparams, tree = _models("llama_gqa")
    paged = dict(SERVE_KW, attn_impl="xla")
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
    stats = engine.serve_stats()
    assert stats["finished"] == 10 and stats["prefix"]["prefix_hit_rate"] > 0
    assert stats["ragged_steps"] == jengine.serve_stats()["ragged_steps"]


def test_serve_eos_without_prefix_cache_matches_jax():
    """EOS retirement (the token is included and the slot frees at once)
    with prefix caching off: streams byte-identical to the JAX server."""
    jcfg, cfg, jparams, tree = _models("llama_gqa")
    prompts = _prompts(cfg, 5, seed=4)
    kw = dict(SERVE_KW, prefix_cache=False)
    jserver = JaxServer(jcfg, jparams, attn_impl="xla", dtype=jnp.float32, **kw)
    probe = jserver.serve(prompts[:1], max_new_tokens=6)[0]
    eos = int(probe[prompts[0].size + 2])  # request 0 stops at its third token
    ref = jserver.serve(prompts, max_new_tokens=12, eos_token_id=eos)
    server = PagedServer(cfg, _port_tree(cfg, tree), dtype=torch.float32, device="cpu", **kw)
    outs = server.serve(prompts, max_new_tokens=12, eos_token_id=eos)
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert outs[0].size == prompts[0].size + 3 and outs[0][-1] == eos
    assert server.serve_stats()["prefix"]["prefix_lookups"] == 0


def test_submit_rejects_bad_requests():
    _, cfg, _, tree = _models("llama_gqa")
    server = PagedServer(cfg, _port_tree(cfg, tree), dtype=torch.float32, device="cpu",
                         **dict(SERVE_KW, num_pages=5))
    with pytest.raises(ValueError, match="empty"):
        server.submit(np.zeros(0, np.int32))
    with pytest.raises(ValueError, match="max_new_tokens"):
        server.submit(np.ones(3, np.int32), max_new_tokens=0)
    with pytest.raises(ValueError, match="max_seq_len"):
        server.submit(np.ones(60, np.int32), max_new_tokens=8)
    with pytest.raises(ValueError, match="pages"):
        server.submit(np.ones(30, np.int32), max_new_tokens=8)  # 5 pages needed, 4 allocatable
    assert not server.has_work()


def test_engine_weights():
    """serve() before weights raises; a module whose weights are already
    real moves once to the engine's device and dtype."""
    _, cfg, _, tree = _models("llama_gqa")
    engine = dst.init_inference(TransformerLM(cfg), dtype="fp32", device="cpu")
    with pytest.raises(RuntimeError, match="weights"):
        engine.serve([np.ones(4, np.int32)], max_new_tokens=2)
    model = load_jax_params(TransformerLM(cfg), tree, device="cpu")
    engine = dst.init_inference(model, dtype="bf16", device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    out = engine.serve([np.arange(5, dtype=np.int32)], max_new_tokens=3)[0]
    assert out.shape == (8,) and (out[:5] == np.arange(5)).all()
    assert engine.serve_stats()["finished"] == 1 and engine._paged_server.pool.cache.k_pages.dtype == torch.bfloat16
