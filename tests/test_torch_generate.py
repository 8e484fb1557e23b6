"""The port's dense KV-cached ``generate`` and ``beam_generate`` against the
JAX package's, on the CPU.

Two fp32 models (``dtype="float32"`` in the model config: the cache takes
its dtype from there, as in JAX): a Llama form (RoPE, RMSNorm, SwiGLU, GQA
4/2) and a GPT-2 form (learned positions, LayerNorm, biases, tied head,
MHA). Weights come from the JAX init with seeded noise on the norm and
bias leaves, and reach the port through ``load_jax_params``. The JAX side
runs its K6 Pallas kernel in interpret mode wherever the cache length is
a multiple of 256; the port runs K6's plain version there.

* greedy streams token for token at ``S = 256`` (prompt 240 + 16 new: the
  K6 branch) and ``S = 16`` (the einsum branch), for both forms;
* ``_forward_with_cache`` logits within 1e-5 (the frameworks sum matmuls in
  other orders; fp32 keeps that at a few ulps of values of order 1);
* EOS: the same output shape and tokens, with and without early exit;
* beam search with 4 beams token for token, with and without EOS, and one
  beam equal to greedy;
* ``engine.generate`` against the JAX engine (``_ds_config`` set), also
  with fp32 weights under a bf16 model config, the
  ``num_beams`` + sampling ``ValueError``, seeded sampling reproducible and
  ``top_k=1`` equal to greedy, ``model_times``;
* K6 is reached exactly ``num_layers x max_new_tokens`` times per greedy
  call at ``S = 256`` and never at ``S = 16``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import decode as jax_decode
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models.config import TransformerConfig as JaxConfig
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.inference import decode
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

CONFIGS = {
    "llama_gqa": dict(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
        max_seq_len=256, norm="rmsnorm", position="rope", activation="swiglu",
        use_bias=False, tie_embeddings=False, flash_attention=False, dtype="float32",
    ),
    "gpt2_mha": dict(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=256,
        norm="layernorm", position="learned", activation="gelu", use_bias=True,
        tie_embeddings=True, flash_attention=False, dtype="float32",
    ),
}
SHAPES = {"S=256": (240, 16), "S=16": (8, 8)}  # (prompt_len, max_new_tokens)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_MODELS = {}


def _models(name):
    """(jax cfg, port cfg, jax params, port param tree) for one config."""
    if name not in _MODELS:
        jcfg = JaxConfig(**CONFIGS[name])
        params = JaxLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        rs = np.random.RandomState(7)

        def perturb(path, leaf):
            leaf = np.asarray(leaf, np.float32)
            key = path[-1].key
            if "norm" in key or key.startswith("b") or key.endswith("bias"):
                leaf = leaf + 0.05 * rs.randn(*leaf.shape).astype(np.float32)
            return leaf

        tree = jax.tree_util.tree_map_with_path(perturb, params)
        cfg = TransformerConfig(**CONFIGS[name])
        ptree = load_jax_params(TransformerLM(cfg), tree, device="cpu").param_tree()
        _MODELS[name] = (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree), ptree, tree)
    return _MODELS[name]


def _prompts(B, n, seed=0, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, (B, n)).astype(np.int32)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_matches_jax(name, shape):
    jcfg, cfg, jparams, ptree, _ = _models(name)
    plen, new = SHAPES[shape]
    prompts = _prompts(2, plen)
    ref = np.asarray(jax_decode.generate(jcfg, jparams, prompts, new))
    out = decode.generate(cfg, ptree, prompts, new)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_with_cache_matches_jax(name):
    """Prefill logits, then one decode step at S = 256 (K6's branch)."""
    jcfg, cfg, jparams, ptree, _ = _models(name)
    prompts = _prompts(2, 30, seed=1)
    forward = jax.jit(lambda params, tokens, cache, pos: jax_decode._forward_with_cache(
        jcfg, params, tokens, cache, pos))
    jcache = jax_decode.init_cache(jcfg, 2, 256)
    j_logits, jcache = forward(jparams, jnp.asarray(prompts), jcache, jnp.int32(0))
    prefill, decode_step = decode.build_decoder(cfg)
    cache = decode.init_cache(cfg, 2, 256, device="cpu")
    logits, cache = prefill(ptree, torch.from_numpy(prompts), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=TOL, atol=TOL)
    tok = np.argmax(np.asarray(j_logits), -1).astype(np.int32)
    j_logits, jcache = forward(jparams, jnp.asarray(tok)[:, None], jcache, jnp.int32(30))
    logits, cache = decode_step(ptree, torch.from_numpy(tok), cache, 30)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(cache.k.numpy()[:, :, :31], np.asarray(jcache.k)[:, :, :31], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(cache.v.numpy()[:, :, :31], np.asarray(jcache.v)[:, :, :31], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rows", [1, 2])
def test_eos_matches_jax(rows):
    """EOS = the token row 0 emits third: with one row the loop exits early;
    with two, row 0 pads with EOS while row 1 runs on."""
    jcfg, cfg, jparams, ptree, _ = _models("llama_gqa")
    prompts = _prompts(rows, 8, seed=2)
    eos = int(decode.generate(cfg, ptree, prompts, 8)[0, 8 + 2])
    ref = np.asarray(jax_decode.generate(jcfg, jparams, prompts, 8, eos_token_id=eos))
    out = decode.generate(cfg, ptree, prompts, 8, eos_token_id=eos).numpy()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    if rows == 1:
        assert out.shape[1] < 16 and out[0, -1] == eos


BEAM_CASES = {  # (config, shape, eos from greedy's step)
    "llama S=16": ("llama_gqa", "S=16", None),
    "llama S=16 eos": ("llama_gqa", "S=16", 1),
    "gpt2 S=256": ("gpt2_mha", "S=256", None),
}


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_matches_jax(case):
    name, shape, eos_step = BEAM_CASES[case]
    jcfg, cfg, jparams, ptree, _ = _models(name)
    plen, new = SHAPES[shape]
    prompts = _prompts(2, plen, seed=3)
    eos = None if eos_step is None else int(decode.generate(cfg, ptree, prompts, new)[0, plen + eos_step])
    ref = np.asarray(jax_decode.beam_generate(jcfg, jparams, prompts, new, num_beams=4, eos_token_id=eos))
    out = decode.beam_generate(cfg, ptree, prompts, new, num_beams=4, eos_token_id=eos).numpy()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_one_beam_is_greedy():
    _, cfg, _, ptree, _ = _models("llama_gqa")
    prompts = _prompts(2, 8, seed=4)
    assert torch.equal(decode.beam_generate(cfg, ptree, prompts, 8, num_beams=1),
                       decode.generate(cfg, ptree, prompts, 8))


def test_k6_reached_per_layer_per_token(monkeypatch):
    """Greedy at S = 256 takes K6's branch once per layer per new token (the
    last sampled token's forward included); S = 16 never does."""
    _, cfg, _, ptree, _ = _models("gpt2_mha")
    calls = []
    real = decode.decode_attention

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(decode, "decode_attention", counted)
    decode.generate(cfg, ptree, _prompts(2, 240, seed=5), 16)
    assert len(calls) == cfg.num_layers * 16
    calls.clear()
    decode.generate(cfg, ptree, _prompts(2, 8, seed=5), 8)
    assert not calls


def _engines(name="llama_gqa"):
    import deepspeed_tpu as ds

    jcfg, cfg, jparams, _, tree = _models(name)
    jengine = ds.init_inference(JaxLM(jcfg), dtype="fp32")
    jengine.set_params(jparams)
    jengine._ds_config = jcfg  # the JAX converted-family contract for the KV-cached generate
    engine = dst.init_inference(TransformerLM(cfg), dtype="fp32", device="cpu")
    engine.load_jax_params(tree)
    return jengine, engine


def test_engine_generate_matches_jax_engine():
    jengine, engine = _engines()
    prompts = _prompts(2, 8, seed=6)
    np.testing.assert_array_equal(engine.generate(prompts, max_new_tokens=8).numpy(),
                                  np.asarray(jengine.generate(prompts, max_new_tokens=8)))
    np.testing.assert_array_equal(engine.generate(prompts, max_new_tokens=8, num_beams=4).numpy(),
                                  np.asarray(jengine.generate(prompts, max_new_tokens=8, num_beams=4)))
    for e in (jengine, engine):
        with pytest.raises(ValueError, match="deterministic"):
            e.generate(prompts, max_new_tokens=4, num_beams=2, temperature=0.7)


def test_engine_generate_fp32_weights_bf16_model_matches_jax_engine():
    """Engine dtype fp32 with a bf16 model config: the activations and the
    dense cache are bf16, the weights fp32, cast at each matmul as JAX does.
    Greedy, S = 16 (einsum branch) and S = 256 (K6 branch)."""
    import deepspeed_tpu as ds

    _, _, _, _, tree = _models("llama_gqa")
    conf = dict(CONFIGS["llama_gqa"], dtype="bfloat16")
    jengine = ds.init_inference(JaxLM(JaxConfig(**conf)), dtype="fp32")
    jengine.set_params(jax.tree_util.tree_map(jnp.asarray, tree))
    jengine._ds_config = JaxConfig(**conf)
    engine = dst.init_inference(TransformerLM(TransformerConfig(**conf)), dtype="fp32", device="cpu")
    engine.load_jax_params(tree)
    assert engine.module.param_tree()["layers"]["wq"].dtype == torch.float32
    for plen, new in (SHAPES["S=16"], SHAPES["S=256"]):
        prompts = _prompts(2, plen, seed=8)
        np.testing.assert_array_equal(engine.generate(prompts, max_new_tokens=new).numpy(),
                                      np.asarray(jengine.generate(prompts, max_new_tokens=new)))


def test_engine_sampling_and_model_times():
    _, engine = _engines()
    prompts = _prompts(2, 8, seed=7)
    greedy = engine.generate(prompts, max_new_tokens=8)
    assert torch.equal(engine.generate(prompts, max_new_tokens=8, temperature=1.0, top_k=1), greedy)
    _, cfg, _, ptree, _ = _models("llama_gqa")
    draws = [decode.generate(cfg, ptree, prompts, 8, temperature=1.0, top_p=0.9,
                             generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (2, 16)
    engine.profile_model_time()
    engine.generate(prompts, max_new_tokens=4, temperature=0.8, top_k=10)
    times = engine.model_times()
    assert len(times) == 1 and times[0] > 0 and engine.model_times() == []
