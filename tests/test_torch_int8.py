"""The port's int8 serving weights and weight quantization (ROADMAP S8)
against the JAX package's, on the CPU.

* ``compression/int8.py``: ``quantize_weight_int8`` codes and scales
  array-equal to JAX's from fp32 and from bf16-rounded weights (2-D and
  stacked, an all-zero channel included); ``quantize_params_int8``
  quantizes the same paths; ``qmatmul`` against JAX's at 1e-6 in fp32 for
  2-D and stacked ``[L, in, out]`` weights; ``dequantize``,
  ``slice_out_channels``; the round-trip bound ``|w - deq| <=
  max|w_channel| / 254`` of tests/unit/inference/test_tp_serving.py:283;
* ``ops/quantizer``: every function against JAX's (codes equal, values to
  1e-6), and ``fake_quantize``'s gradient equal to ``jax.grad``'s
  straight-through one;
* serving: fp32 engines with ``paged_kv.sharded.weight_quant_bits=8``,
  ragged, with windows, bucketed and with an oracle drafter: greedy streams
  byte-identical to the JAX engine's (or the JAX server over JAX's
  ``quantize_params_int8`` tree, which is what its engine builds), with
  ``decode_steps``, ``dispatches`` and the window counts equal; only the
  server's tree is quantized;
* ``quant.enabled``: the engine's ``engine(tokens)`` logits within 1e-5 of
  the JAX engine's and its served streams identical;
* ``dtype="int8"`` stays refused.

The tiny llama-style GQA model of tests/test_torch_spec_decode.py, fp32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.compression import int8 as jax_int8
from deepspeed_tpu.inference.scheduler import PagedServer as JaxServer
from deepspeed_tpu.inference.spec_decode import Drafter as JaxDrafter
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models.config import TransformerConfig as JaxConfig
from deepspeed_tpu.ops import quantizer as jax_quantizer
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, load_jax_params
from deepspeed_tpu_torch.compression import int8
from deepspeed_tpu_torch.compression.int8 import QuantizedTensor
from deepspeed_tpu_torch.inference.decode import _forward_with_cache, init_cache, split_layers
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.inference.spec_decode import Drafter
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.ops import quantizer

CFG = dict(
    vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=64,
    norm="rmsnorm", position="rope", activation="swiglu", use_bias=False, tie_embeddings=False,
    flash_attention=False, dtype="float32",
)
PAGED = dict(page_size=8, max_slots=4, prefill_chunk=8)
INT8 = {"sharded": {"weight_quant_bits": 8}}
H = 4  # the window servers' horizon


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_MODEL = {}


def _model():
    """(jax cfg, port cfg, jax params, numpy tree), built once; the norm
    leaves carry seeded noise so quantizing them matters."""
    if not _MODEL:
        jcfg = JaxConfig(**CFG)
        params = JaxLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        rs = np.random.RandomState(3)

        def perturb(path, leaf):
            leaf = np.asarray(leaf, np.float32)
            if "norm" in path[-1].key:
                leaf = leaf + 0.05 * rs.randn(*leaf.shape).astype(np.float32)
            return leaf

        tree = jax.tree_util.tree_map_with_path(perturb, params)
        _MODEL["m"] = (jcfg, TransformerConfig(**CFG), jax.tree_util.tree_map(jnp.asarray, tree), tree)
    return _MODEL["m"]


def _prompts(n, seed=0, lo=3, hi=20):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, CFG["vocab_size"], (int(rs.randint(lo, hi)),)).astype(np.int32) for _ in range(n)]


def _weights(seed=1):
    rs = np.random.RandomState(seed)
    w2 = rs.standard_normal((64, 48)).astype(np.float32)
    w2[:, 5] = 0.0  # an all-zero channel: the scale floor
    w3 = (0.02 * rs.standard_normal((3, 64, 48))).astype(np.float32)
    return {"2d": w2, "stacked": w3}


# --- compression/int8.py -------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["2d", "stacked"])
def test_quantize_weight_int8_codes_and_scales_equal_jax(shape, dtype):
    w = _weights()[shape]
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    ref, got = jax_int8.quantize_weight_int8(jw), int8.quantize_weight_int8(tw)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert tuple(got.scale.shape) == w.shape[:-2] + (1, w.shape[-1])
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(int8.dequantize(got).numpy(), np.asarray(jax_int8.dequantize(ref)))


def test_quantize_weight_int8_refuses_vectors():
    with pytest.raises(ValueError, match="matmul weight"):
        int8.quantize_weight_int8(torch.ones(8))


def test_roundtrip_bound():
    """|w - dequantize(quantize(w))| <= max|w_channel| / 254 elementwise, and
    qmatmul equals the dequantize-then-matmul form."""
    _, _, _, tree = _model()
    w = np.array(tree["layers"]["wq"])  # stacked [L, H, NH*D]
    qt = int8.quantize_weight_int8(torch.from_numpy(w))
    deq = int8.dequantize(qt).numpy()
    bound = np.max(np.abs(w), axis=-2, keepdims=True) / 254.0 + 1e-7
    assert np.all(np.abs(w - deq) <= bound), np.max(np.abs(w - deq) / bound)
    h = torch.from_numpy(np.random.RandomState(5).standard_normal((3, w.shape[1])).astype(np.float32))
    fused = int8.qmatmul(h, QuantizedTensor(qt.q[0], qt.scale[0])).numpy()
    np.testing.assert_allclose(fused, h.numpy() @ deq[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["2d", "stacked", "plain", "plain_bf16_weight"])
def test_qmatmul_matches_jax(case):
    w = _weights()["2d" if case != "stacked" else "stacked"]
    rs = np.random.RandomState(2)
    h = rs.standard_normal((3, 5, 64) if case == "stacked" else (2, 5, 64)).astype(np.float32)
    if case.startswith("plain"):
        wdt = (jnp.bfloat16, torch.bfloat16) if case.endswith("bf16_weight") else (jnp.float32, torch.float32)
        jw, tw = jnp.asarray(w, wdt[0]), torch.from_numpy(w).to(wdt[1])
    else:
        jw, tw = jax_int8.quantize_weight_int8(w), int8.quantize_weight_int8(torch.from_numpy(w))
    ref = np.asarray(jax_int8.qmatmul(jnp.asarray(h), jw))
    got = int8.qmatmul(torch.from_numpy(h), tw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_slice_out_channels_matches_jax():
    w = _weights()["stacked"]
    for jw, tw in ((jnp.asarray(w), torch.from_numpy(w)),
                   (jax_int8.quantize_weight_int8(w), int8.quantize_weight_int8(torch.from_numpy(w)))):
        ref, got = jax_int8.slice_out_channels(jw, 8, 16), int8.slice_out_channels(tw, 8, 16)
        if isinstance(got, QuantizedTensor):
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
            np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quantize_params_int8_quantizes_the_same_paths_as_jax():
    jcfg, cfg, jparams, tree = _model()
    ref = jax_int8.quantize_params_int8(jparams)
    got = int8.quantize_params_int8(load_jax_params(TransformerLM(cfg), tree, device="cpu").param_tree())

    def paths(t, prefix=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update(paths(v, f"{prefix}{k}/"))
            else:
                out[f"{prefix}{k}"] = v
        return out

    rp, gp = paths(ref), paths(got)
    assert sorted(rp) == sorted(gp)
    quantized = sorted(p for p, v in rp.items() if isinstance(v, jax_int8.QuantizedTensor))
    assert quantized == sorted(p for p, v in gp.items() if isinstance(v, QuantizedTensor))
    assert "lm_head" in quantized and "layers/wq" in quantized and "embed/tokens" not in quantized
    for p in quantized:
        np.testing.assert_array_equal(gp[p].q.numpy(), np.asarray(rp[p].q))
        np.testing.assert_array_equal(gp[p].scale.numpy(), np.asarray(rp[p].scale))
    assert int8.quantize_params_int8(got)["layers"]["wq"] is got["layers"]["wq"]  # already quantized
    # a quantized stacked leaf splits per layer into (q[l], scale[l])
    layer = split_layers(got)[1]
    assert isinstance(layer["wq"], QuantizedTensor)
    np.testing.assert_array_equal(layer["wq"].q.numpy(), gp["layers/wq"].q[1].numpy())
    assert tuple(layer["wq"].scale.shape) == (1, gp["layers/wq"].shape[-1])


# --- ops/quantizer ---------------------------------------------------------------------------
def _x(seed=4, shape=(6, 32)):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    x[0, :16] = 0.0  # an all-zero group (scale 1)
    x[1, 16:] = 0.5  # a constant group (asymmetric: max == min)
    return x


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("fn", ["quantize", "swizzle_quant", "quantize_asymmetric", "Quantizer"])
def test_quantizer_functions_match_jax(fn, bits):
    x, groups = _x(), 12
    if fn == "Quantizer":
        ref = jax_quantizer.Quantizer(q_bits=bits, q_groups=groups).quantize(jnp.asarray(x))
        got = quantizer.Quantizer(q_bits=bits, q_groups=groups).quantize(torch.from_numpy(x))
    else:
        ref = getattr(jax_quantizer, fn)(jnp.asarray(x), groups, bits)
        got = getattr(quantizer, fn)(torch.from_numpy(x), groups, bits)
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got[0].numpy().astype(np.int64), np.asarray(ref[0]).astype(np.int64))  # codes
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    if fn == "quantize_asymmetric":
        deq = quantizer.dequantize_asymmetric(*got, shape=x.shape)
        jdeq = jax_quantizer.dequantize_asymmetric(*ref, shape=x.shape)
    else:
        deq = quantizer.dequantize(got[0], got[1], shape=x.shape)
        jdeq = jax_quantizer.dequantize(ref[0], ref[1], shape=x.shape)
    np.testing.assert_allclose(deq.numpy(), np.asarray(jdeq), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quantize_matches_jax_and_passes_the_gradient_straight_through(dtype):
    x, groups = _x(seed=6, shape=(4, 48)), 8
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    ref = jax_quantizer.fake_quantize(jx, groups)
    got = quantizer.fake_quantize(tx, groups)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=1e-6, atol=1e-6)
    g = np.random.RandomState(7).standard_normal(x.shape).astype(np.float32)
    jgrad = jax.grad(lambda v: jnp.sum(jax_quantizer.fake_quantize(v, groups) * jnp.asarray(g)))(jnp.asarray(x))
    leaf = torch.from_numpy(x).requires_grad_(True)
    (quantizer.fake_quantize(leaf, groups) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(leaf.grad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(leaf.grad.numpy(), g)  # straight through


def test_quantizer_refuses_uneven_groups():
    with pytest.raises(ValueError, match="divisible"):
        quantizer.quantize(torch.ones(10), 3)


# --- int8 serving ----------------------------------------------------------------------------
class OracleDrafter(Drafter):
    """Drafts each request's known future: acceptance is total."""

    def __init__(self, futures):
        self.futures = futures

    def propose(self, uid, context, k):
        return self.futures[uid][context.size:context.size + k].astype(np.int32)


class JaxOracle(JaxDrafter):
    def __init__(self, futures):
        self.futures = futures

    def propose(self, uid, context, k):
        return self.futures[uid][context.size:context.size + k].astype(np.int32)


def _port_engine(paged=None, **kw):
    _, cfg, _, tree = _model()
    eng = dst.init_inference(TransformerLM(cfg), dtype="fp32", device="cpu", paged_kv={**PAGED, **(paged or {})},
                             **kw)
    eng.load_jax_params(tree)
    return eng


_JAX_STREAMS = {}


def _jax_int8_engine_streams(prompts, budgets):
    """The JAX engine with ``weight_quant_bits=8``, ragged: its streams and
    stats, built once for the module (a JAX engine costs seconds of compile)."""
    if not _JAX_STREAMS:
        jcfg, _, jparams, _ = _model()
        jeng = ds.init_inference(JaxLM(jcfg), dtype="fp32", paged_kv={**PAGED, **INT8, "attn_impl": "xla"})
        jeng.set_params(jparams)
        jeng._ds_config = jcfg  # the JAX converted-family contract for serve()
        outs = [np.asarray(o) for o in jeng.serve(prompts, max_new_tokens=budgets)]
        assert isinstance(jeng._paged_server.params["layers"]["wq"], jax_int8.QuantizedTensor)
        _JAX_STREAMS["ragged"] = (outs, jeng.serve_stats())
    return _JAX_STREAMS["ragged"]


PROMPTS = _prompts(4, seed=9)
BUDGETS = [9, 12, 5, 7]
MODES = {
    "ragged": dict(paged={}, jax={}),
    "windows": dict(paged={"multi_step": {"enable": True, "horizon": H}},
                    jax={"multi_step": {"enable": True, "horizon": H}}),
    "bucketed": dict(paged={"ragged": False, "slot_buckets": [4]}, jax={"ragged": False, "slot_buckets": [4]}),
    "spec_oracle": dict(paged={}, jax={}),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_int8_engine_streams_match_jax(mode):
    ref, jstats = _jax_int8_engine_streams(PROMPTS, BUDGETS)
    eng = _port_engine({**INT8, **MODES[mode]["paged"]})
    srv = eng._paged_server = eng._build_paged_server()
    assert isinstance(srv.params["layers"]["wq"], QuantizedTensor)
    if mode == "ragged":
        jsrv_stats = jstats
    else:
        # the JAX engine builds exactly this: PagedServer over quantize_params_int8 of its tree
        jcfg, cfg, jparams, _ = _model()
        jkw = dict(PAGED, **MODES[mode]["jax"])
        if mode == "spec_oracle":
            # a drafter enters through the server (the engine's spec_decode knob is the n-gram drafter)
            futures = dict(enumerate(ref))
            jkw["drafter"] = JaxOracle(futures)
            srv = eng._paged_server = PagedServer(cfg, srv.params, device="cpu", drafter=OracleDrafter(futures),
                                                  **PAGED)
        jsrv = JaxServer(jcfg, jax_int8.quantize_params_int8(jparams), attn_impl="xla", dtype=jnp.float32, **jkw)
        jouts = jsrv.serve(PROMPTS, max_new_tokens=BUDGETS)
        for a, b in zip(jouts, ref):  # every mode serves the same int8 streams in JAX
            np.testing.assert_array_equal(np.asarray(a), b)
        jsrv_stats = jsrv.serve_stats()
    outs = srv.serve(PROMPTS, max_new_tokens=BUDGETS)
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, b)
    st = srv.serve_stats()
    keys = ["decode_steps", "dispatches", "emitted_tokens", "finished", "prefill_chunks", "window_steps",
            "ragged_steps", "spec_rounds", "spec_drafted", "spec_accepted"]
    assert {k: st[k] for k in keys} == {k: jsrv_stats[k] for k in keys}
    assert st["window_break_reasons"] == jsrv_stats["window_break_reasons"]
    if mode == "windows":
        assert st["window_steps"] > 0
    if mode == "spec_oracle":
        assert st["spec_accepted"] == st["spec_drafted"] > 0
    srv.pool.integrity_check()
    assert srv.pool.used_pages() == 0


def test_int8_switch_quantizes_only_the_server_tree():
    """forward and generate keep the engine's weights, as in JAX; the
    quantized server shares the exact leaves (embeddings, norms)."""
    eng = _port_engine(INT8)
    plain = _port_engine()
    toks = np.asarray(PROMPTS[1][None, :8])
    np.testing.assert_array_equal(eng(toks).numpy(), plain(toks).numpy())
    np.testing.assert_array_equal(eng.generate(toks, max_new_tokens=4).numpy(),
                                  plain.generate(toks, max_new_tokens=4).numpy())
    eng.serve(PROMPTS[:1], max_new_tokens=3)
    params = eng._paged_server.params
    assert isinstance(params["lm_head"], QuantizedTensor)
    assert params["embed"]["tokens"] is eng.module.param_tree()["embed"]["tokens"]
    assert not isinstance(eng.module.param_tree()["lm_head"], QuantizedTensor)
    assert int8.tree_nbytes(params) < int8.tree_nbytes(eng.module.param_tree())


def test_int8_streams_differ_from_plain_only_through_the_weights():
    """The int8 server is not the plain server under another name: the
    quantized projections move the logits (the streams are compared with
    JAX's int8 ones above, not with the plain ones)."""
    eng, plain = _port_engine(INT8), _port_engine()
    srv = eng._build_paged_server()
    psrv = plain._build_paged_server()
    _, cfg, _, _ = _model()
    toks = torch.from_numpy(PROMPTS[1][None])
    logits = [
        _forward_with_cache(cfg, s.params, toks, init_cache(cfg, 1, 32, dtype=torch.float32, device="cpu"), 0)[0]
        for s in (srv, psrv)
    ]
    diff = (logits[0] - logits[1]).abs().max().item()
    assert 0 < diff <= 1e-2 * logits[1].abs().max().item()


# --- quant.enabled -----------------------------------------------------------------------------
def test_quant_enabled_engine_matches_jax_engine():
    jcfg, cfg, jparams, tree = _model()
    quant = {"enabled": True, "group_size": 64, "num_bits": 8}
    jeng = ds.init_inference(JaxLM(jcfg), dtype="fp32", quant=quant, paged_kv={**PAGED, "attn_impl": "xla"})
    jeng.set_params(jparams)
    jeng._ds_config = jcfg
    eng = dst.init_inference(TransformerLM(cfg), dtype="fp32", device="cpu", quant=quant, paged_kv=PAGED)
    eng.load_jax_params(tree)
    # every floating leaf of rank >= 2 took the round trip, the rest is the tree as given
    got = flatten_tree(eng.module.param_tree())
    for path, leaf in flatten_tree(tree).items():
        changed = not np.array_equal(got[path].numpy(), leaf)
        assert changed == (np.ndim(leaf) >= 2), path
    toks = np.random.RandomState(12).randint(0, CFG["vocab_size"], (2, 16)).astype(np.int32)
    np.testing.assert_allclose(eng(toks).numpy(), np.asarray(jeng(jnp.asarray(toks))), rtol=1e-5, atol=1e-5)
    outs, ref = eng.serve(PROMPTS[:2], max_new_tokens=6), jeng.serve(PROMPTS[:2], max_new_tokens=6)
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_int8_dtype_stays_refused():
    _, cfg, _, _ = _model()
    with pytest.raises(NotImplementedError, match="not quantization"):
        dst.init_inference(TransformerLM(cfg), dtype="int8", device="cpu")
