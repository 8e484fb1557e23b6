"""The port's ``InferenceEngine.forward`` against the JAX engine's, and the
inference switches the port refuses, on the CPU.

A tiny Llama-form ``TransformerLM`` (2 layers, width 64, RoPE, RMSNorm,
SwiGLU, GQA 4/2) in fp32; the weights come from the JAX init with seeded
noise on the norm leaves and reach the port through ``load_jax_params``.
One JAX engine is built for the module (its forward compiles once per
batch form).

* ``engine(tokens)``, ``engine((tokens, labels))``,
  ``engine({"input_ids": ...})`` and ``engine(tokens, labels)`` against the
  JAX engine's forward at 1e-5 (the frameworks sum matmuls in other orders;
  fp32 keeps that at a few ulps of values of order 1);
* ``model_times()`` gets one entry per forward with profiling on;
* ``forward`` before weights are set raises;
* each of ``analysis.verify`` and ``tracing.flight_recorder`` raises
  ``NotImplementedError`` naming its ROADMAP item; the default config and
  ``save_mp_checkpoint_path`` (ported: ``test_torch_mp_checkpoint.py``)
  build an engine.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models.config import TransformerConfig as JaxConfig
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

CONFIG = dict(
    vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=64,
    norm="rmsnorm", position="rope", activation="swiglu", use_bias=False, tie_embeddings=False,
    flash_attention=False, dtype="float32",
)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the same seeded tree, built once."""
    jcfg = JaxConfig(**CONFIG)
    params = JaxLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    rs = np.random.RandomState(3)

    def perturb(path, leaf):
        leaf = np.asarray(leaf, np.float32)
        if "norm" in path[-1].key:
            leaf = leaf + 0.05 * rs.randn(*leaf.shape).astype(np.float32)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, params)
    jengine = ds.init_inference(JaxLM(jcfg), dtype="fp32")
    jengine.set_params(jax.tree_util.tree_map(jnp.asarray, tree))
    engine = dst.init_inference(TransformerLM(TransformerConfig(**CONFIG)), dtype="fp32", device="cpu")
    engine.load_jax_params(tree)
    return jengine, engine


def _batch(seed=0, B=2, T=16):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, CONFIG["vocab_size"], (B, T + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


FORMS = {
    "tokens": lambda t, l: ((t,), {}),
    "tokens_labels_tuple": lambda t, l: (((t, l),), {}),
    "input_ids_dict": lambda t, l: (({"input_ids": t},), {}),
    "input_ids_labels_dict": lambda t, l: (({"input_ids": t, "labels": l},), {}),
    "tokens_labels_args": lambda t, l: ((t, l), {}),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_forward_matches_jax_engine(engines, form):
    """Logits ``[B, T, V]`` without labels, the scalar loss with them."""
    jengine, engine = engines
    tokens, labels = _batch(seed=1)
    args, kwargs = FORMS[form](tokens, labels)
    ref = np.asarray(jengine(*args, **kwargs))
    out = engine(*args, **kwargs)
    has_labels = "labels" in form
    assert out.shape == (() if has_labels else (2, 16, CONFIG["vocab_size"]))
    assert out.dtype == torch.float32 and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_forward_takes_torch_tensors_and_matches_apply(engines):
    _, engine = engines
    tokens, _ = _batch(seed=2)
    t = torch.from_numpy(tokens)
    out = engine.forward(t)
    ref = engine.module.apply(engine.module.param_tree(), t, train=False)
    assert torch.equal(out, ref)


def test_model_times_one_entry_per_forward(engines):
    _, engine = engines
    tokens, labels = _batch(seed=4)
    engine.profile_model_time()
    engine(tokens)
    engine((tokens, labels))
    times = engine.model_times()
    assert len(times) == 2 and all(t > 0 for t in times)
    assert engine.model_times() == []


def test_forward_before_weights_raises():
    engine = dst.init_inference(TransformerLM(TransformerConfig(**CONFIG)), dtype="fp32", device="cpu")
    with pytest.raises(RuntimeError, match="before weights are set"):
        engine(_batch()[0])


REFUSED = {
    "analysis.verify": ({"analysis": {"verify": "warn"}}, "ROADMAP X1"),
    "tracing.flight_recorder": ({"tracing": {"flight_recorder": True, "flight_recorder_dir": "/nonexistent"}},
                                "ROADMAP X1"),
    "save_mp_checkpoint_path": ({"save_mp_checkpoint_path": "mp_ckpt"}, None),
    "default": ({"analysis": {"verify": "off"}, "tracing": {"flight_recorder": False}}, None),
}


@pytest.mark.parametrize("switch", sorted(REFUSED))
def test_unported_inference_switches_raise(switch):
    """Each unported switch JAX acts on raises ``NotImplementedError``
    naming its ROADMAP item; their off values, the default config and the
    ported ``save_mp_checkpoint_path`` build."""
    config, item = REFUSED[switch]
    model = TransformerLM(TransformerConfig(**CONFIG))
    if item is None:
        assert dst.init_inference(model, config=config, device="cpu") is not None
        assert dst.init_inference(model, device="cpu") is not None
        return
    with pytest.raises(NotImplementedError, match=switch.replace(".", r"\.") + ".*" + item):
        dst.init_inference(model, config=config, device="cpu")
