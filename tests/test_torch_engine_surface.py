"""The engine surface T2 left, against the JAX package on the CPU.

* ``set_train_batch_size`` (gas 2 -> 1), ``get_last_grads`` (the
  accumulator mid-step at gas 2; the recomputation on the last microbatch
  at gas 1, at the post-update parameters) and ``utils/tensor_fragment``
  (``parameter_names``, the fp32 master, the gradient, both Adam moments,
  and the setters followed by a step): one JAX engine
  (8-device CPU mesh, micro 1) against the port's (one rank, micro 8) along
  the same sequence, fp32, within 1e-5, on a one-layer GPT-2 form (four
  JAX compiles); the resize refusals;
* ``set_train_micro_batch_size``: bitwise an engine built at that micro
  batch, its refusals as JAX's;
* ``tensor_fragment`` over ZeRO stages 0-3 and the three offload engines
  (streamed, host Adam, layer stream): every getter equal to the stage-1
  engine's on the same run (the two host-Adam engines within 1e-5), the aliases
  ``m``/``v`` on the offload paths, the setters read back and trained
  through; over two gloo ranks at stages 2 and 3, each
  getter equal to the gathered state on both ranks and a set seen by both;

The remat API, ALiBi training and head_dim 80 are
``test_torch_training_variants.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import config as jax_model_config
from deepspeed_tpu.utils import tensor_fragment as jax_tf
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.utils import tensor_fragment as tf

GPT2 = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2, max_seq_len=128, dtype="float32",
            remat=False)
BASE = {"optimizer": {"type": "adam", "params": {"lr": 3e-4, "weight_decay": 0.01}}, "gradient_clipping": 1.0,
        "zero_optimization": {"stage": 1}}
NAMES = ("layers/wq", "embed/tokens", "final_norm_scale")
ONE = dict(GPT2, num_layers=1)  # the JAX engine's sequence: one layer keeps its four compiles short


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(model_kw=GPT2):
    return unflatten_tree(init_params(TransformerConfig(**model_kw), 0))


def _port(micro=8, gas=1, zero=None, model_kw=GPT2, **over):
    cfg = dict(BASE, train_micro_batch_size_per_gpu=micro, gradient_accumulation_steps=gas, **over)
    if zero is not None:
        cfg["zero_optimization"] = zero
    e, *_ = dst.initialize(model=TransformerLM(TransformerConfig(**model_kw)), config=cfg,
                           model_parameters=_tree(model_kw), device="cpu")
    return e


def _batches(n, rows=8, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rs.randint(0, GPT2["vocab_size"], (rows, 17)).astype(np.int32)
        out.append({"input_ids": t[:, :-1], "labels": t[:, 1:]})
    return out


def _cat(a, b):
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def _sequence(engine, tfm, data):
    """The resize / grads / fragments sequence both packages run: a gas-2
    step from a full batch, a gas-2 step driven per microbatch (the
    accumulator read after the first), a resize to gas 1 and a step (the
    recomputed gradient), the fragments, the setters and one more step."""
    rec = {"loss": [], "norm": []}
    rec["loss"].append(float(engine.train_batch(batch=_cat(data[0], data[1]))))
    rec["norm"].append(engine.get_global_grad_norm())
    for i, b in enumerate((data[2], data[3])):
        loss = engine(b)
        engine.backward(loss)
        engine.step()
        if i == 0:
            rec["acc_grad"] = {k: tfm.safe_get_full_grad(engine, k) for k in NAMES}
    rec["norm"].append(engine.get_global_grad_norm())
    with pytest.raises(ValueError, match="divisible"):
        engine.set_train_batch_size(12)
    engine.set_train_batch_size(8)
    assert (engine.gradient_accumulation_steps(), engine.train_batch_size()) == (1, 8)
    rec["loss"].append(float(engine.train_batch(batch=data[4])))
    rec["norm"].append(engine.get_global_grad_norm())
    rec["grad"] = {k: tfm.safe_get_full_grad(engine, k) for k in NAMES}
    rec["names"] = tfm.parameter_names(engine)
    rec["master"] = {k: tfm.safe_get_full_fp32_param(engine, k) for k in NAMES}
    rec["exp_avg"] = {k: tfm.safe_get_full_optimizer_state(engine, k, "exp_avg") for k in NAMES}
    rec["exp_avg_sq"] = {k: tfm.safe_get_full_optimizer_state(engine, k, "exp_avg_sq") for k in NAMES}
    assert tfm.safe_get_full_fp32_param(engine, "no/such") is None
    assert tfm.safe_set_full_fp32_param(engine, "layers/wq", rec["master"]["layers/wq"] * 0.5)
    assert tfm.safe_set_full_optimizer_state(engine, "embed/tokens", "exp_avg", rec["exp_avg"]["embed/tokens"] * 2.0)
    # on the card the aliases must name a state field: Adam's are exp_avg / exp_avg_sq (JAX's rule)
    assert tfm.safe_get_full_optimizer_state(engine, "embed/tokens", "m") is None
    rec["set_back"] = (tfm.safe_get_full_fp32_param(engine, "layers/wq"),
                       tfm.safe_get_full_optimizer_state(engine, "embed/tokens", "exp_avg"))
    rec["loss"].append(float(engine.train_batch(batch=data[5])))
    rec["final"] = {k: np.asarray(v) for k, v in flatten_tree(engine.get_master_params()).items()}
    return rec


@pytest.fixture(scope="module")
def jax_rec():
    je, *_ = ds.initialize(model=JaxLM(jax_model_config.TransformerConfig(**dict(ONE, flash_attention=False))),
                           config=dict(BASE, train_micro_batch_size_per_gpu=1, gradient_accumulation_steps=2),
                           model_parameters=_tree(ONE))
    return _sequence(je, jax_tf, _batches(6))


@pytest.fixture(scope="module")
def port_rec():
    return _sequence(_port(gas=2, model_kw=ONE), tf, _batches(6))


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=0, atol=atol)


def test_resize_and_last_grads_match_jax(jax_rec, port_rec):
    np.testing.assert_allclose(port_rec["loss"], jax_rec["loss"], rtol=1e-5)
    np.testing.assert_allclose(port_rec["norm"], jax_rec["norm"], rtol=1e-5)
    for k in NAMES:  # the accumulator (scaled, one microbatch) and the recomputation at gas 1
        _close(port_rec["acc_grad"][k], jax_rec["acc_grad"][k])
        _close(port_rec["grad"][k], jax_rec["grad"][k])
    for k, v in port_rec["final"].items():
        _close(v, jax_rec["final"][k])


def test_tensor_fragment_matches_jax(jax_rec, port_rec):
    assert port_rec["names"] == jax_rec["names"]
    for field in ("master", "exp_avg", "exp_avg_sq"):
        for k in NAMES:
            assert port_rec[field][k].dtype == np.float32
            _close(port_rec[field][k], jax_rec[field][k])
    for got, want in zip(port_rec["set_back"], jax_rec["set_back"]):
        _close(got, want)


def test_set_train_micro_batch_size_bitwise_a_fresh_engine():
    """A resized micro batch trains as an engine built with it; the resize
    refuses mid-step, mid-accumulation and on the offload paths (JAX's
    errors)."""
    data = _batches(3, rows=16, seed=2)
    e = _port(micro=8)
    e.train_batch(batch=_batches(1)[0])
    e.set_train_micro_batch_size(16)
    assert (e.train_micro_batch_size_per_gpu(), e.train_batch_size()) == (16, 16)
    ref = _port(micro=8)
    ref.train_batch(batch=_batches(1)[0])
    ref._config.train_micro_batch_size_per_gpu = ref._config.train_batch_size = 16
    for b in data:
        assert e.train_batch(batch=b) == ref.train_batch(batch=b)
    with pytest.raises(ValueError, match=">= 1"):
        e.set_train_micro_batch_size(0)
    loss = e(data[0])
    with pytest.raises(RuntimeError, match="mid-step"):
        e.set_train_micro_batch_size(8)
    e.backward(loss)
    e.step()
    g2 = _port(micro=8, gas=2)
    g2.backward(g2(_batches(1)[0]))
    g2.step()
    with pytest.raises(RuntimeError, match="accumulation window"):
        g2.set_train_batch_size(8)
    off = _port(zero={"stage": 1, "offload_optimizer": {"device": "cpu", "pipeline_read": True}})
    with pytest.raises(NotImplementedError, match="offload"):
        off.set_train_micro_batch_size(4)


# --- tensor_fragment over the stages and the offload engines ---------------------------------
ENGINES = {
    "stage 0": {"stage": 0},
    "stage 2": {"stage": 2},
    "stage 3": {"stage": 3},
    "streamed offload": {"stage": 1, "offload_optimizer": {"device": "cpu", "pipeline_read": True}},
    "host adam": {"stage": 2, "offload_optimizer": {"device": "cpu"}},
    "param offload": {"stage": 3, "offload_param": {"device": "cpu"}},
}


def _fragments(engine):
    return {(f, k): (tf.safe_get_full_fp32_param(engine, k) if f == "master"
                     else tf.safe_get_full_optimizer_state(engine, k, f))
            for f in ("master", "exp_avg", "exp_avg_sq") for k in NAMES}


@pytest.fixture(scope="module")
def stage1_frag():
    e = _port()
    for b in _batches(2):
        e.train_batch(batch=b)
    return _fragments(e)


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_tensor_fragment_over_stages_and_offload(stage1_frag, name):
    e = _port(zero=ENGINES[name])
    for b in _batches(2):
        e.train_batch(batch=b)
    got = _fragments(e)
    for key, want in stage1_frag.items():
        assert got[key].shape == want.shape and got[key].dtype == np.float32, key
        _close(got[key], want, atol=1e-5 if name in ("host adam", "param offload") else 0)
    assert tf.parameter_names(e) == tf.parameter_names(_port())
    value = got[("master", "layers/wq")] * 0.5
    moment = got[("exp_avg", "embed/tokens")] + 1e-3
    assert tf.safe_set_full_fp32_param(e, "layers/wq", value)
    assert tf.safe_set_full_optimizer_state(e, "embed/tokens", "exp_avg", moment)
    np.testing.assert_array_equal(tf.safe_get_full_fp32_param(e, "layers/wq"), value)
    np.testing.assert_array_equal(tf.safe_get_full_optimizer_state(e, "embed/tokens", "exp_avg"), moment)
    if "offload" in name or name == "host adam":  # JAX's offload paths resolve the torch-style aliases
        np.testing.assert_array_equal(tf.safe_get_full_optimizer_state(e, "embed/tokens", "m"), moment)
    wq = flatten_tree(e.get_params())["layers/wq"]  # the compute copy follows the master
    np.testing.assert_array_equal(wq, value)
    assert np.isfinite(e.train_batch(batch=_batches(1, seed=9)[0]))
    assert not np.array_equal(tf.safe_get_full_fp32_param(e, "layers/wq"), value)  # trained from the set value
    assert tf.safe_get_full_optimizer_state(e, "layers/wq", "nope") is None


@pytest.mark.parametrize("stage", [2, 3])
def test_tensor_fragment_gathers_over_two_ranks(tmp_path, stage):
    from torch_rank_group import join_ranks, start_ranks
    from torch_step_helpers import rank_fragments

    for res in join_ranks(start_ranks(rank_fragments, 2, str(tmp_path), stage), limit_s=120):
        assert res["set"] and all(all(res[k]) for k in NAMES), res
