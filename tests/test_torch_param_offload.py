"""Parameter offload (ZeRO-Infinity layer streaming) and ZeRO-Inference
against the JAX package's ``ParamStreamEngine`` and the port's own paths.

The model is the tiny GPT-2 of ``test_torch_training.py`` (2 layers,
hidden 64, T = 16, micro 8), fp32.

* ``offload_param`` ``cpu`` against JAX's engine (one device, micro 8,
  flash off) over 4 steps: losses, grad norms and the master within 1e-5;
  ``nvme`` and ``cpu_checkpointing`` (the stash on the host) bitwise the
  ``cpu`` run; against the port's on-device stage 3 within 1e-5; with
  dropout on (port only) ``cpu`` and ``nvme`` bitwise, within 1e-5 of the
  on-device stage 3 (the recompute redraws the forward's masks);
* ZeRO-Inference (``init_inference(zero=...)``): logits against JAX's
  ZeRO-Inference engine within 1e-5 and bitwise the port's in-memory
  engine; greedy ``generate`` token for token JAX's, and the in-memory
  ``generate``'s; no moments made, refusals;
* checkpoints: a JAX ``param_stream`` tag resumed by the port and a port
  tag resumed by JAX, each within 1e-5 of the other's run;
  ``zero_to_fp32`` of both equal to JAX's; the port's loads refusing
  what JAX refuses.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree
from deepspeed_tpu_torch.models import TransformerLM
from deepspeed_tpu_torch.models.config import TransformerConfig
from deepspeed_tpu_torch.models.transformer import init_params
from torch_ckpt_convert import jax_tag_to_port, port_tag_to_jax

GPT2 = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2, max_seq_len=128, dtype="float32", remat=False)
LR = 3e-4
BASE = {"train_micro_batch_size_per_gpu": 8, "optimizer": {"type": "adam", "params": {"lr": LR, "weight_decay": 0.01}},
        "gradient_clipping": 0.1, "steps_per_print": 10**6}
PARAM_CPU = {"stage": 3, "offload_param": {"device": "cpu"}}
STEPS, AT = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(model_kw=GPT2):
    return unflatten_tree(init_params(TransformerConfig(**model_kw), 0))


def _batches(n, rows=8, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rs.randint(0, GPT2["vocab_size"], (rows, 17)).astype(np.int32)
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _port(zero, model_kw=GPT2, extra=None):
    return dst.initialize(model=TransformerLM(TransformerConfig(**model_kw)),
                          config=dict(BASE, zero_optimization=zero, **(extra or {})),
                          model_parameters=_tree(model_kw), device="cpu")[0]


def _train(engine, batches):
    return [(engine.train_batch(batch=b), engine.get_global_grad_norm()) for b in batches]


def _master(engine):
    return flatten_tree(engine.get_master_params())


def _one_device_mesh():
    import jax

    from deepspeed_tpu.parallel import mesh as mesh_mod
    from deepspeed_tpu.runtime.config import MeshConfig

    return mesh_mod.initialize_topology(MeshConfig(data=1), devices=jax.devices()[:1])


def _jax_lm():
    from deepspeed_tpu.models import TransformerLM as JaxLM
    from deepspeed_tpu.models import config as jax_model_config

    return JaxLM(jax_model_config.TransformerConfig(**dict(GPT2, flash_attention=False)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's param-stream training (4 steps, a save after 2, then the
    port's tag resumed) and JAX's ZeRO-Inference logits and greedy
    streams; the port's runs beside them."""
    import jax

    import deepspeed_tpu as ds
    from deepspeed_tpu.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint as jax_fp32
    from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

    tmp = str(tmp_path_factory.mktemp("param_offload"))
    batches = _batches(STEPS)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _one_device_mesh()
        je = ds.initialize(model=_jax_lm(), config=dict(BASE, zero_optimization=PARAM_CPU, mesh={"data": 1}),
                           model_parameters=_tree())[0]
        jrec = _train(je, batches[:AT])
        je.save_checkpoint(os.path.join(tmp, "jax"), tag="j")
        jrec += _train(je, batches[AT:])
        jmaster = flatten_tree(jax.tree_util.tree_map(np.asarray, je.get_master_params()))
        pe = _port(PARAM_CPU)
        prec = _train(pe, batches[:AT])
        pe.save_checkpoint(os.path.join(tmp, "port"), tag="p")
        prec += _train(pe, batches[AT:])
        jax_tag_to_port(os.path.join(tmp, "jax"), "j", os.path.join(tmp, "j2p"), mesh={"data": 1})
        p2 = _port(PARAM_CPU)
        p2.load_checkpoint(os.path.join(tmp, "j2p"), tag="j")
        p_from_j = _train(p2, batches[AT:])
        mesh = dict(zip(je.mesh.axis_names, map(int, je.mesh.devices.shape)))
        port_tag_to_jax(os.path.join(tmp, "port"), "p", os.path.join(tmp, "p2j"), mesh=mesh)
        je.load_checkpoint(os.path.join(tmp, "p2j"), tag="p")
        j_from_p = _train(je, batches[AT:])
        fp32 = (get_fp32_state_dict_from_zero_checkpoint(os.path.join(tmp, "port"), "p"),
                jax_fp32(os.path.join(tmp, "p2j"), "p"),
                get_fp32_state_dict_from_zero_checkpoint(os.path.join(tmp, "j2p"), "j"),
                jax_fp32(os.path.join(tmp, "jax"), "j"))
        del je

        _one_device_mesh()
        ji = ds.init_inference(_jax_lm(), dtype="fp32", zero={"stage": 3, "offload_param": {"device": "cpu"}})
        ji.set_params(_tree())
        toks = np.random.RandomState(7).randint(0, GPT2["vocab_size"], (4, 12)).astype(np.int32)
        jlogits = np.asarray(ji(toks))
        jgen = np.asarray(ji.generate(toks[:, :6], max_new_tokens=6))
        del ji
    finally:
        torch.set_num_threads(prev)
    return dict(jax=np.array(jrec), port=np.array(prec), jmaster=jmaster, pmaster=_master(pe),
                p_from_j=np.array(p_from_j), p_from_j_master=_master(p2), j_from_p=np.array(j_from_p),
                fp32=fp32, jlogits=jlogits, jgen=jgen, toks=toks, tmp=tmp)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=tol)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=tol)


def _masters_close(got, want, tol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def test_param_offload_matches_jax(runs):
    assert (runs["jax"][:, 1] > 0.1).all()
    _close(runs["port"], runs["jax"])
    _masters_close(runs["pmaster"], runs["jmaster"])


def test_param_offload_checkpoints_cross_load_with_jax(runs):
    _close(runs["p_from_j"], runs["jax"][AT:])
    _masters_close(runs["p_from_j_master"], runs["jmaster"])
    _close(runs["j_from_p"], runs["port"][AT:])


def test_param_stream_zero_to_fp32_equal_jax(runs):
    port_p, jax_p, port_j, jax_j = runs["fp32"]
    for got, want in ((port_p, jax_p), (port_j, jax_j)):
        assert list(got) == list(want)
        for k in want:
            assert got[k].tobytes() == np.asarray(want[k], np.float32).tobytes(), k


@pytest.mark.parametrize("variant", ["nvme", "cpu_checkpointing"])
def test_param_offload_variants_bitwise_cpu(runs, tmp_path, variant):
    """``nvme`` (layers in files read through aio) and the host stash are
    the ``cpu`` run bit for bit; ``cpu`` is within 1e-5 of the on-device
    stage 3."""
    batches = _batches(STEPS)
    if variant == "nvme":
        e = _port({"stage": 3, "offload_param": {"device": "nvme", "nvme_path": str(tmp_path)}})
        assert sorted(os.listdir(tmp_path / "ds_tpu_param_swap")) == ["layer_0.bin", "layer_1.bin"]
    else:
        e = _port(PARAM_CPU, extra={"activation_checkpointing": {"cpu_checkpointing": True}})
        assert e._param_stream.act_offload
    got = np.array(_train(e, batches))
    np.testing.assert_array_equal(got, runs["port"])
    ma = _master(e)
    assert all(ma[k].tobytes() == runs["pmaster"][k].tobytes() for k in ma)
    ref = np.array(_train(_port({"stage": 3}), batches))
    _close(runs["port"], ref)


def test_param_offload_with_dropout_port(tmp_path):
    """Dropout on: the recompute redraws the forward's masks (the layer's
    seed), so ``cpu`` and ``nvme`` agree bit for bit and both follow the
    on-device stage 3 (same seeds, same masks) within 1e-5."""
    kw = dict(GPT2, hidden_dropout=0.1, attn_dropout=0.1, flash_attention=False)
    batches = _batches(3)
    cpu = np.array(_train(_port(PARAM_CPU, kw), batches))
    nvme = np.array(_train(_port({"stage": 3, "offload_param": {"device": "nvme", "nvme_path": str(tmp_path)}}, kw),
                           batches))
    np.testing.assert_array_equal(cpu, nvme)
    ref = np.array(_train(_port({"stage": 3}, kw), batches))
    _close(cpu, ref)
    nodrop = np.array(_train(_port(PARAM_CPU), batches))
    assert not np.allclose(cpu[:, 0], nodrop[:, 0], rtol=1e-4)  # the masks did act


def test_param_offload_state_and_refusals(runs):
    e = _port(PARAM_CPU)
    assert e._param_stream is not None and e._params is None and e.num_parameters() == 124_672
    assert e.get_param_treedef() == unflatten_tree({k: None for k in flatten_tree(_tree())})
    want = flatten_tree(_tree())
    got = flatten_tree(e.get_params())
    assert all(got[k].tobytes() == np.asarray(want[k], np.float32).tobytes() for k in want)
    e.eval()
    b = _batches(1)[0]
    loss = float(e(b))
    ref = _port({"stage": 3}).eval()
    assert loss == float(ref(b))
    with pytest.raises(NotImplementedError, match="param_stream"):
        _port({"stage": 3}).load_checkpoint(os.path.join(runs["tmp"], "port"), tag="p")
    plain = _port({"stage": 3})
    plain.save_checkpoint(os.path.join(runs["tmp"], "plain"), tag="q")
    with pytest.raises(NotImplementedError, match="param-offload engine"):
        _port(PARAM_CPU).load_checkpoint(os.path.join(runs["tmp"], "plain"), tag="q")
    with pytest.raises(ValueError, match="stage 3"):
        _port({"stage": 2, "offload_param": {"device": "cpu"}})
    # a module-only load: the tag's master with fresh moments and step count
    m = _port(PARAM_CPU)
    m.load_checkpoint(os.path.join(runs["tmp"], "port"), tag="p", load_module_only=True)
    assert m._param_stream.step_count == 0
    saved = runs["fp32"][0]  # the port tag's fp32 weights (fp32 training: the module is the master)
    got = _master(m)
    assert all(got[k].tobytes() == saved[k].tobytes() for k in saved)


# --- ZeRO-Inference -----------------------------------------------------------------
def _zero_inference(dtype="fp32", device="cpu", tmp=None):
    off = {"device": device} if tmp is None else {"device": device, "nvme_path": str(tmp)}
    eng = dst.init_inference(TransformerLM(TransformerConfig(**GPT2)), dtype=dtype,
                             zero={"stage": 3, "offload_param": off}, device="cpu")
    eng.set_params(_tree())
    return eng


def test_zero_inference_matches_jax_and_in_memory(runs, tmp_path):
    toks = runs["toks"]
    eng = _zero_inference()
    logits = eng(toks).numpy()
    np.testing.assert_allclose(logits, runs["jlogits"], rtol=1e-5, atol=1e-5)
    plain = dst.init_inference(TransformerLM(TransformerConfig(**GPT2)), dtype="fp32", device="cpu")
    plain.set_params(_tree())
    assert logits.tobytes() == plain(toks).numpy().tobytes()
    gen = eng.generate(toks[:, :6], max_new_tokens=6)
    assert gen.dtype == torch.int32 and tuple(gen.shape) == (4, 12)
    np.testing.assert_array_equal(gen.numpy(), runs["jgen"])
    np.testing.assert_array_equal(gen.numpy(), plain.generate(toks[:, :6], max_new_tokens=6).numpy())
    nvme = _zero_inference(device="nvme", tmp=tmp_path)
    assert nvme(toks).numpy().tobytes() == logits.tobytes()
    assert all(st.exp_avg is None for st in eng._param_stream._layer_state)  # no moments for inference
    with pytest.raises(NotImplementedError, match="serve"):
        eng.serve([toks[0]], max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="save_mp_checkpoint"):
        eng.save_mp_checkpoint(str(tmp_path / "mp"))
    with pytest.raises(NotImplementedError, match="beam"):
        eng.generate(toks[:, :6], max_new_tokens=2, num_beams=2)
