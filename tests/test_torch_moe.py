"""The port's MoE on one rank against the JAX package's.

* gating: ``top1gating`` (Random Token Selection on and off, RSample,
  ``drop_tokens`` on and off, a ``used_token_mask``) and ``top2gating``
  (second-expert sampling on and off, ``drop_tokens`` on and off) with
  JAX's own noise passed in (its Gumbel draws and RTS permutation, made
  with JAX's key splits): combine weights, dispatch masks, ``l_aux`` and
  expert counts equal to JAX's (fp32, the same ops: 1e-6 for the float
  outputs, masks and counts exact); the index-based ``dispatch`` bit for
  bit JAX's einsum, ``combine`` within 1e-6 of it (two products summed in
  another order);
* the layer: ``MoE.apply`` with the PR-MoE residual and the Jitter policy
  against JAX's, in training with JAX's noise and in eval (1e-6);
* the model: tiny ``moe_llama`` (top-1 and top-2), ``mixtral`` with
  PR-MoE and ``moe_layer_freq`` 2: logits, the training loss (the scaled
  load-balance loss included) and every gradient against ``jax.grad``
  (1e-5; JAX's ``rngs=None``, so no gate noise on either side);
* the engine: an MoE engine's first fp32 step against JAX's loss and the
  norm of its gradients (1e-5; top-1 without RTS, whose training gates
  draw no noise), the fp32 router leaf under bf16, the MoE utilities'
  splits, and tensor-parallel MoE training refused naming ROADMAP P1
  (expert parallelism: ``test_torch_moe_ep.py``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import moe_transformer as jmt
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.moe import utils as jutils
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree
from deepspeed_tpu_torch.models import moe_transformer as pmt
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.moe import layer as player
from deepspeed_tpu_torch.moe import sharded_moe as psm
from deepspeed_tpu_torch.moe import utils as putils

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=32,
            dtype="float32", remat=False, flash_attention=False, num_experts=4, capacity_factor=1.0,
            eval_capacity_factor=1.0, min_capacity=2, intermediate_size=48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol,
                               err_msg=msg)


# --- gating -----------------------------------------------------------------------
GATES = {  # name -> (k, kwargs); S=24 tokens over E=4 experts, capacity small enough to drop
    "top1-rts": (1, dict(use_rts=True)),
    "top1-no-rts": (1, dict(use_rts=False)),
    "top1-rsample": (1, dict(noisy_gate_policy="RSample")),
    "top1-no-drop": (1, dict(drop_tokens=False)),
    "top1-used-mask": (1, dict(used=True)),
    "top2-sampled": (2, dict()),
    "top2-no-noise": (2, dict(rng=False)),
    "top2-no-drop": (2, dict(drop_tokens=False)),
}


def _jax_noise(k, rng, S, E, policy):
    """JAX's draws inside ``top1gating`` / ``top2gating`` for ``rng``."""
    noise = {}
    if k == 1:
        if policy == "RSample":
            rng, sub = jax.random.split(rng)
            noise["gumbel"] = np.asarray(jax.random.gumbel(sub, (S, E), dtype=jnp.float32))
        rng, rng_rts = jax.random.split(rng)
        noise["rts_perm"] = np.asarray(jax.random.permutation(rng_rts, S))
    else:
        rng, sub = jax.random.split(rng)
        noise["gumbel"] = np.asarray(jax.random.gumbel(sub, (S, E), dtype=jnp.float32))
    return noise


def _gate_case(name):
    """A case's inputs, and its JAX reference outputs and noise (numpy)."""
    k, kw = GATES[name]
    kw = dict(kw)
    S, E, H = 24, 4, 8
    rs = np.random.RandomState(7)
    logits = rs.randn(S, E).astype(np.float32)
    tokens = rs.randn(S, H).astype(np.float32)
    used = (rs.rand(S) > 0.25).astype(np.float32) if kw.pop("used", False) else None
    rng = jax.random.PRNGKey(3) if kw.pop("rng", True) else None
    drop = kw.get("drop_tokens", True)
    if k == 1:
        ref = jsm.top1gating(jnp.asarray(logits), 1.0, 2, used_token_mask=None if used is None else jnp.asarray(used),
                             noisy_gate_policy=kw.get("noisy_gate_policy"), use_rts=kw.get("use_rts", True),
                             rng=rng, drop_tokens=drop)
    else:
        ref = jsm.topkgating(jnp.asarray(logits), 2, 1.0, 2, rng=rng, drop_tokens=drop)
    ref = [np.asarray(a) for a in ref]
    y = rs.randn(E, ref[1].shape[2], H).astype(np.float32)
    ref += [np.asarray(jsm.dispatch(jnp.asarray(tokens), jnp.asarray(ref[2]))),
            np.asarray(jsm.combine(jnp.asarray(y), jnp.asarray(ref[1])))]
    noise = _jax_noise(k, rng, S, E, kw.get("noisy_gate_policy")) if rng is not None else {}
    return dict(k=k, kw=kw, logits=logits, tokens=tokens, used=used, drop=drop, y=y, ref=ref, noise=noise)


@functools.lru_cache(maxsize=None)
def _gate_refs():
    """Every case's JAX side in one test (the JAX ops compile once)."""
    return {name: _gate_case(name) for name in GATES}


@pytest.mark.parametrize("name", sorted(GATES))
def test_gating_dispatch_combine_match_jax(name):
    c = _gate_refs()[name]
    k, kw, noise = c["k"], c["kw"], c["noise"]
    r = psm.topk_routing(_t(c["logits"]), k, 1.0, 2, noisy_gate_policy=kw.get("noisy_gate_policy"),
                         use_rts=kw.get("use_rts", True), used_token_mask=None if c["used"] is None else _t(c["used"]),
                         gumbel=None if "gumbel" not in noise else _t(noise["gumbel"]),
                         rts_perm=None if "rts_perm" not in noise else _t(noise["rts_perm"]), drop_tokens=c["drop"])
    l_aux, combine_w, dispatch_m, counts = psm._dense_tuple(r)
    j_aux, j_combine, j_dispatch, j_counts, j_dispatched, j_combined = c["ref"]
    _close(float(l_aux), float(j_aux), 1e-6, "l_aux")
    assert combine_w.shape == j_combine.shape
    _close(combine_w.numpy(), j_combine, 1e-6, "combine")
    np.testing.assert_array_equal(dispatch_m.numpy(), j_dispatch)
    np.testing.assert_array_equal(counts.numpy(), j_counts)
    S = c["logits"].shape[0]
    assert int(r.kept.sum()) < S * k or not c["drop"]  # the capacity dropped something
    got = psm.dispatch(_t(c["tokens"]), r)
    np.testing.assert_array_equal(got.numpy(), j_dispatched)  # bit for bit: each slot takes one token
    _close(psm.combine(_t(c["y"]), r).numpy(), j_combined, 1e-6)
    # the dense plain references are JAX's einsums
    np.testing.assert_array_equal(psm.dispatch_dense(_t(c["tokens"]), dispatch_m).numpy(), j_dispatched)


def test_topk_above_two_raises_as_jax():
    with pytest.raises(ValueError, match="top-1 and top-2"):
        jsm.topkgating(jnp.zeros((4, 4)), 3, 1.0, 1)
    with pytest.raises(ValueError, match="top-1 and top-2"):
        psm.topkgating(torch.zeros(4, 4), 3, 1.0, 1)


# --- the layer ----------------------------------------------------------------------
LAYER = dict(hidden_size=16, num_experts=4, k=1, capacity_factor=1.0, eval_capacity_factor=1.5, min_capacity=2,
             use_residual=True, noisy_gate_policy="Jitter", intermediate_size=24, activation="gelu")


@functools.lru_cache(maxsize=None)
def _layer_refs():
    """JAX's layer outputs in training and eval, its training noise, the
    tree and the input (numpy)."""
    H, E, S = 16, 4, 20
    tree = player.MoE(**LAYER).init(np.random.default_rng(0))
    x = np.random.RandomState(1).randn(2, S // 2, H).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    jl = jlayer.MoE(**LAYER)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    refs = {t: [np.asarray(a) for a in jax.jit(lambda p, h, t=t: jl.apply(p, h, train=t, rng=rng))(
        jtree, jnp.asarray(x))] for t in (True, False)}
    r, sub = jax.random.split(rng)
    noise = dict(jitter=np.asarray(jax.random.uniform(sub, (S, H), dtype=jnp.float32, minval=0.99, maxval=1.01)),
                 **_jax_noise(1, r, S, E, "Jitter"))
    return tree, x, refs, noise


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_moe_layer_with_residual_matches_jax(train):
    """top-1 with the Jitter policy and RTS in training (JAX's noise passed
    in), the eval capacity and no noise in eval; PR-MoE residual on."""
    tree, x, refs, noise = _layer_refs()
    j_out, j_aux, j_counts = refs[train]
    out, aux, counts = player.MoE(**LAYER).apply(jax.tree_util.tree_map(_t, tree), _t(x), train=train,
                                                 noise={k: _t(v) for k, v in noise.items()} if train else None)
    _close(out.numpy(), j_out, 1e-6)
    _close(float(aux), float(j_aux), 1e-6)
    np.testing.assert_array_equal(counts.numpy(), j_counts)


# --- the model ----------------------------------------------------------------------
MODELS = {
    "moe_llama-top1": lambda: ("moe_llama_config", dict(TINY, moe_top_k=1, moe_use_rts=False)),
    "moe_llama-top2": lambda: ("moe_llama_config", dict(TINY, moe_top_k=2)),
    "mixtral-prmoe-freq2": lambda: ("mixtral_config", dict(TINY, use_residual=True, moe_layer_freq=2)),
}


def _configs(name):
    fn, kw = MODELS[name]()
    return getattr(jmt, fn)("tiny", **kw), getattr(pmt, fn)("tiny", **kw)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _model_batch():
    toks = np.random.RandomState(2).randint(0, 64, (8, 17)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@functools.lru_cache(maxsize=None)
def _jax_model_ref(name):
    """JAX's eval logits, training loss and gradients (numpy) for a model
    case on the shared batch, computed once (the engine test reads the
    top-1 case's)."""
    jcfg, pcfg = _configs(name)
    flat = init_params(pcfg, 0)
    tokens, labels = _model_batch()
    jm = jmt.MoETransformerLM(jcfg)
    jtree = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    j_logits = np.asarray(jax.jit(lambda p: jm.apply(p, jnp.asarray(tokens), train=False))(jtree))
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p: jm.apply(p, (jnp.asarray(tokens), jnp.asarray(labels)),
                                                                    train=True)))(jtree)
    return flat, j_logits, float(j_loss), _leaves(jax.tree_util.tree_map(np.asarray, j_grads))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_moe_model_matches_jax(name):
    """fp32: eval logits, the training loss (load-balance loss times its
    coefficient included) and every gradient within 1e-5 of JAX's."""
    _, pcfg = _configs(name)
    flat, j_logits, j_loss, j_grads = _jax_model_ref(name)
    tokens, labels = (torch.from_numpy(a).long() for a in _model_batch())
    pm = pmt.MoETransformerLM(pcfg)
    params = {p: torch.tensor(a, requires_grad=True) for p, a in flat.items()}
    nested = unflatten_tree(params)
    with torch.no_grad():
        logits = pm.apply(nested, tokens, train=False)
        eval_loss = pm.apply(nested, (tokens, labels), train=False)
    loss = pm.apply(nested, (tokens, labels), train=True)
    loss.backward()
    _close(logits.numpy(), j_logits, 1e-5, "logits")
    _close(float(loss.detach()), j_loss, 1e-5, "loss")
    assert float(loss.detach()) > float(eval_loss)  # the load-balance term rides the training loss only
    for path, g in j_grads.items():
        _close(params[path].grad.numpy(), g, 1e-5, path)


# --- the engine and the surface -----------------------------------------------------
def test_moe_engine_step_matches_jax():
    """The training engine on the top-1 model (no RTS: its training gates
    draw no noise, as JAX's ``rngs=None``): the first step's loss and
    global grad norm within 1e-5 of JAX's loss and the norm of its
    gradients (the aux loss is in the loss backward sees); the step then
    updates every leaf, the router's included."""
    flat, _, j_loss, j_grads = _jax_model_ref("moe_llama-top1")
    _, pcfg = _configs("moe_llama-top1")
    pe, *_ = dst.initialize(model=pmt.MoETransformerLM(pcfg), model_parameters=unflatten_tree(flat), device="cpu",
                            config={"train_micro_batch_size_per_gpu": 8, "steps_per_print": 10_000,
                                    "optimizer": {"type": "adam", "params": {"lr": 1e-3}}})
    tokens, labels = _model_batch()
    loss = pe({"input_ids": tokens, "labels": labels})
    pe.backward(loss)
    pe.step()
    _close(float(loss), j_loss, 1e-5, "loss")
    norm = np.sqrt(sum(float(np.sum(np.square(g.astype(np.float64)))) for g in j_grads.values()))
    _close(pe.get_global_grad_norm(), norm, 1e-5, "grad norm")
    after = flatten_tree(pe.get_master_params())
    assert all(not np.array_equal(after[p], flat[p]) for p in flat if "norm" not in p)


def test_router_stays_fp32_under_bf16():
    pcfg = pmt.moe_llama_config("tiny", **dict(TINY, dtype="bfloat16"))
    pe, *_ = dst.initialize(model=pmt.MoETransformerLM(pcfg), model_parameters=unflatten_tree(init_params(pcfg, 0)),
                            device="cpu", config={"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": True},
                                                  "optimizer": {"type": "adam", "params": {"lr": 1e-3}}})
    params = flatten_tree(pe.get_params())
    assert params["layers/moe/gate/wg"].dtype == np.float32
    assert pe._params["layers/moe/experts/w_up"].dtype == torch.bfloat16
    toks = np.random.RandomState(0).randint(0, 64, (2, 9))
    loss = pe({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    pe.backward(loss)
    pe.step()
    assert np.isfinite(float(loss)) and pe.global_steps == 1


def test_moe_utils_match_jax():
    pcfg = pmt.moe_llama_config("tiny", **dict(TINY, use_residual=True))
    tree = unflatten_tree(init_params(pcfg, 0))
    for path in ("layers/moe/experts/w_up", "layers/moe/gate/wg", "layers/moe/mlp/w_up", "expert_bias", "wq"):
        assert putils.is_moe_param_path(path) == jutils.is_moe_param_path(path), path
    shared, expert = putils.split_params_into_shared_and_expert_params(tree)
    j_shared, j_expert = jutils.split_params_into_shared_and_expert_params(tree)
    for got, want in ((shared, j_shared), (expert, j_expert)):
        assert {p for p, v in _leaves(got).items() if v is not None} == \
            {p for p, v in _leaves(want).items() if v is not None}
    groups = putils.split_params_into_different_moe_groups_for_optimizer({"params": tree, "lr": 1.0, "name": "g"})
    j_groups = jutils.split_params_into_different_moe_groups_for_optimizer({"params": tree, "lr": 1.0, "name": "g"})
    assert [(g["name"] if "name" in g else None, g["moe"]) for g in groups] == \
        [(g["name"] if "name" in g else None, g["moe"]) for g in j_groups]
    assert putils.has_moe_layers(pmt.MoETransformerLM(pcfg)) == (True, 4)
    assert putils.has_moe_layers(tree) == jutils.has_moe_layers(tree)
    # the layer's partition rules: the stacked expert dim on the "expert" axis, the rest replicated
    layer = player.MoE(**dict(LAYER, k=2))
    ltree = layer.init(np.random.default_rng(1))
    want = jlayer.MoE(**dict(LAYER, k=2)).partition_rules(jax.tree_util.tree_map(jnp.asarray, ltree))
    got = layer.partition_rules(ltree)
    for path, spec in _leaves(jax.tree_util.tree_map(tuple, want, is_leaf=lambda x: isinstance(x, tuple))).items():
        assert _leaves(got)[path] == tuple(spec), path


def test_tensor_parallel_moe_training_names_p1():
    """Tensor-parallel MoE training needs tensor-parallel training (ROADMAP
    P1): a ``model`` mesh axis in the engine config, and the model's
    training forward under a tensor-parallel context, both refuse naming
    it (expert parallelism itself runs: ``test_torch_moe_ep.py``)."""
    from deepspeed_tpu_torch.inference.tp import TPServing

    cfg = pmt.moe_llama_config("tiny", **TINY)
    tree = unflatten_tree(init_params(cfg, 0))
    with pytest.raises(NotImplementedError, match="ROADMAP P1"):
        dst.initialize(model=pmt.MoETransformerLM(cfg), device="cpu", model_parameters=tree,
                       config={"train_micro_batch_size_per_gpu": 1, "mesh": {"model": 2}})
    params = unflatten_tree({k: torch.from_numpy(np.asarray(v)) for k, v in flatten_tree(tree).items()})
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP P1"):
        pmt.MoETransformerLM(cfg).apply(params, (toks, toks), train=True, tp=TPServing(degree=1))
