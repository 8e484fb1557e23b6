"""The port's training path against the JAX package's.

* model: the logits, loss and gradients of ``TransformerLM.apply`` against
  JAX ``TransformerLM.apply`` and ``jax.grad``, fp32, 2 layers, T=128, for
  a tiny gpt2 (learned positions, LayerNorm, tied head) and a tiny llama
  (RoPE, RMSNorm, SwiGLU, GQA), through the flash route and the einsum
  route; ``remat`` on and off give identical results;
* engine: the JAX engine (8-device CPU mesh, micro 1, so 8 rows a step)
  against the port's (one rank, micro 8) over 3 steps: losses, global
  grad norms and the fp32 master, in fp32 with clipping active, in bf16,
  at gas 2 through ``train_batch``, and one fp16 step that overflows;
* config: the bench config-1 JSON resolves to the same values in both
  packages; each unported switch raises ``NotImplementedError``;
  ``initialize`` without ``device`` raises here (no card).

The JAX side runs ``flash_attention=False`` in the engine tests, to keep
the Pallas interpret mode out of the time budget; the port keeps its flash
route (on the CPU, the plain flash functions). Inputs and weights are made
with numpy from a seed (the JAX init's tree, as numpy) and fed to both.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import config as jax_model_config
from deepspeed_tpu.models.transformer import cross_entropy_loss as jax_cross_entropy
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu_torch.checkpoint.jax_params import unflatten_tree
from deepspeed_tpu_torch.models import TransformerLM
from deepspeed_tpu_torch.models import config as port_model_config
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

GPT2 = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2, max_seq_len=128, dtype="float32")
LLAMA = dict(GPT2, num_heads=4, num_kv_heads=2, norm="rmsnorm", position="rope", activation="swiglu",
             use_bias=False, tie_embeddings=False)
BENCH = {  # bench.py:507-517, config 1
    "train_micro_batch_size_per_gpu": 8,
    "optimizer": {"type": "adam", "params": {"lr": 3e-4, "weight_decay": 0.01}},
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 1},
    "gradient_clipping": 1.0,
    "steps_per_print": 10_000,
}
LR = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_tree(model_kw, seed=0):
    """The JAX tree layout as nested numpy, drawn with the JAX init's
    distributions from numpy (no JAX compile)."""
    return unflatten_tree(init_params(port_model_config.TransformerConfig(**model_kw), seed))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tokens(rs, vocab, rows, T):
    toks = rs.randint(0, vocab, (rows, T + 1)).astype(np.int32)
    return {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}


# --- model --------------------------------------------------------------------
MODELS = {  # the flash route (JAX: Pallas in interpret mode) and the grouped-einsum route
    "gpt2-flash": GPT2,
    "llama-gqa-einsum": dict(LLAMA, flash_attention=False),
}


def _port_grads(model_kw, tree, batch, remat):
    model = TransformerLM(port_model_config.TransformerConfig(**dict(model_kw, remat=remat)))
    params = {p: torch.tensor(a, requires_grad=True) for p, a in _leaves(tree).items()}
    nested = {"embed": {}, "layers": {}}
    for path, t in params.items():
        head, _, name = path.rpartition("/")
        (nested[head] if head else nested)[name] = t
    tokens = torch.from_numpy(batch["input_ids"]).long()
    labels = torch.from_numpy(batch["labels"]).long()
    loss = model.apply(nested, (tokens, labels), train=True)
    loss.backward()
    with torch.no_grad():
        logits = model.apply(nested, tokens, train=False)
    return float(loss), logits.numpy(), {p: t.grad.numpy() for p, t in params.items()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    """fp32 logits, loss and every gradient within 1e-5 (reduction order
    only); remat on and off give bit-identical results."""
    model_kw = dict(MODELS[name], remat=False)
    tree = _jax_tree(model_kw)
    batch = _tokens(np.random.RandomState(1), model_kw["vocab_size"], 2, 128)
    jm = JaxLM(jax_model_config.TransformerConfig(**model_kw))
    tokens, labels = jnp.asarray(batch["input_ids"]), jnp.asarray(batch["labels"])

    def loss_of(p):  # JAX apply's training loss for a dense model, with its logits
        logits = jm.apply(p, tokens, train=True)
        return jax_cross_entropy(logits, labels), logits

    (loss_ref, logits_ref), grads_ref = jax.value_and_grad(loss_of, has_aux=True)(tree)
    logits_ref = np.asarray(logits_ref)
    loss, logits, grads = _port_grads(model_kw, tree, batch, remat=False)
    np.testing.assert_allclose(loss, float(loss_ref), rtol=1e-5, atol=0)
    np.testing.assert_allclose(logits, logits_ref, rtol=1e-5, atol=1e-5)
    for path, g in _leaves(jax.tree_util.tree_map(np.asarray, grads_ref)).items():
        np.testing.assert_allclose(grads[path], g, rtol=1e-5, atol=1e-6, err_msg=path)
    loss_r, logits_r, grads_r = _port_grads(model_kw, tree, batch, remat=True)
    assert loss_r == loss
    np.testing.assert_array_equal(logits_r, logits)
    for path in grads:
        np.testing.assert_array_equal(grads_r[path], grads[path], err_msg=path)


# --- engine -------------------------------------------------------------------
def _engines(model_kw, ds_config, gas=1):
    tree = _jax_tree(model_kw)
    jm = JaxLM(jax_model_config.TransformerConfig(**dict(model_kw, flash_attention=False)))
    je, *_ = ds.initialize(model=jm, config=dict(ds_config, train_micro_batch_size_per_gpu=1,
                                                 gradient_accumulation_steps=gas), model_parameters=tree)
    pe, *_ = dst.initialize(model=TransformerLM(port_model_config.TransformerConfig(**model_kw)),
                            config=dict(ds_config, train_micro_batch_size_per_gpu=8,
                                        gradient_accumulation_steps=gas),
                            model_parameters=tree, device="cpu")
    assert je.train_batch_size() == pe.train_batch_size() == 8 * gas
    return je, pe


def _run(je, pe, steps, gas, vocab, T=16):
    rs = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        batch = _tokens(rs, vocab, 8 * gas, T)
        if gas == 1:
            lj = je(batch)
            je.backward(lj)
            je.step()
            lp = pe(batch)
            pe.backward(lp)
            pe.step()
            lj, lp = float(lj), float(lp)
        else:
            lj, lp = je.train_batch(batch=batch), pe.train_batch(batch=batch)
        out.append((lj, lp, je.get_global_grad_norm(), pe.get_global_grad_norm()))
    return np.array(out, dtype=np.float64)


def _master_gap(je, pe):
    ref = _leaves(jax.tree_util.tree_map(np.asarray, je.get_master_params()))
    got = _leaves(pe.get_master_params())
    assert set(ref) == set(got)
    return {p: np.abs(got[p] - ref[p]) for p in ref}


def test_engine_fp32_matches_jax():
    """fp32, 3 steps at gas 2 through ``train_batch`` (the full-step batch
    sliced into 2 microbatches of 8 rows): losses, grad norms (before
    clipping) and the master within 1e-5. The clip of 0.1 is active every
    step (the norms are ~1)."""
    cfg = dict(BENCH, gradient_clipping=0.1)
    cfg.pop("bf16")
    je, pe = _engines(dict(GPT2, remat=False), cfg, gas=2)
    rec = _run(je, pe, 3, 2, GPT2["vocab_size"])
    assert (rec[:, 2] > 0.1).all()  # clipping engaged
    np.testing.assert_allclose(rec[:, 1], rec[:, 0], rtol=1e-5)
    np.testing.assert_allclose(rec[:, 3], rec[:, 2], rtol=1e-5)
    for path, gap in _master_gap(je, pe).items():
        assert gap.max() <= 1e-5, (path, gap.max())
    assert pe.get_lr() == je.get_lr() == [LR]
    assert pe.num_parameters() == je.num_parameters()
    assert pe.global_steps == je.global_steps == 3 and pe.micro_steps == je.micro_steps == 6


def test_engine_bf16_matches_jax():
    """bf16 compute, fp32 master, the bench config, 3 steps. bf16 rounds at
    other places in the two packages (and JAX's einsum route rounds the
    scores to bf16 where the flash route keeps them fp32), so: losses
    within 1e-4 relative, grad norms within 2e-3 relative, and 99% of the
    master's elements within 5e-5. No element may differ by more than
    2·lr per step: Adam's normalised step moves an element by at most
    about lr, so rounding noise can flip the step of a gradient that is
    itself rounding noise, but not add to it. Small leaves (``bq``) hold
    many such elements, and ``bk`` holds nothing else: its gradient is
    exactly zero in exact arithmetic (a softmax does not see a shift
    shared by all keys)."""
    je, pe = _engines(dict(GPT2, dtype="bfloat16", remat=False), BENCH)
    rec = _run(je, pe, 3, 1, GPT2["vocab_size"])
    np.testing.assert_allclose(rec[:, 1], rec[:, 0], rtol=1e-4)
    np.testing.assert_allclose(rec[:, 3], rec[:, 2], rtol=2e-3)
    gaps = _master_gap(je, pe)
    for path, gap in gaps.items():
        assert gap.max() <= 2 * LR * 3, (path, gap.max())
    pooled = np.concatenate([g.ravel() for g in gaps.values()])
    assert np.percentile(pooled, 99) <= 5e-5, np.percentile(pooled, 99)
    params = _leaves(pe.get_params())
    master = _leaves(pe.get_master_params())
    for path in master:  # the compute copy is the master rounded to bf16
        want = torch.from_numpy(master[path]).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(params[path], want, err_msg=path)


def test_engine_fp16_overflow_skips_step_as_jax():
    """fp16 at a loss scale of 2^32: the fp16 gradients overflow, so both
    engines skip the step, keep the master and halve the scale
    (hysteresis 1)."""
    cfg = dict(BENCH, fp16={"enabled": True, "initial_scale_power": 32, "hysteresis": 1})
    cfg.pop("bf16")
    je, pe = _engines(dict(GPT2, dtype="float16", remat=False), cfg)
    before = _leaves(pe.get_master_params())
    _run(je, pe, 1, 1, GPT2["vocab_size"])
    assert pe.skipped_steps == je.skipped_steps == 1
    assert pe.loss_scale == je.loss_scale == 2.0**31
    for path, gap in _master_gap(je, pe).items():
        assert gap.max() == 0, path
    after = _leaves(pe.get_master_params())
    assert all(np.array_equal(before[p], after[p]) for p in before)


def test_train_batch_and_eval_forward():
    """``train_batch`` returns the step's mean loss; the eval forward
    returns the same loss without a graph and changes nothing."""
    model_kw = dict(GPT2, remat=True)
    tree = _jax_tree(model_kw)
    cfg = dict(BENCH, gradient_accumulation_steps=2, train_micro_batch_size_per_gpu=2)
    cfg.pop("bf16")
    pe, *_ = dst.initialize(model=TransformerLM(port_model_config.TransformerConfig(**model_kw)), config=cfg,
                            model_parameters=tree, device="cpu")
    batch = _tokens(np.random.RandomState(2), GPT2["vocab_size"], 4, 16)
    pe.eval()
    halves = [float(pe({"input_ids": batch["input_ids"][i:i + 2], "labels": batch["labels"][i:i + 2]}))
              for i in (0, 2)]
    assert _leaves(pe.get_master_params())["embed/tokens"].tobytes() == tree["embed"]["tokens"].tobytes()
    pe.train()
    assert pe.is_gradient_accumulation_boundary() is False
    loss = pe.train_batch(batch=batch)
    np.testing.assert_allclose(loss, np.mean(halves), rtol=1e-6)
    assert pe.global_steps == 1 and pe.micro_steps == 2


# --- config and entry point -------------------------------------------------------
def test_bench_config_resolves_as_jax():
    a, b = JaxDeepSpeedConfig(dict(BENCH)), DeepSpeedConfig(dict(BENCH))
    a.resolve_batch_triad(1)
    b.resolve_batch_triad(1)
    for key in ("train_batch_size", "train_micro_batch_size_per_gpu", "gradient_accumulation_steps",
                "gradient_clipping", "zero_optimization_stage", "bfloat16_enabled", "fp16_enabled",
                "steps_per_print", "loss_scale", "dynamic_loss_scale_args"):
        assert getattr(a, key) == getattr(b, key), key
    assert a.optimizer_config.model_dump() == b.optimizer_config.model_dump()
    assert (b.train_batch_size, b.train_micro_batch_size_per_gpu, b.gradient_accumulation_steps) == (8, 8, 1)


UNPORTED = {
    "zero2": {"zero_optimization": {"stage": 2}},
    "zero3": {"zero_optimization": {"stage": 3}},
    "offload": {"zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu"}}},
    "fuse_grad_accum": {"compile": {"fuse_grad_accum": True}},
    "multi_step": {"compile": {"multi_step": {"enable": True, "horizon": 4}}},
    "mesh_pipe": {"mesh": {"pipe": 2}},
    "mesh_sequence": {"mesh": {"sequence": 2}},
    "mesh_expert": {"mesh": {"expert": 2}},
    "flops_profiler": {"flops_profiler": {"enabled": True}},
    "monitor": {"monitor": {"enabled": True}},
    "pld": {"progressive_layer_drop": {"enabled": True}},
    "lamb": {"optimizer": {"type": "lamb", "params": {"lr": 1e-3}}},
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_training_switches_raise(name):
    """The same JSON parses in both packages; the port then refuses the
    switch, naming its ROADMAP item."""
    cfg = dict(BENCH, **UNPORTED[name])
    JaxDeepSpeedConfig(dict(cfg))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dst.initialize(model=TransformerLM(port_model_config.TransformerConfig(**GPT2)), config=cfg,
                       model_parameters=_jax_tree(GPT2), device="cpu")


def test_initialize_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    model = TransformerLM(port_model_config.TransformerConfig(**GPT2))
    with pytest.raises(RuntimeError, match="CUDA"):
        dst.initialize(model=model, config=dict(BENCH), model_parameters=_jax_tree(GPT2))


# --- the small modules of the step ---------------------------------------------
@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["decoupled", "coupled"])
def test_fused_adam_matches_jax(adam_w_mode):
    """Three updates of the port's FusedAdam against JAX's on the same
    leaves and gradients, fp32: within 1e-7 (term-for-term the same math)."""
    from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JaxAdam
    from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam

    rs = np.random.RandomState(3)
    params = {"a": rs.randn(5, 7).astype(np.float32), "b": rs.randn(3).astype(np.float32)}
    kw = dict(lr=3e-4, weight_decay=0.01, adam_w_mode=adam_w_mode)
    ja, pa = JaxAdam(**kw), FusedAdam(**kw)
    jp, js = {k: jnp.asarray(v) for k, v in params.items()}, None
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = ja.init_state(jp), pa.init_state(pp)
    for _ in range(3):
        grads = {k: rs.randn(*v.shape).astype(np.float32) * 1e-2 for k, v in params.items()}
        jp, js = ja.apply({k: jnp.asarray(g) for k, g in grads.items()}, js, jp, 3e-4)
        pp, ps = pa.apply({k: torch.from_numpy(g) for k, g in grads.items()}, ps, pp, 3e-4)
    for k in params:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-7)
        np.testing.assert_allclose(ps.exp_avg_sq[k].numpy(), np.asarray(js.exp_avg_sq[k]), rtol=1e-6, atol=0)
    assert ps.step == int(js.step) == 3


def test_dynamic_loss_scaler_matches_jax():
    """The same run of overflow flags gives the same scale, good-step count
    and hysteresis after every update."""
    from deepspeed_tpu.runtime.fp16.loss_scaler import DynamicLossScaler as JaxScaler
    from deepspeed_tpu_torch.runtime.fp16.loss_scaler import DynamicLossScaler

    kw = dict(init_scale=2.0**16, scale_window=3, min_scale=1.0, delayed_shift=2)
    ja, pa = JaxScaler(**kw), DynamicLossScaler(**kw)
    js, ps = ja.init_state(), pa.init_state()
    flags = [False, True, True, False, False, False, False, True, False, True, True, True]
    for flag in flags:
        js, ps = ja.update(js, jnp.asarray(flag)), pa.update(ps, flag)
        assert (float(js.scale), int(js.good_steps), int(js.hysteresis)) == (ps.scale, ps.good_steps, ps.hysteresis)


@pytest.mark.parametrize("name,params", [
    ("WarmupLR", {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3, "warmup_num_steps": 10}),
    ("WarmupDecayLR", {"warmup_max_lr": 1e-3, "warmup_num_steps": 5, "total_num_steps": 20}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 5}),
])
def test_lr_schedules_match_jax(name, params):
    """The port's copy of the schedules steps ``param_groups[0]["lr"]``
    through the same values."""
    from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JaxAdam
    from deepspeed_tpu.runtime.lr_schedules import get_lr_scheduler as jax_sched
    from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
    from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_scheduler

    jo, po = JaxAdam(lr=1e-3), FusedAdam(lr=1e-3)
    js, ps = jax_sched(name, jo, **params), get_lr_scheduler(name, po, **params)
    for _ in range(25):
        js.step()
        ps.step()
        assert po.param_groups[0]["lr"] == jo.param_groups[0]["lr"]


def test_cross_entropy_ignore_index_matches_jax():
    """fp32, with ``-100`` labels masked out of the mean."""
    from deepspeed_tpu.models.transformer import cross_entropy_loss as jax_ce
    from deepspeed_tpu_torch.models.transformer import cross_entropy_loss

    rs = np.random.RandomState(4)
    logits = rs.randn(3, 5, 11).astype(np.float32) * 3
    labels = rs.randint(0, 11, (3, 5)).astype(np.int32)
    labels[0, :3] = -100
    ref = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels).long()))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_dropout_masks_follow_the_seed_under_remat():
    """Dropout draws from per-layer generators seeded from the step's seed:
    remat redraws the same masks (identical loss and gradients with and
    without it), another seed draws others, and eval applies none."""
    model_kw = dict(GPT2, attn_dropout=0.2, hidden_dropout=0.2, num_layers=2)
    tree = _leaves(_jax_tree(model_kw))
    batch = _tokens(np.random.RandomState(5), GPT2["vocab_size"], 2, 32)
    tb = (torch.from_numpy(batch["input_ids"]).long(), torch.from_numpy(batch["labels"]).long())

    def run(remat, seed, train=True):
        model = TransformerLM(port_model_config.TransformerConfig(**dict(model_kw, remat=remat)))
        leaves = {p: torch.tensor(a, requires_grad=True) for p, a in tree.items()}
        loss = model.apply(unflatten_tree(leaves), tb, dropout_seed=seed, train=train)
        loss.backward()
        return loss.item(), {p: t.grad.numpy() for p, t in leaves.items()}

    loss, grads = run(False, 7)
    loss_r, grads_r = run(True, 7)
    assert loss_r == loss
    for path in grads:
        np.testing.assert_array_equal(grads_r[path], grads[path], err_msg=path)
    assert run(False, 8)[0] != loss
    assert run(False, 7, train=False)[0] == run(False, 8, train=False)[0] != loss


def test_initialize_requires_the_jax_tree():
    model = TransformerLM(port_model_config.TransformerConfig(**GPT2))
    with pytest.raises(ValueError, match="model_parameters"):
        dst.initialize(model=model, config=dict(BENCH), device="cpu")
