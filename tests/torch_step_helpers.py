"""Shared pieces of the port's step-program tests on the CPU
(``test_torch_fused_training.py`` against JAX, ``test_torch_step_programs.py``
against the port's own eager run): a tiny GPT-2 form, the engine config
with ``compile.fuse_grad_accum`` / ``compile.multi_step``, seeded data,
and ``drive``, which runs ``train_batch`` over one iterator."""

from __future__ import annotations

import numpy as np

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.models.transformer import init_params

GPT2 = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2, max_seq_len=128, dtype="float32",
            remat=False)
STEPS = 5


def cfg(gas=1, fuse=False, multi_step=False, horizon=2, precision="fp32", micro=8, **over):
    c = {
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "optimizer": {"type": "adam", "params": {"lr": 3e-4, "weight_decay": 0.01}},
        "zero_optimization": {"stage": 1},
        "gradient_clipping": 1.0,
        "compile": {"fuse_grad_accum": fuse, "multi_step": {"enable": multi_step, "horizon": horizon}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-4, "warmup_num_steps": 10}},
    }
    if precision == "bf16":
        c["bf16"] = {"enabled": True}
    elif precision == "fp16":
        c["fp16"] = {"enabled": True, "initial_scale_power": 18, "hysteresis": 1}
    c.update(over)
    return c


def tree(model_kw=GPT2):
    return unflatten_tree(init_params(TransformerConfig(**model_kw), 0))


def port(cfg, model_kw=GPT2):
    e, *_ = dst.initialize(model=TransformerLM(TransformerConfig(**model_kw)), config=cfg,
                           model_parameters=tree(model_kw), device="cpu")
    return e


def data(gas, steps, rows=8, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(gas * steps):
        t = rs.randint(0, GPT2["vocab_size"], (rows, 17)).astype(np.int32)
        out.append({"input_ids": t[:, :-1], "labels": t[:, 1:]})
    return out


def drive(engine, data, steps):
    """Per step: (loss, grad norm, lr after the step)."""
    it = iter(list(data))
    out = []
    for _ in range(steps):
        loss = float(engine.train_batch(data_iter=it))
        out.append((loss, engine.get_global_grad_norm(), engine.get_lr()[0]))
    return np.array(out, dtype=np.float64)


def master(engine):
    return {k: np.asarray(v) for k, v in flatten_tree(engine.get_master_params()).items()}


def same_master(a, b):
    ma, mb = master(a), master(b)
    assert set(ma) == set(mb)
    return all(ma[k].tobytes() == mb[k].tobytes() for k in ma)


def rank_fragments(rank, world, stage):  # noqa: ARG001 - a spawned gloo rank (torch_rank_group)
    """One rank of ``test_torch_engine_surface``'s two-rank fragment test:
    a step at ``stage`` over the global micro batch, then every
    ``tensor_fragment`` getter against the gathered state, and a set that
    both ranks must see."""
    from deepspeed_tpu_torch.utils import tensor_fragment as tf

    e = port(cfg(micro=4, zero_optimization={"stage": stage}))
    e.train_batch(batch=data(1, 1, rows=4 * world)[0])
    full = {k: np.asarray(v) for k, v in flatten_tree(e.get_master_params()).items()}
    opt = e._full_opt_state()
    out = {}
    for k in ("layers/wq", "embed/tokens", "final_norm_scale"):
        out[k] = (np.array_equal(tf.safe_get_full_fp32_param(e, k), full[k]),
                  np.array_equal(tf.safe_get_full_optimizer_state(e, k, "exp_avg"), opt.exp_avg[k].numpy()),
                  np.array_equal(tf.safe_get_full_optimizer_state(e, k, "exp_avg_sq"), opt.exp_avg_sq[k].numpy()))
    value = np.full(full["layers/wq"].shape, 0.25, np.float32)
    tf.safe_set_full_fp32_param(e, "layers/wq", value)
    out["set"] = np.array_equal(flatten_tree(e.get_master_params())["layers/wq"], value)
    return out


def rank_fused(rank, world):  # noqa: ARG001 - a spawned gloo rank (torch_rank_group)
    """One rank of ``test_torch_step_programs``' dp = 2 fused-step test: the
    fused step at gas 2 (its body uncaptured at dp > 1) and the eager step
    on the same global microbatches; their losses, norms and master."""
    out = {}
    batches = data(2, 3, rows=4 * world, seed=11)
    for fuse in (False, True):
        e = port(cfg(2, fuse=fuse, micro=4, zero_optimization={"stage": 2}))
        rec = drive(e, batches, 3)
        out[fuse] = (rec, master(e), e.window_stats()["graphs"])
    return out
