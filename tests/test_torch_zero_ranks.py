"""Data parallelism with ZeRO stages 0-3 across two gloo ranks, against the
JAX engine on a ``data`` mesh of two CPU devices.

One rank group (``torch_rank_group.py``, two ranks) runs every scenario in
sequence while the parent builds the references. The model is the tiny
GPT-2 of ``test_torch_training.py`` (T = 16), every rank passes the global
micro batch (8 rows) and takes its 4; JAX runs the same rows as micro 4 x
``mesh.data`` 2 (its flash attention off: the Pallas interpret mode costs
too much here; the port keeps its flash route, the plain functions on the
CPU):

* fp32, gas 2, clip 0.1, 3 steps through ``train_batch``, stages 0, 1, 2
  and 3 (stage 3 with ``stage3_param_persistence_threshold`` 0, as JAX
  ``test_zero.py:80``, so that the tiny leaves shard): every stage's
  losses and grad norms within 1e-5 relative and its gathered master
  within 1e-5 of ONE JAX engine's (fp32, stage 3; JAX's stages share the
  math), on both ranks;
* stage 3 with ``remat`` on (each layer gathered again in its
  recomputation): bitwise the remat-off run;
* bf16 at stage 3 against a JAX bf16 stage-3 engine at the bf16 bounds of
  ``test_torch_training.py`` (loss 1e-4, norm 2e-3, 99% of the master
  within 5e-5);
* fp16 at a loss scale of 2^32, stage 2: the overflow skips the step on
  both ranks and halves the scale;
* ``zero.GatheredParameters(engine=..., modifier_rank=0)``: rank 0's edit
  reaches both ranks (rank 1's is dropped) and survives a step;
* the cross-rank tag check: ``Fail`` raises on both ranks, ``Warn`` saves
  under rank 0's tag;
* checkpoints at N ranks: a dp = 2 stage-3 fp32 tag holds the gathered
  master bitwise; loaded at dp = 1 stage 1 it resumes bitwise twice and
  within 1e-5 of the ranks' own continuation; the JAX engine takes its
  module (``set_params``) and scores a batch within 1e-5 of the resumed
  port engine; ``zero_to_fp32`` reads it; and a dp = 1 stage-1 tag loads
  at dp = 2 stage 3 with its master bitwise.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch import zero
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree
from deepspeed_tpu_torch.models import TransformerLM
from deepspeed_tpu_torch.models.config import TransformerConfig
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_checkpoint_engine import TorchCheckpointEngine
from torch_rank_group import join_ranks, start_ranks

DP = 2
T = 16
MICRO = 4  # rows a rank; the global micro batch is MICRO x DP
GPT2 = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2, max_seq_len=128, dtype="float32",
            remat=False)
LR = 3e-4
FP32 = {"gradient_accumulation_steps": 2, "optimizer": {"type": "adam", "params": {"lr": LR, "weight_decay": 0.01}},
        "gradient_clipping": 0.1, "steps_per_print": 10**6}
BF16 = {"optimizer": {"type": "adam", "params": {"lr": LR, "weight_decay": 0.01}}, "bf16": {"enabled": True},
        "gradient_clipping": 1.0, "steps_per_print": 10**6}
STEPS = 3
CKPT_AT = 2  # steps before the dp = 2 save; as many follow it


def _zero(stage):
    return {"stage": stage, "stage3_param_persistence_threshold": 0}


def _tree(model_kw):
    return unflatten_tree(init_params(TransformerConfig(**model_kw), 0))


def _batches(n, rows, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rs.randint(0, GPT2["vocab_size"], (rows, T + 1)).astype(np.int32)
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _port(base, stage, model_kw=GPT2, dp=DP, **extra):
    cfg = dict({"zero_optimization": _zero(stage)}, **base)
    cfg.update(train_micro_batch_size_per_gpu=MICRO * DP // dp, **extra)
    engine, *_ = dst.initialize(model=TransformerLM(TransformerConfig(**model_kw)), config=cfg,
                                model_parameters=_tree(model_kw), device="cpu")
    return engine


def _train(engine, batches):
    rec = []
    for b in batches:
        rec.append((engine.train_batch(batch=b), engine.get_global_grad_norm()))
    return rec


def _master(engine):
    return {k: np.array(v) for k, v in flatten_tree(engine.get_master_params()).items()}  # not views of the live state


# --- the ranks ---------------------------------------------------------------------------------
def _rank_main(rank, world, tmp):  # noqa: ARG001
    out = {}
    fp32_batches = _batches(STEPS, 2 * MICRO * DP)
    for stage in (0, 1, 2, 3):
        engine = _port(FP32, stage)
        out[f"fp32_{stage}"] = (_train(engine, fp32_batches), _master(engine),
                                {k: tuple(p.shape) for k, p in engine._params.items()})
    for stage, overlap in ((2, True), (3, False)):  # overlap_comm's default is on at stage 3 only
        engine = _port(dict(FP32, zero_optimization=dict(_zero(stage), overlap_comm=overlap)), stage)
        out[f"overlap_{stage}"] = (_train(engine, fp32_batches), _master(engine))
    engine = _port(FP32, 3, dict(GPT2, remat=True))  # each layer gathered again in its recomputation
    out["remat_3"] = (_train(engine, fp32_batches), _master(engine))
    engine = _port(BF16, 3, dict(GPT2, dtype="bfloat16"))
    out["bf16"] = (_train(engine, _batches(STEPS, MICRO * DP, seed=1)), _master(engine))

    fp16 = {k: v for k, v in BF16.items() if k != "bf16"}
    engine = _port(dict(fp16, fp16={"enabled": True, "initial_scale_power": 32, "hysteresis": 1}), 2,
                   dict(GPT2, dtype="float16"))
    before = _master(engine)
    _train(engine, _batches(1, MICRO * DP, seed=2))
    out["fp16"] = dict(skipped=engine.skipped_steps, scale=engine.loss_scale,
                       unchanged=all(np.array_equal(v, before[k]) for k, v in _master(engine).items()))

    engine = _port(FP32, 3)
    with zero.GatheredParameters(engine=engine, modifier_rank=0) as params:
        params["embed"]["pos"][:] = 0.25 if rank == 0 else 7.0
    edited = flatten_tree(engine.get_params())["embed/pos"].copy()
    _train(engine, _batches(1, 2 * MICRO * DP, seed=3))
    out["gathered"] = dict(edited=edited, after=_master(engine)["embed/pos"])

    tags = {}
    for mode in ("Fail", "Warn"):
        engine = _port(dict(FP32, checkpoint={"tag_validation": mode}), 1)
        try:
            engine.save_checkpoint(os.path.join(tmp, f"tags_{mode}"), tag=f"t{rank}")
            tags[mode] = "saved"
        except RuntimeError as e:
            tags[mode] = str(e)
    out["tags"] = tags

    engine = _port(FP32, 3)
    _train(engine, fp32_batches[:CKPT_AT])
    out["ckpt_master"] = _master(engine)
    engine.save_checkpoint(os.path.join(tmp, "dp2"), tag="dp2")
    out["ckpt_continue"] = _train(engine, _batches(CKPT_AT, 2 * MICRO * DP, seed=4))

    engine = _port(FP32, 3)  # a dp = 1 stage-1 tag, written by the parent, loaded at dp = 2 stage 3
    engine.load_checkpoint(os.path.join(tmp, "dp1"), tag="dp1", load_module_strict=False)
    out["from_dp1"] = dict(master=_master(engine), rec=_train(engine, _batches(1, 2 * MICRO * DP, seed=5)),
                           steps=engine.global_steps, samples=engine.global_samples)
    return out


# --- the references ----------------------------------------------------------------------------
def _jax_engine(base, stage, model_kw, first_batch):
    """JAX's engine on a two-device ``data`` mesh, its state made from
    ``first_batch`` with the rng key and the loss-scale state placed
    replicated on the mesh, where its first step leaves them: the fused
    step then compiles once, not once for the first step and again for
    the rest (the same values either way)."""
    import deepspeed_tpu as ds
    import jax
    from deepspeed_tpu.models import TransformerLM as JaxLM
    from deepspeed_tpu.models import config as jax_model_config
    from deepspeed_tpu.parallel import mesh as mesh_mod
    from deepspeed_tpu.runtime.config import MeshConfig
    from jax.sharding import NamedSharding, PartitionSpec

    topo = mesh_mod.initialize_topology(MeshConfig(data=DP), devices=jax.devices()[:DP])
    cfg = dict(base, train_micro_batch_size_per_gpu=MICRO, zero_optimization=_zero(stage), mesh={"data": DP})
    jm = JaxLM(jax_model_config.TransformerConfig(**dict(model_kw, flash_attention=False)))
    engine, *_ = ds.initialize(model=jm, config=cfg, model_parameters=_tree(model_kw))
    assert engine.data_parallel_world_size() == DP
    replicated = NamedSharding(topo.mesh, PartitionSpec())
    micro = {k: v[:MICRO * DP] for k, v in first_batch.items()}
    engine.init_params(micro, rng=jax.device_put(jax.random.PRNGKey(42), replicated))  # the engine's own seed
    engine._scale_state = jax.device_put(engine._scale_state, replicated)
    return engine


def _jax_master(engine):
    import jax

    return flatten_tree(jax.tree_util.tree_map(np.asarray, engine.get_master_params()))


def _dp1_tag(tmp):
    engine = _port(FP32, 1, dp=1)
    _train(engine, _batches(1, 2 * MICRO * DP, seed=6))
    engine.save_checkpoint(os.path.join(tmp, "dp1"), tag="dp1")
    return _master(engine), _train(engine, _batches(1, 2 * MICRO * DP, seed=5))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("zero_ranks"))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        dp1_master, dp1_continue = _dp1_tag(tmp)
        handle = start_ranks(_rank_main, DP, os.path.join(tmp, "ranks"), tmp)
        fp32_batches, bf16_batches = _batches(STEPS, 2 * MICRO * DP), _batches(STEPS, MICRO * DP, seed=1)
        je = _jax_engine(FP32, 3, GPT2, fp32_batches[0])
        jax_fp32 = ([(float(je.train_batch(batch=b)), je.get_global_grad_norm()) for b in fp32_batches],
                    _jax_master(je))
        jb = _jax_engine(BF16, 3, dict(GPT2, dtype="bfloat16"), bf16_batches[0])
        jax_bf16 = ([(float(jb.train_batch(batch=b)), jb.get_global_grad_norm()) for b in bf16_batches],
                    _jax_master(jb))
        ranks = join_ranks(handle, limit_s=200.0)
        # the fp32 JAX engine takes the ranks' dp = 2 tag's module and scores a batch (on its own mesh,
        # which the suite resets after this test)
        state = TorchCheckpointEngine().load(os.path.join(tmp, "dp2", "dp2"))
        je.set_params(unflatten_tree({k: v.numpy() for k, v in flatten_tree(state["module"]).items()}))
        je.eval()
        jax_ckpt_loss = float(je(_batches(1, MICRO * DP, seed=7)[0]))
    finally:
        torch.set_num_threads(prev)
    return dict(ranks=ranks, jax_fp32=jax_fp32, jax_bf16=jax_bf16, jax_ckpt_loss=jax_ckpt_loss, tmp=tmp,
                dp1_master=dp1_master, dp1_continue=dp1_continue)


def _close(rec, ref, rtol):
    rec, ref = np.asarray(rec, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(rec[:, 0], ref[:, 0], rtol=rtol)
    np.testing.assert_allclose(rec[:, 1], ref[:, 1], rtol=rtol)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_fp32_stages_match_jax(runs, stage):
    """Each stage's losses and grad norms (clip 0.1 active) within 1e-5 of
    JAX's dp = 2 engine, its gathered master within 1e-5, on both ranks;
    the stage decides only where state lives."""
    ref_rec, ref_master = runs["jax_fp32"]
    assert all(n > 0.1 for _, n in ref_rec)  # clipping engaged
    for rank, res in enumerate(runs["ranks"]):
        rec, master, shapes = res[f"fp32_{stage}"]
        _close(rec, ref_rec, 1e-5)
        assert set(master) == set(ref_master)
        for k, v in master.items():
            assert np.abs(v - ref_master[k]).max() <= 1e-5, (rank, k)
        sharded = [k for k, s in shapes.items() if s != ref_master[k].shape]
        assert bool(sharded) == (stage == 3), (stage, sharded)  # only stage 3 stores the compute copy sliced
    stage0 = runs["ranks"][0]["fp32_0"][0]
    _close(runs["ranks"][0][f"fp32_{stage}"][0], stage0, 1e-5)


@pytest.mark.parametrize("stage", [2, 3])
def test_overlap_comm_changes_no_bit(runs, stage):
    """``overlap_comm`` flipped (stage 2: gradient buckets sent while
    backward runs; stage 3: no prefetch, gathers at use) gives the same
    losses, norms and master bit for bit at two ranks."""
    for res in runs["ranks"]:
        rec, master = res[f"overlap_{stage}"]
        ref_rec, ref_master = res[f"fp32_{stage}"][:2]
        assert rec == ref_rec
        for k, v in master.items():
            np.testing.assert_array_equal(v, ref_master[k], err_msg=k)


def test_stage3_remat_regathers_each_layer_bitwise(runs):
    """Stage 3 with ``remat`` (the model config's default): each layer's
    recomputation in backward gathers its weights again inside the
    checkpoint; losses, norms and master equal the remat-off run bit for
    bit and JAX's within 1e-5, on both ranks."""
    ref_rec, ref_master = runs["jax_fp32"]
    for res in runs["ranks"]:
        rec, master = res["remat_3"]
        assert rec == res["fp32_3"][0]
        for k, v in master.items():
            np.testing.assert_array_equal(v, res["fp32_3"][1][k], err_msg=k)
            assert np.abs(v - ref_master[k]).max() <= 1e-5, k
        _close(rec, ref_rec, 1e-5)


def test_bf16_stage3_matches_jax(runs):
    ref_rec, ref_master = runs["jax_bf16"]
    for res in runs["ranks"]:
        rec, master = res["bf16"]
        rec, ref = np.asarray(rec), np.asarray(ref_rec)
        np.testing.assert_allclose(rec[:, 0], ref[:, 0], rtol=1e-4)
        np.testing.assert_allclose(rec[:, 1], ref[:, 1], rtol=2e-3)
        gaps = {k: np.abs(v - ref_master[k]) for k, v in master.items()}
        for k, gap in gaps.items():
            assert gap.max() <= 2 * LR * STEPS, (k, gap.max())
        pooled = np.concatenate([g.ravel() for g in gaps.values()])
        assert np.percentile(pooled, 99) <= 5e-5


def test_fp16_overflow_skips_on_both_ranks(runs):
    for res in runs["ranks"]:
        assert res["fp16"] == dict(skipped=1, scale=2.0**31, unchanged=True)


def test_gathered_parameters_modifier_rank_edit_survives_a_step(runs):
    for res in runs["ranks"]:
        got = res["gathered"]
        assert np.all(got["edited"] == 0.25)  # rank 0's edit, on rank 1 too
        assert np.abs(got["after"] - 0.25).max() <= 2 * LR
    np.testing.assert_array_equal(runs["ranks"][0]["gathered"]["after"], runs["ranks"][1]["gathered"]["after"])


def test_checkpoint_tag_validation_across_ranks(runs):
    """``Fail`` raises on both ranks; ``Warn`` saves once, under rank 0's tag."""
    for res in runs["ranks"]:
        assert "tag mismatch" in res["tags"]["Fail"] and res["tags"]["Warn"] == "saved"
    assert sorted(os.listdir(os.path.join(runs["tmp"], "tags_Warn"))) == ["latest", "t0"]


def _dp1_resume(tmp):
    engine = _port(FP32, 1, dp=1)
    path, _ = engine.load_checkpoint(os.path.join(tmp, "dp2"), tag="dp2", load_module_strict=False)
    assert path.endswith("dp2")
    loaded = _master(engine)
    return engine, loaded, _train(engine, _batches(CKPT_AT, 2 * MICRO * DP, seed=4))


def test_dp2_stage3_checkpoint_resumes_at_dp1_bitwise(runs):
    """The dp = 2 stage-3 tag holds the gathered master bitwise; two dp = 1
    stage-1 engines resumed from it take bitwise the same steps, within
    1e-5 of the ranks' own continuation at dp = 2; ``zero_to_fp32`` reads
    the same master."""
    from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

    saved = runs["ranks"][0]["ckpt_master"]
    np.testing.assert_equal(saved, runs["ranks"][1]["ckpt_master"])
    a, loaded, rec_a = _dp1_resume(runs["tmp"])
    _, _, rec_b = _dp1_resume(runs["tmp"])
    for k, v in saved.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    assert rec_a == rec_b
    _close(rec_a, runs["ranks"][0]["ckpt_continue"], 1e-5)
    assert a.global_steps == 2 * CKPT_AT and a.global_samples == 2 * CKPT_AT * 2 * MICRO * DP
    fp32 = get_fp32_state_dict_from_zero_checkpoint(os.path.join(runs["tmp"], "dp2"), tag="dp2")
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(fp32[k]), v, err_msg=k)


def test_dp2_checkpoint_loads_into_the_jax_engine(runs):
    """The JAX engine takes the dp = 2 tag's module (``set_params``) and its
    loss on a batch is that of a port engine loaded from the tag at dp = 1,
    within 1e-5."""
    engine = _port(FP32, 1, dp=1)
    engine.load_checkpoint(os.path.join(runs["tmp"], "dp2"), tag="dp2", load_module_strict=False)
    engine.eval()
    np.testing.assert_allclose(float(engine(_batches(1, MICRO * DP, seed=7)[0])), runs["jax_ckpt_loss"], rtol=1e-5)


def test_dp1_checkpoint_loads_at_dp2_stage3(runs):
    """A dp = 1 stage-1 tag loads at dp = 2 stage 3: the gathered master is
    the saved one bitwise, the counters carry over, and the next step is the
    dp = 1 engine's within 1e-5."""
    for res in runs["ranks"]:
        got = res["from_dp1"]
        for k, v in runs["dp1_master"].items():
            np.testing.assert_array_equal(got["master"][k], v, err_msg=k)
        _close(got["rec"], runs["dp1_continue"], 1e-5)
        assert got["steps"] == 2 and got["samples"] == 2 * 2 * MICRO * DP
