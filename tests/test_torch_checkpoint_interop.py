"""The port's training checkpoints held against the JAX package.

The engine checkpoints differ in format (JAX writes orbax arrays, the port
one ``arrays.pt``), so what is held here is what ties them:

* behaviour: the same seeded tree trains 6 steps in both engines (fp32,
  a warm-up lr, clipping; JAX on the 8-device CPU mesh at micro 1, the port
  at micro 8): losses and grad norms within 1e-5 relative, masters within
  1e-5;
* ``meta.pkl``: the skeleton's paths and node kinds equal JAX's but for
  ``rng`` (the port's dropout generator state) and ``mesh`` (one rank);
* discovery: JAX's ``list_valid_tags`` / ``find_latest_valid`` give the
  port's answers on the port's save directory and on crafted staging,
  trash, torn and temp directories;
* the files both packages read: the reference-layout export (2 dp
  shards, with padding: 32,307 parameters) read bitwise by the other
  package's ``merge_reference_model_states`` / ``merge_reference_zero_fp32``
  and equal to the other's export; ``convert_to_universal`` npz files
  cross-read with ``load_hp_checkpoint_state``; ``save_16bit_model``
  ``.bin`` and ``.npz`` equal JAX's name for name (bf16 as numpy stores
  JAX's bf16);
* serving: ``init_inference(checkpoint=<port tag dir>)`` holds the
  checkpoint's module bitwise, and its logits equal the JAX inference
  engine's ``set_params`` of the same module within 1e-5.

Two JAX engines (training, inference), built once in a module fixture.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.checkpoint import deepspeed_checkpoint as jax_universal
from deepspeed_tpu.checkpoint import reference_ingest as jax_ingest
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import config as jax_model_config
from deepspeed_tpu.runtime.checkpoint_engine import atomic as jax_atomic
from deepspeed_tpu_torch.checkpoint import deepspeed_checkpoint as port_universal
from deepspeed_tpu_torch.checkpoint import reference_ingest as port_ingest
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree
from deepspeed_tpu_torch.models import TransformerLM
from deepspeed_tpu_torch.models import config as port_model_config
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.runtime.checkpoint_engine import atomic as port_atomic
from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

# an odd width and vocabulary: 32,307 parameters, so 2 dp shards pad one element
MODEL = dict(vocab_size=127, hidden_size=33, num_layers=2, num_heads=3, max_seq_len=32, dtype="float32",
             remat=False)
CONFIG = {
    "optimizer": {"type": "adam", "params": {"lr": 3e-3, "weight_decay": 0.01}},
    "gradient_clipping": 1.0,
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-3, "warmup_num_steps": 4}},
    "steps_per_print": 10_000,
}
ROWS, T, STEPS = 8, 16, 6


def _batch(step):
    toks = np.random.RandomState(200 + step).randint(0, MODEL["vocab_size"], (ROWS, T + 1)).astype(np.int32)
    return {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}


def _ref_dir_files(path):
    return sorted(os.listdir(path))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both engines from one tree: exports at step 0 (both hold exactly
    the tree), 6 recorded steps, an engine checkpoint and a universal
    conversion at step 6; then the JAX inference engine's logits on the
    port checkpoint's module."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("interop")
    tree = unflatten_tree(init_params(port_model_config.TransformerConfig(**MODEL), 0))
    je, *_ = ds.initialize(model=JaxLM(jax_model_config.TransformerConfig(**dict(MODEL, flash_attention=False))),
                           config=dict(CONFIG, train_micro_batch_size_per_gpu=1), model_parameters=tree)
    pe, *_ = dst.initialize(model=TransformerLM(port_model_config.TransformerConfig(**MODEL)),
                            config=dict(CONFIG, train_micro_batch_size_per_gpu=ROWS), model_parameters=tree,
                            device="cpu")
    je.init_params(_batch(0))  # JAX builds its state lazily; this adopts the given tree
    out = {"root": root, "tree": tree}
    for name, eng in (("jax", je), ("port", pe)):
        eng.save_16bit_model(str(root / name / "16bit"), "pytorch_model.bin")
        eng.save_16bit_model(str(root / name / "16bit"), "model.npz")
        eng.save_reference_checkpoint(str(root / name / "reference"), dp_shards=2)
    rec = {"jax": [], "port": []}
    for step in range(STEPS):
        for name, eng in (("jax", je), ("port", pe)):
            loss = eng(_batch(step))
            eng.backward(loss)
            eng.step()
            rec[name].append((float(loss), eng.get_global_grad_norm()))
        if step == 2:
            pe.save_checkpoint(str(root / "port" / "ckpt"))
    for name, eng, universal in (("jax", je, jax_universal), ("port", pe, port_universal)):
        eng.save_checkpoint(str(root / name / "ckpt"), client_state={"note": "six"})
        universal.convert_to_universal(str(root / name / "ckpt"), str(root / name / "universal"))
    out["records"] = {k: np.array(v) for k, v in rec.items()}
    out["masters"] = {"jax": flatten_tree(jax.tree_util.tree_map(np.asarray, je.get_master_params())),
                      "port": flatten_tree(pe.get_master_params())}
    out["tag_dir"] = str(root / "port" / "ckpt" / "global_step6")
    module = port_universal.DeepSpeedCheckpoint(str(root / "port" / "ckpt")).get_module()
    out["module"] = {k: v.numpy() for k, v in flatten_tree(module).items()}
    ie = ds.init_inference(JaxLM(jax_model_config.TransformerConfig(**dict(MODEL, flash_attention=False))),
                           dtype="fp32")
    ie.set_params(unflatten_tree(out["module"]))
    tokens = _batch(99)["input_ids"][:2]
    out["tokens"] = tokens
    out["jax_logits"] = np.asarray(ie(jnp.asarray(tokens)))
    return out


def test_losses_match_jax(runs):
    """6 fp32 steps from the same tree and batches: losses and grad norms
    within 1e-5 relative, every master element within 1e-5."""
    j, p = runs["records"]["jax"], runs["records"]["port"]
    np.testing.assert_allclose(p[:, 0], j[:, 0], rtol=1e-5)
    np.testing.assert_allclose(p[:, 1], j[:, 1], rtol=1e-5)
    for path, ref in runs["masters"]["jax"].items():
        np.testing.assert_allclose(runs["masters"]["port"][path], ref, rtol=0, atol=1e-5, err_msg=path)


def _nodes(skeleton):
    """``{path: kind}`` of every leaf node of a skeleton."""
    out = {}

    def walk(obj, where):
        if isinstance(obj, dict) and "__array_ref__" in obj:
            out[obj["__array_ref__"]] = "array"
        elif isinstance(obj, dict) and "__meta_ref__" in obj:
            out[obj["__meta_ref__"]] = "meta"
        elif isinstance(obj, dict) and "__seq__" in obj:
            for i, v in enumerate(obj["items"]):
                walk(v, f"{where}/{i}")
        elif isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{where}/{k}")

    walk(skeleton, "root")
    return out


def test_meta_skeleton_matches_jax(runs):
    """The skeleton's paths and kinds (tensor or pickled value) are JAX's,
    but for the two listed subtrees: ``rng`` (JAX: the PRNG key array; the
    port: the numpy dropout generator's state) and ``mesh`` (JAX: its
    8-device mesh axes; the port: ``{"data": 1}``)."""
    skel = {}
    for name in ("jax", "port"):
        with open(os.path.join(runs["root"], name, "ckpt", "global_step6", "meta.pkl"), "rb") as f:
            blob = pickle.load(f)
        skel[name] = (_nodes(blob["skeleton"]), blob["meta"])
    (jn, jmeta), (pn, pmeta) = skel["jax"], skel["port"]
    differ = sorted(p for p in set(jn) | set(pn) if jn.get(p) != pn.get(p))
    allowed = ("root/rng", "root/mesh/")
    assert differ and all(p.startswith(allowed) for p in differ), differ
    assert jn["root/rng"] == "array" and pn["root/rng/bit_generator"] == "meta"
    assert pmeta["root/mesh/data"] == 1 and "root/module/layers/wq" in pn and pn["root/module/layers/wq"] == "array"
    assert pmeta["root/client_state/note"] == jmeta["root/client_state/note"] == "six"
    for key in ("root/global_steps", "root/micro_steps", "root/lr_scheduler/last_batch_iteration", "root/master"):
        assert pmeta[key] == jmeta[key], key


def _craft(save_dir):
    """Beside real tags: a staging dir, an orphaned trash dir whose tag is
    missing (a kill inside a re-save), a torn tag, a temp dir, a marker."""
    os.makedirs(os.path.join(save_dir, "global_step9.staging"))
    shutil.copytree(os.path.join(save_dir, "global_step3"), os.path.join(save_dir, "best.trash-123"))
    os.makedirs(os.path.join(save_dir, "global_step12"))  # torn: no meta.pkl
    shutil.copytree(os.path.join(save_dir, "global_step3"), os.path.join(save_dir, "global_step11.tmp"))
    with open(os.path.join(save_dir, "global_step3", "meta.pkl.tmp-1-2"), "w") as f:
        f.write("x")


def test_discovery_agrees_with_jax(runs, tmp_path):
    """Each package's discovery on its own copy of the port's save
    directory, plain and crafted: the same tags, the same newest, the same
    repaired listing."""
    src = os.path.join(runs["root"], "port", "ckpt")
    answers = {}
    for name, mod in (("jax", jax_atomic), ("port", port_atomic)):
        d = str(tmp_path / name)
        shutil.copytree(src, d)
        plain = (mod.list_valid_tags(d), mod.find_latest_valid(d), mod.read_latest_marker(d))
        _craft(d)
        crafted = (mod.list_valid_tags(d), mod.find_latest_valid(d))
        answers[name] = (plain, crafted, sorted(os.listdir(d)))
    assert answers["port"] == answers["jax"]
    plain, crafted, _ = answers["port"]
    assert plain == (["global_step3", "global_step6"], "global_step6", "global_step6")
    assert crafted == (["best", "global_step3", "global_step6"], "global_step6")
    assert port_atomic.is_complete_checkpoint(runs["tag_dir"]) and jax_atomic.is_complete_checkpoint(runs["tag_dir"])


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def test_reference_export_cross_reads_bitwise(runs):
    """At step 0 both engines hold the tree: the two exports are equal file
    for file, and each package's readers give the tree bitwise from the
    other's files (2 dp shards, one element of padding)."""
    tree = flatten_tree(runs["tree"])
    exports = {name: os.path.join(runs["root"], name, "reference") for name in ("jax", "port")}
    assert _ref_dir_files(exports["jax"]) == _ref_dir_files(exports["port"]) == ["global_step0", "latest"]
    files = _ref_dir_files(os.path.join(exports["port"], "global_step0"))
    assert files == ["mp_rank_00_model_states.pt", "zero_pp_rank_0_mp_rank_00_optim_states.pt",
                     "zero_pp_rank_1_mp_rank_00_optim_states.pt"]
    for fn in files:
        j, p = _load(os.path.join(exports["jax"], "global_step0", fn)), _load(os.path.join(exports["port"], "global_step0", fn))
        assert list(j) == list(p)
        if "optimizer_state_dict" in j:
            jo, po = j["optimizer_state_dict"], p["optimizer_state_dict"]
            assert {k: v for k, v in jo.items() if k != "single_partition_of_fp32_groups"} == \
                {k: v for k, v in po.items() if k != "single_partition_of_fp32_groups"}
            assert torch.equal(jo["single_partition_of_fp32_groups"][0], po["single_partition_of_fp32_groups"][0])
            assert po["single_partition_of_fp32_groups"][0].numel() == (32307 + 1) // 2
        else:
            assert list(j["module"]) == list(p["module"])
            assert all(torch.equal(j["module"][k], p["module"][k]) for k in j["module"])
            assert {k: v for k, v in j.items() if k != "module"} == {k: v for k, v in p.items() if k != "module"}
    for reader, writer in ((jax_ingest, "port"), (port_ingest, "jax")):
        module, meta = reader.merge_reference_model_states(exports[writer], "gpt2")
        fp32 = reader.merge_reference_zero_fp32(exports[writer], "gpt2")
        assert meta["tp_degree"] == 1 and meta["dp_world_size"] == 2
        assert list(module) == list(fp32) == sorted(tree)
        for k, v in tree.items():
            assert np.array_equal(module[k], v) and np.array_equal(fp32[k], v), (writer, k)


def test_universal_and_zero_to_fp32_cross_read(runs):
    """``convert_to_universal`` of each package's step-6 checkpoint: the
    same names and meta keys; each package's ``load_hp_checkpoint_state``
    reads the other's file bitwise as its own reader does; the two
    packages' values within 1e-5. The port's ``zero_to_fp32`` gives its
    engine's master."""
    uni = {name: os.path.join(runs["root"], name, "universal") for name in ("jax", "port")}
    names = port_universal.universal_param_names(uni["port"])
    assert names == jax_universal.universal_param_names(uni["jax"]) == jax_universal.universal_param_names(uni["port"])
    for name in names:
        for writer in ("jax", "port"):
            a = jax_universal.load_hp_checkpoint_state(uni[writer], name)
            b = port_universal.load_hp_checkpoint_state(uni[writer], name)
            assert sorted(a) == sorted(b) == ["exp_avg", "exp_avg_sq", "fp32"]
            assert all(np.array_equal(a[k], b[k]) for k in a)
        j = port_universal.load_hp_checkpoint_state(uni["jax"], name)
        p = port_universal.load_hp_checkpoint_state(uni["port"], name)
        np.testing.assert_allclose(p["fp32"], j["fp32"], rtol=0, atol=1e-5, err_msg=name)
        assert np.array_equal(p["fp32"], runs["masters"]["port"][name])
    metas = [json.load(open(os.path.join(uni[n], "universal_meta.json"))) for n in ("jax", "port")]
    assert sorted(metas[0]) == sorted(metas[1]) and metas[0]["param_shapes"] == metas[1]["param_shapes"]
    assert metas[0]["iteration"] == metas[1]["iteration"] == STEPS
    fp32 = get_fp32_state_dict_from_zero_checkpoint(os.path.join(runs["root"], "port", "ckpt"))
    assert list(fp32) == names and all(np.array_equal(fp32[k], runs["masters"]["port"][k]) for k in names)


def test_16bit_model_files_equal_jax(runs, tmp_path):
    """``.bin`` (a torch state dict of fp32 tensors) and ``.npz`` at step
    0: name for name, dtype for dtype, bitwise. In bf16 the port's npz
    holds what ``np.savez`` writes for JAX's bf16 leaves (2-byte raw
    values)."""
    d = {name: os.path.join(runs["root"], name, "16bit") for name in ("jax", "port")}
    j, p = _load(os.path.join(d["jax"], "pytorch_model.bin")), _load(os.path.join(d["port"], "pytorch_model.bin"))
    assert list(j) == list(p) and all(p[k].dtype == torch.float32 and torch.equal(j[k], p[k]) for k in j)
    j, p = np.load(os.path.join(d["jax"], "model.npz")), np.load(os.path.join(d["port"], "model.npz"))
    assert j.files == p.files
    assert all(j[k].dtype == p[k].dtype and np.array_equal(j[k], p[k]) for k in j.files)
    kw = dict(MODEL, dtype="bfloat16")
    pe, *_ = dst.initialize(model=TransformerLM(port_model_config.TransformerConfig(**kw)),
                            config=dict(CONFIG, train_micro_batch_size_per_gpu=ROWS, bf16={"enabled": True}),
                            model_parameters=runs["tree"], device="cpu")
    pe.save_16bit_model(str(tmp_path), "bf16.npz")
    sd = pe.consolidated_16bit_state_dict()
    np.savez(str(tmp_path / "want.npz"), **{k: np.asarray(jnp.asarray(v.float().numpy(), jnp.bfloat16))
                                            for k, v in sd.items()})
    got, want = np.load(str(tmp_path / "bf16.npz")), np.load(str(tmp_path / "want.npz"))
    assert got.files == want.files
    assert all(got[k].dtype == want[k].dtype == np.dtype("V2") and got[k].tobytes() == want[k].tobytes()
               for k in got.files)


def test_init_inference_from_training_checkpoint_matches_jax(runs):
    """The serving engine booted from the port's tag directory holds the
    checkpoint's module bitwise; its logits equal the JAX inference
    engine's on the same module within 1e-5."""
    engine = dst.init_inference(TransformerLM(port_model_config.TransformerConfig(**MODEL)), dtype="fp32",
                                checkpoint=runs["tag_dir"], device="cpu")
    held = flatten_tree(engine.module.param_tree())
    assert set(held) == set(runs["module"])
    assert all(np.array_equal(held[k].numpy(), v) for k, v in runs["module"].items())
    logits = engine(torch.from_numpy(runs["tokens"]).long()).numpy()
    np.testing.assert_allclose(logits, runs["jax_logits"], rtol=1e-5, atol=1e-5)
