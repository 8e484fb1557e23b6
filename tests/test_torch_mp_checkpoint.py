"""The dense tensor-parallel forward and ``generate``, and pre-sharded
inference checkpoints (``inference/mp_checkpoint.py``), against the JAX
package, on the CPU.

One gloo rank group at tp = 2 and one at tp = 4 (``torch_rank_group.py``)
each build ``init_inference(..., tensor_parallel={"tp_size": tp})`` on
JAX's tiny TP config (``tests/unit/inference/test_tp_serving.py:53-60``)
in fp32 from the same numpy-seeded tree as the JAX engines:

* ``engine(tokens)`` logits within 1e-5 of JAX's ``tp_size=2`` engine's
  (GSPMD) and bitwise equal across ranks; greedy ``generate`` token for
  token equal to JAX's; beam search equal to the port's tp = 1 beams, and
  a sampled draw equal on every rank;
* the checkpoint a port engine writes at tp (rank 0 gathers and writes,
  the others wait) has the same files, manifest and arrays as the JAX
  engine's at the same ``tp_size``; a JAX-written checkpoint boots port
  engines (tp and tp = 1) whose logits are bitwise those of the engine
  loaded from the tree, and JAX boots from the port's with JAX's own
  logits; the port's own round trip is bitwise;
* a journaled tensor-parallel serving engine: rank 0 alone writes, and a
  fresh engine on the directory recovers every stream on every rank;
* ``save_mp_checkpoint_path`` writes at ``set_params``, saving before the
  weights raises, and the layout cases of
  ``tests/unit/inference/test_checkpoint_sharding.py`` (a shard of a
  stacked leaf, an indivisible leaf kept whole, the manifest detection)
  hold for both writers and both readers; a checkpoint without a manifest
  is refused (ROADMAP T3).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree
from deepspeed_tpu_torch.inference.mp_checkpoint import (
    MANIFEST_NAME,
    is_mp_checkpoint,
    load_mp_checkpoint,
    save_mp_checkpoint,
)
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.models.transformer import init_params
from torch_rank_group import join_ranks, start_ranks

CFG = dict(
    vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=4, max_seq_len=64,
    norm="rmsnorm", position="rope", activation="swiglu", use_bias=False, tie_embeddings=False,
    flash_attention=False, dtype="float32",
)
DEGREES = (2, 4)
TOL = 1e-5
TOKENS = np.random.RandomState(0).randint(0, 128, (2, 16)).astype(np.int32)
PROMPTS = np.random.RandomState(1).randint(0, 128, (2, 8)).astype(np.int32)
NEW = 8


def _tree():
    return unflatten_tree(init_params(TransformerConfig(**CFG), 0))


def _engine(tp=1, **kw):
    return dst.init_inference(TransformerLM(TransformerConfig(**CFG)), dtype="fp32", device="cpu",
                              tensor_parallel={"tp_size": tp}, **kw)


def _dense(engine):
    """Logits, greedy, beam and sampled streams of one engine."""
    return dict(
        logits=engine(TOKENS).numpy(),
        greedy=engine.generate(PROMPTS, max_new_tokens=NEW).numpy(),
        beam=engine.generate(PROMPTS, max_new_tokens=6, num_beams=3).numpy(),
        sampled=engine.generate(PROMPTS, max_new_tokens=6, temperature=0.8, top_k=20).numpy(),
    )


# --- rank-side work ---------------------------------------------------------------------
def _rank_main(rank, world, tmp):  # noqa: ARG001
    engine = _engine(world)
    engine.set_params(_tree())
    out = _dense(engine)
    mpath = engine.save_mp_checkpoint(os.path.join(tmp, f"port_tp{world}"))
    out["own_logits"] = _engine(world, checkpoint=mpath)(TOKENS).numpy()
    out["jax_ckpt_logits"] = _engine(world, checkpoint=os.path.join(tmp, f"jax_tp{world}"))(TOKENS).numpy()
    auto = _engine(world, save_mp_checkpoint_path=os.path.join(tmp, f"auto_tp{world}"))
    auto.set_params(_tree())
    out["auto_saved"] = is_mp_checkpoint(os.path.join(tmp, f"auto_tp{world}"))
    out["shard_keys"] = sorted(flatten_tree(engine._tp_params))
    out["journal"] = _journal_route(world, tmp)
    return out


SERVER = dict(page_size=8, max_slots=4, prefill_chunk=8, attn_impl="plain")
JOURNAL_PROMPTS = [np.random.RandomState(12).randint(0, 128, (n,)).astype(np.int32) for n in (5, 11, 17)]


def _journal_route(world, tmp):
    """A journaled tp serving engine: rank 0 alone writes the journal; a
    fresh tp engine on the same directory (every rank replays it) recovers
    every finished result on every rank."""
    config = dict(paged_kv={**SERVER, "sharded": {"tp_degree": world}},
                  journal={"enabled": True, "dir": os.path.join(tmp, f"journal_tp{world}")})
    outs, writers = [], []
    for batch in (JOURNAL_PROMPTS, []):
        engine = _engine(**config)
        engine.set_params(_tree())
        outs.append([o.tolist() for o in engine.serve(batch, max_new_tokens=5)])
        writers.append(engine._paged_server.journal is not None)
    server = engine._paged_server
    return dict(outs=outs[0], writers=writers, recovered=[server.result(uid).tolist() for uid in range(3)],
                stats=server.serve_stats())


# --- the JAX side ------------------------------------------------------------------------
def _jax_engine(tp, **kw):
    import jax.numpy as jnp

    import deepspeed_tpu as ds
    import deepspeed_tpu.parallel.mesh as mesh_mod
    from deepspeed_tpu.models import TransformerLM as JaxLM
    from deepspeed_tpu.models.config import TransformerConfig as JaxConfig

    mesh_mod.reset_topology()
    jcfg = JaxConfig(**CFG)
    engine = ds.init_inference(JaxLM(jcfg), dtype="fp32", tensor_parallel={"tp_size": tp}, **kw)
    engine._ds_config = jcfg  # the JAX converted-family contract for the KV-cached generate
    if "checkpoint" not in kw:
        engine.set_params(unflatten_tree({k: jnp.asarray(v) for k, v in flatten_tree(_tree()).items()}))
    return engine


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX writes its checkpoints, the rank groups start (they read them),
    JAX's engine and the port's tp = 1 engine run meanwhile, then every
    rank's results; last, JAX boots from the port's checkpoint."""
    tmp = str(tmp_path_factory.mktemp("mp_ckpt"))
    jax_engines = {}
    for d in DEGREES:
        jax_engines[d] = _jax_engine(d)
        jax_engines[d].save_mp_checkpoint(os.path.join(tmp, f"jax_tp{d}"))
    handles = {d: start_ranks(_rank_main, d, os.path.join(tmp, f"ranks{d}"), tmp) for d in DEGREES}
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jax2 = jax_engines[2]
        jax_ref = dict(logits=np.asarray(jax2(TOKENS)),
                       greedy=np.asarray(jax2.generate(PROMPTS, max_new_tokens=NEW)))
        tp1 = _engine()
        tp1.set_params(_tree())
        port1 = _dense(tp1)
        port1["jax_ckpt_logits"] = {d: _engine(checkpoint=os.path.join(tmp, f"jax_tp{d}"))(TOKENS).numpy()
                                    for d in DEGREES}
        port = {d: join_ranks(handles[d]) for d in DEGREES}
    finally:
        torch.set_num_threads(prev)
    jax_from_port = np.asarray(_jax_engine(2, checkpoint=os.path.join(tmp, "port_tp2", MANIFEST_NAME))(TOKENS))
    return dict(tmp=tmp, jax=jax_ref, jax_from_port=jax_from_port, port1=port1, port=port)


@pytest.mark.parametrize("degree", DEGREES)
def test_tp_forward_logits_match_jax(runs, degree):
    """Every rank returns the full logits, within 1e-5 of JAX's
    ``tp_size=2`` engine's and of the port's tp = 1 engine's, bitwise equal
    across ranks."""
    ranks = runs["port"][degree]
    for res in ranks:
        assert res["logits"].shape == (2, 16, CFG["vocab_size"])
        np.testing.assert_allclose(res["logits"], runs["jax"]["logits"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(res["logits"], runs["port1"]["logits"], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(res["logits"], ranks[0]["logits"])


@pytest.mark.parametrize("degree", DEGREES)
def test_tp_generate_matches_jax(runs, degree):
    """Greedy ``generate`` token for token equal to JAX's TP engine's; beam
    search equal to the port's tp = 1 beams; a sampled draw (rank 0's,
    broadcast) the same on every rank."""
    ranks = runs["port"][degree]
    np.testing.assert_array_equal(runs["port1"]["greedy"], runs["jax"]["greedy"])
    for res in ranks:
        np.testing.assert_array_equal(res["greedy"], runs["jax"]["greedy"])
        np.testing.assert_array_equal(res["beam"], runs["port1"]["beam"])
        np.testing.assert_array_equal(res["sampled"], ranks[0]["sampled"])
    assert ranks[0]["sampled"].shape == (2, PROMPTS.shape[1] + 6)


def _npz(path):
    with np.load(path) as z:
        return list(z.files), {k: z[k] for k in z.files}


@pytest.mark.parametrize("degree", DEGREES)
def test_port_checkpoint_equals_jax(runs, degree):
    """The port's tp engine writes JAX's files, manifest and arrays."""
    port_dir = os.path.join(runs["tmp"], f"port_tp{degree}")
    jax_dir = os.path.join(runs["tmp"], f"jax_tp{degree}")
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    with open(os.path.join(port_dir, MANIFEST_NAME)) as f, open(os.path.join(jax_dir, MANIFEST_NAME)) as g:
        manifest, jax_manifest = json.load(f), json.load(g)
    assert manifest == jax_manifest
    assert manifest["tp_size"] == degree and manifest["shard_dims"]["layers/wq"] == 2
    for name in [manifest["non_tp"]] + manifest["tp"]:
        files, arrays = _npz(os.path.join(port_dir, name))
        jax_files, jax_arrays = _npz(os.path.join(jax_dir, name))
        assert files == jax_files
        for k in files:
            assert arrays[k].dtype == jax_arrays[k].dtype
            np.testing.assert_array_equal(arrays[k], jax_arrays[k])


@pytest.mark.parametrize("degree", DEGREES)
def test_checkpoints_boot_both_packages(runs, degree):
    """A JAX-written checkpoint boots tp and tp = 1 port engines with
    logits bitwise those of the engines loaded from the tree; the port's
    own round trip is bitwise; JAX boots from the port's checkpoint with
    JAX's own logits."""
    for res in runs["port"][degree]:
        np.testing.assert_array_equal(res["jax_ckpt_logits"], res["logits"])
        np.testing.assert_array_equal(res["own_logits"], res["logits"])
    np.testing.assert_array_equal(runs["port1"]["jax_ckpt_logits"][degree], runs["port1"]["logits"])
    np.testing.assert_array_equal(runs["jax_from_port"], runs["jax"]["logits"])


@pytest.mark.parametrize("degree", DEGREES)
def test_auto_save_and_rank_shards(runs, degree):
    """``save_mp_checkpoint_path`` writes at ``set_params`` on a tp engine
    (every rank sees it after the barrier), and each rank holds only its
    shard: a quarter or half of every column and row weight."""
    for res in runs["port"][degree]:
        assert res["auto_saved"]
        assert "layers/wq" in res["shard_keys"] and "lm_head" in res["shard_keys"]


@pytest.mark.parametrize("degree", DEGREES)
def test_tp_journal_rank0_writes_and_recovers(runs, degree):
    """Under tensor-parallel serving only group rank 0 opens the journal's
    writer (every rank replays it); a fresh tp engine on the directory
    recovers every finished stream on every rank, equal to the single-rank
    server's."""
    ref = _engine(paged_kv=SERVER)
    ref.set_params(_tree())
    want = [o.tolist() for o in ref.serve(JOURNAL_PROMPTS, max_new_tokens=5)]
    for rank, res in enumerate(runs["port"][degree]):
        got = res["journal"]
        assert got["writers"] == [rank == 0, rank == 0]
        assert got["outs"] == want and got["recovered"] == want
        assert got["stats"]["recovered"] == 0 and got["stats"]["tp_degree"] == degree


def test_auto_save_single_rank(tmp_path):
    engine = _engine(save_mp_checkpoint_path=str(tmp_path))
    engine.set_params(_tree())
    with open(tmp_path / MANIFEST_NAME) as f:
        manifest = json.load(f)
    assert manifest["tp_size"] == 1 and manifest["shard_dims"] == {}
    loaded, _ = load_mp_checkpoint(str(tmp_path))
    for path, leaf in flatten_tree(_tree()).items():
        np.testing.assert_array_equal(flatten_tree(loaded)[path], leaf)


def test_save_before_weights_raises(tmp_path):
    with pytest.raises(RuntimeError, match="before weights"):
        _engine().save_mp_checkpoint(str(tmp_path))


def test_non_manifest_checkpoint_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP T3"):
        _engine(checkpoint=str(tmp_path))


def _layout_params():
    rs = np.random.RandomState(0)
    return {
        "embed": {"tokens": rs.randn(16, 8).astype(np.float32)},
        "layers": {"wq": rs.randn(2, 8, 12).astype(np.float32), "norm": rs.randn(2, 8).astype(np.float32)},
    }


def test_layout_matches_jax_and_reads_across(tmp_path):
    """``test_checkpoint_sharding.py``'s layout case: a stacked leaf split
    four ways, the rest whole; the two writers' files are equal and each
    package reads the other's."""
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.inference import mp_checkpoint as jax_mp

    params = _layout_params()
    port_path = save_mp_checkpoint(params, {"embed": {"tokens": None}, "layers": {"wq": 2, "norm": None}},
                                   str(tmp_path / "port"), tag="t", tp_size=4)
    jax_path = jax_mp.save_mp_checkpoint(params, {"embed": {"tokens": None}, "layers": {"wq": P(None, None, "model"),
                                                                                        "norm": None}},
                                         str(tmp_path / "jax"), tag="t", tp_size=4)
    assert os.path.basename(port_path) == MANIFEST_NAME
    with open(port_path) as f, open(jax_path) as g:
        manifest = json.load(f)
        assert manifest == json.load(g)
    assert manifest["shard_dims"] == {"layers/wq": 2}
    files, arrays = _npz(tmp_path / "port" / manifest["tp"][1])
    assert files == ["layers|wq"] and arrays["layers|wq"].shape == (2, 8, 3)
    for reader in (load_mp_checkpoint, jax_mp.load_mp_checkpoint):
        for path in (port_path, jax_path):
            loaded, _ = reader(path)
            for group in ("embed", "layers"):
                for k, v in params[group].items():
                    np.testing.assert_array_equal(np.asarray(loaded[group][k]), v)


def test_indivisible_leaf_stays_replicated(tmp_path):
    from deepspeed_tpu.inference import mp_checkpoint as jax_mp

    params = {"w": np.arange(10, dtype=np.float32).reshape(2, 5)}
    mpath = save_mp_checkpoint(params, {"w": 1}, str(tmp_path), tp_size=4)
    with open(mpath) as f:
        assert json.load(f)["shard_dims"] == {}  # 5 % 4 != 0: kept whole
    for reader in (load_mp_checkpoint, jax_mp.load_mp_checkpoint):
        loaded, _ = reader(str(tmp_path))
        np.testing.assert_array_equal(np.asarray(loaded["w"]), params["w"])


def test_is_mp_checkpoint_detection(tmp_path):
    assert not is_mp_checkpoint(str(tmp_path))
    save_mp_checkpoint({"w": np.ones((2, 2), np.float32)}, {"w": None}, str(tmp_path))
    assert is_mp_checkpoint(str(tmp_path))
    assert is_mp_checkpoint(os.path.join(tmp_path, MANIFEST_NAME))


def test_bf16_leaves_round_trip(tmp_path):
    """A bf16 engine's leaves are written as float32 with their dtype
    recorded, and load back to the same bf16 values."""
    engine = dst.init_inference(TransformerLM(TransformerConfig(**CFG)), dtype="bf16", device="cpu")
    engine.set_params(_tree())
    mpath = engine.save_mp_checkpoint(str(tmp_path))
    with open(mpath) as f:
        assert set(json.load(f)["dtypes"].values()) == {"bfloat16"}
    loaded, _ = load_mp_checkpoint(mpath)
    for path, leaf in flatten_tree(engine.module.param_tree()).items():
        np.testing.assert_array_equal(flatten_tree(loaded)[path], leaf.float().numpy())


def _dims(specs):
    """JAX PartitionSpecs as the dim naming the ``model`` axis (None: replicated)."""
    def dim(spec):
        return None if spec is None else next((i for i, e in enumerate(tuple(spec)) if e == "model"), None)

    return {path: dim(spec) for path, spec in flatten_tree(specs).items()}


def test_partition_rules_match_jax():
    """``TransformerLM.tp_partition_rules`` and the AutoTP walk give the dims
    JAX's PartitionSpecs name, on the model tree and on a tree of other
    families' leaf names (fused qkv, fc1/fc2, biases of both kinds, norms,
    a vocab embedding)."""
    from jax.sharding import PartitionSpec

    from deepspeed_tpu.models import TransformerLM as JaxLM
    from deepspeed_tpu.models.config import TransformerConfig as JaxConfig
    from deepspeed_tpu.module_inject.auto_tp import AutoTP as JaxAutoTP
    from deepspeed_tpu_torch.module_inject.auto_tp import AutoTP

    tree = _tree()
    port_rules = flatten_tree(TransformerLM(TransformerConfig(**CFG)).tp_partition_rules(tree))
    assert port_rules == _dims(JaxLM(JaxConfig(**CFG)).tp_partition_rules(tree))
    other = {"h": {"qkv_proj": np.zeros((4, 12)), "fc1": np.zeros((4, 8)), "fc2": np.zeros((8, 4)),
                   "fc1_bias": np.zeros((8,)), "o_proj": np.zeros((4, 4)), "ln_1": np.zeros((4,)),
                   "out": np.zeros((4,)), "wte": np.zeros((16, 4))},
             "lm_head": np.zeros((4, 16))}
    for t in (tree, other):
        jax_specs = JaxAutoTP().partition_specs(t)
        assert flatten_tree(AutoTP().partition_specs(t)) == _dims(jax_specs)
    assert isinstance(JaxAutoTP().partition_specs(other)["lm_head"], PartitionSpec)
