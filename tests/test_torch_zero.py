"""The port's ZeRO partitioning and ``zero`` namespace against the JAX
package's, without ranks.

* ``shard_over_zero_axes`` gives JAX's ``PartitionSpec`` entries on the
  cases of JAX ``test_partition.py:16-40`` (largest divisible dim, the
  threshold, an indivisible leaf, a tensor-parallel base spec) and on every
  leaf of a GPT-2 and a llama test tree at dp 2, 4 and 8;
  ``ZeroPartitioner`` picks the same specs stage by stage;
* the slice a rank owns (``partition.shard``) equals the
  ``addressable_shards`` entry of the device at the same position of a
  ``data`` mesh of 2 and of 4 devices, for every leaf of the GPT-2 test
  tree at stage 3 (threshold 0) and stage 1;
* ``estimate_zero_memory`` dict-equal to JAX's;
* ``zero.Init`` nesting, ``enabled=False``, ``shutdown_init_context`` and
  ``initialize`` pausing and restoring a live context
  (JAX ``test_zero_context.py``);
* ``TiledLinear`` / ``TiledLinearReturnBias`` outputs within 1e-6 of JAX's
  from the same full weight (normal, std 0.02 as the init draws), ``partition_uniform`` and
  ``split_tensor_along_last_dim`` equal;
* ``GatheredParameters``: a partial tree with ``modifier_rank`` and no
  write-back raises JAX's ``ValueError``; at one rank the full tree's
  edits reach the engine (``set_params``) and survive a step, a
  ``write_back`` callback takes a partial tree, and
  ``get_param_treedef`` has ``get_params()``'s nesting.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import deepspeed_tpu_torch as dst
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.config import MeshConfig as JaxMeshConfig
from deepspeed_tpu.runtime.zero import partition as jax_partition
from deepspeed_tpu.runtime.zero import tiling as jax_tiling
from deepspeed_tpu.runtime.zero.config import DeepSpeedZeroConfig as JaxZeroConfig
from deepspeed_tpu_torch import zero
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree
from deepspeed_tpu_torch.models import TransformerLM
from deepspeed_tpu_torch.models.config import TransformerConfig
from deepspeed_tpu_torch.models.transformer import init_params, param_shapes
from deepspeed_tpu_torch.parallel.mesh import Topology
from deepspeed_tpu_torch.runtime.zero import partition

GPT2 = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2, max_seq_len=128, dtype="float32")
LLAMA = dict(GPT2, num_heads=4, num_kv_heads=2, norm="rmsnorm", position="rope", activation="swiglu",
             use_bias=False, tie_embeddings=False)


def _jax_topo(data=8, model=1):
    devs = jax.devices()[: data * model]
    return build_mesh(JaxMeshConfig(data=data, model=model), devices=devs)


def _spec(jspec, ndim):
    entries = list(jspec) + [None] * (ndim - len(jspec))
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


# --- the rule ----------------------------------------------------------------------------------
RULE_CASES = {  # JAX test_partition.py:16-40
    "largest_divisible": ((16, 64), {}, {}),
    "below_threshold": ((16, 64), {"threshold": 10_000}, {}),
    "indivisible": ((3, 5), {}, {}),
    "tp_axes": ((64, 64), {"base_spec": P(None, "model")}, {"model": 2}),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_shard_over_zero_axes_matches_jax(case):
    shape, kw, mesh = RULE_CASES[case]
    model = mesh.get("model", 1)
    jtopo = _jax_topo(8 // model, model)
    want = jax_partition.shard_over_zero_axes(shape, jtopo, **kw)
    port_kw = dict(kw)
    if "base_spec" in port_kw:
        port_kw["base_spec"] = tuple(port_kw["base_spec"])
    got = partition.shard_over_zero_axes(shape, Topology({"data": 8 // model, "model": model}), **port_kw)
    assert got == _spec(want, len(shape))


@pytest.mark.parametrize("model_kw", [GPT2, LLAMA], ids=["gpt2", "llama"])
@pytest.mark.parametrize("dp", [2, 4, 8])
def test_partitioner_specs_match_jax_per_stage(model_kw, dp):
    shapes = param_shapes(TransformerConfig(**model_kw))
    jtopo = _jax_topo(dp)
    ptopo = Topology({"data": dp})
    tree = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    for stage in (0, 1, 2, 3):
        for threshold in (0, 1000):
            jcfg = JaxZeroConfig(stage=stage, stage3_param_persistence_threshold=threshold)
            pcfg = zero.DeepSpeedZeroConfig(stage=stage, stage3_param_persistence_threshold=threshold)
            jp, pp = jax_partition.ZeroPartitioner(jcfg, jtopo), partition.ZeroPartitioner(pcfg, ptopo)
            for kind in ("param_specs", "master_specs", "grad_accum_specs"):
                want = getattr(jp, kind)(tree)
                got = getattr(pp, kind)(shapes)
                for k, s in shapes.items():
                    assert got[k] == _spec(want[k], len(s)), (stage, threshold, kind, k)


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("stage", [1, 3])
def test_rank_slice_is_jax_addressable_shard(dp, stage):
    """Rank r's slice of every leaf is the shard JAX's ``NamedSharding``
    places on the r-th device of a ``data`` mesh of ``dp`` devices."""
    cfg = TransformerConfig(**GPT2)
    flat = init_params(cfg, 0)
    jtopo = _jax_topo(dp)
    jp = jax_partition.ZeroPartitioner(JaxZeroConfig(stage=stage, stage3_param_persistence_threshold=0), jtopo)
    pp = partition.ZeroPartitioner(zero.DeepSpeedZeroConfig(stage=stage, stage3_param_persistence_threshold=0),
                                   Topology({"data": dp}))
    kind = "param_specs" if stage == 3 else "master_specs"
    jspecs = getattr(jp, kind)(flat)
    dims = pp.dims(getattr(pp, kind)({k: v.shape for k, v in flat.items()}))
    devices = list(jtopo.mesh.devices.reshape(-1))
    sharded = 0
    for k, leaf in flat.items():
        arr = jax.device_put(leaf, NamedSharding(jtopo.mesh, jspecs[k]))
        for sh in arr.addressable_shards:
            rank = devices.index(sh.device)
            got = partition.shard(torch.from_numpy(leaf), dims[k], rank, dp).numpy()
            np.testing.assert_array_equal(got, np.asarray(sh.data), err_msg=f"{k} rank {rank}")
        sharded += dims[k] is not None
    assert sharded >= len(flat) - 2  # every leaf but the tiny final norm pieces is sharded


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_estimate_zero_memory_matches_jax(stage):
    for n, dp, bpp in ((124_439_808, 2, 2), (1_000_003, 8, 4), (7, 3, 2)):
        assert zero.estimate_zero_memory(n, stage, dp, bpp) == jax_partition.estimate_zero_memory(n, stage, dp, bpp)


# --- zero.Init ---------------------------------------------------------------------------------
def test_init_context_nesting_matches_jax():
    from deepspeed_tpu import zero as jax_zero

    for z in (zero, jax_zero):
        assert not z.is_init_context_active()
        with z.Init():
            assert z.is_init_context_active()
            with z.Init():
                assert z.is_init_context_active()
            assert z.is_init_context_active()  # an inner exit keeps the outer context
            with z.Init(enabled=False):
                assert z.is_init_context_active()
        assert not z.is_init_context_active()
        with z.Init(enabled=False):
            assert not z.is_init_context_active()
        with z.Init():
            z.shutdown_init_context()
            assert not z.is_init_context_active()
        assert not z.is_init_context_active()


def _engine(**cfg):
    config = {"train_micro_batch_size_per_gpu": 2, "optimizer": {"type": "adam", "params": {"lr": 1e-2}},
              "zero_optimization": {"stage": 3}, **cfg}
    model_kw = dict(GPT2, max_seq_len=16)
    tree = unflatten_tree(init_params(TransformerConfig(**model_kw), 0))
    engine, *_ = dst.initialize(model=TransformerLM(TransformerConfig(**model_kw)), config=config,
                                model_parameters=tree, device="cpu")
    return engine


def _batch(seed=0, rows=2, T=16):
    toks = np.random.RandomState(seed).randint(0, 256, (rows, T + 1)).astype(np.int32)
    return {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}


def test_initialize_pauses_and_restores_init():
    with zero.Init():
        with zero.Init():
            seen = {}
            real = zero.shutdown_init_context

            def spy():
                depth = real()
                seen["during"] = zero.is_init_context_active()
                return depth

            zero.shutdown_init_context = spy
            try:
                _engine()
            finally:
                zero.shutdown_init_context = real
            assert seen == {"during": False} and zero.is_init_context_active()
        assert zero.is_init_context_active()
    assert not zero.is_init_context_active()


# --- TiledLinear -------------------------------------------------------------------------------
@pytest.mark.parametrize("splits", [(1, 1), (3, 2), (2, 4)], ids=lambda s: f"in{s[0]}_out{s[1]}")
def test_tiled_linear_matches_jax(splits):
    import jax.numpy as jnp

    rs = np.random.RandomState(3)
    w = (rs.standard_normal((48, 40)) * 0.02).astype(np.float32)  # the init's scale
    b = (rs.standard_normal((40,)) * 0.02).astype(np.float32)
    x = rs.standard_normal((2, 5, 48)).astype(np.float32)
    kw = dict(in_splits=splits[0], out_splits=splits[1])
    for cls, jcls in ((zero.TiledLinear, jax_tiling.TiledLinear),
                      (zero.TiledLinearReturnBias, jax_tiling.TiledLinearReturnBias)):
        port, ref = cls(48, 40, **kw), jcls(48, 40, **kw)
        got = port.apply(port.from_full(w, b), torch.from_numpy(x))
        want = ref.apply(ref.from_full(w, b), jnp.asarray(x))
        if isinstance(got, tuple):
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            got, want = got[0], want[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    split = zero.TiledLinear(48, 40, combine_out_splits=False, **kw)
    parts = split.apply(split.from_full(w, b), torch.from_numpy(x))
    assert len(parts) == splits[1] and sum(p.shape[-1] for p in parts) == 40
    assert zero.partition_uniform(40, splits[1]) == jax_tiling.partition_uniform(40, splits[1])
    chunks = zero.split_tensor_along_last_dim(torch.from_numpy(x), 4)
    for c, jc in zip(chunks, jax_tiling.split_tensor_along_last_dim(jnp.asarray(x), 4)):
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


# --- GatheredParameters ------------------------------------------------------------------------
def test_gathered_parameters_partial_tree_raises_like_jax():
    from deepspeed_tpu import zero as jax_zero

    engine = _engine()
    partial = {"lm_head": np.zeros((64, 256), np.float32)}
    messages = []
    for z in (zero, jax_zero):
        with pytest.raises(ValueError, match="partial tree") as err:
            z.GatheredParameters(partial, modifier_rank=0, engine=engine if z is zero else None)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    with pytest.raises(ValueError, match="needs params or engine"):
        zero.GatheredParameters()


def test_gathered_parameters_edits_survive_a_step_at_one_rank():
    engine = _engine()
    assert engine.get_param_treedef() == jax.tree_util.tree_map(lambda _: None, engine.get_params())
    with zero.GatheredParameters(engine=engine, modifier_rank=0) as params:
        params["embed"]["pos"][:] = 0.5
    assert np.all(flatten_tree(engine.get_params())["embed/pos"] == 0.5)
    loss = engine(_batch())
    engine.backward(loss)
    engine.step()
    pos = flatten_tree(engine.get_master_params())["embed/pos"]
    assert np.abs(pos - 0.5).max() <= 1.1e-2  # one Adam step of lr 1e-2 from the edit
    got = {}
    with zero.GatheredParameters({"w": np.ones(3)}, modifier_rank=0, write_back=got.update) as part:
        part["w"][:] = 2.0
    np.testing.assert_array_equal(got["w"], np.full(3, 2.0))
    with zero.GatheredParameters(engine=engine) as view:  # no modifier: read-only, nothing written back
        view["embed"]["pos"][:] = -1.0
    assert np.abs(flatten_tree(engine.get_params())["embed/pos"] - 0.5).max() <= 1.1e-2
