"""Expert parallelism (the expert axis and its groups, the dispatch and
combine all-to-alls and their int8 wire, MoE training across ranks,
expert-sharded checkpoints, expert-parallel forward, ``generate`` and
``serve``) on gloo ranks, against the JAX package on meshes of the CPU
devices.

One two-rank group and one four-rank group (``torch_rank_group.py``) run
every scenario of ``torch_ep_scenarios.py`` while the parent builds the
JAX references at the sizes JAX's own tests use, flash attention off, all
in fp32:

* the exchanges (``exchange_shard`` in both directions, fp and the int8
  wire) and their gradients against JAX's ``shard_map`` over a two-device
  ``expert`` mesh: 1e-5 (the int8 codes and scales are JAX's ops);
* the layer's fast path at k = 1 and k = 2 (capacity binding), with the
  int8 wire and with JAX's per-shard gate noise (each rank's Gumbel draws
  from the key JAX folds with its shard index): output, ``l_aux``,
  ``exp_counts`` and every gradient against
  JAX's ``MoE.apply`` on an ``expert=2`` mesh (1e-5); drops shard-local
  under skewed logits, bitwise repeatable and equal to JAX's;
* the engine: 3 steps at ``expert=2`` (stages 1 and 3), at ``data=2``
  (JAX's global gating) and at ``data=2 × expert=2`` (four ranks: the
  expert leaves reduce over the expert-data group), top-1 without RTS (no
  gate noise, as in ``test_torch_moe.py``), clip 0.1: losses and grad
  norms within 1e-5 relative and the gathered master within 1e-5 of one
  JAX engine's per mesh; the int8 wire's run within 1e-3 of the fp run and
  not equal to it; optimizer offload at ``expert=2`` (streamed bitwise the
  on-device run, the host Adam within 1e-5 of JAX);
* an ep = 2 checkpoint resumed bitwise (also after a ``train.mid_step``
  kill), its 16-bit export and ``zero_to_fp32`` whole; the JAX engine's ep
  = 2 tag read by the port ranks and the port's tag by the JAX engine,
  each continuing within 1e-5 of the other package;
* the inference engine under ``groups.initialize(ep_size=2)``: each rank
  keeps its experts; ``forward`` logits (the fast path, and a batch where
  JAX gates globally) within 1e-5 of JAX's engine on the ``expert=2``
  mesh; greedy ``generate`` and ragged ``serve`` streams equal to JAX's,
  the host fingerprints equal on both ranks; the tensor-parallel forward
  runs the MoE block replicated, and tensor-parallel MoE ``generate`` keeps
  JAX's refusal;
* ``groups`` (JAX ``test_groups.py``'s cases at a world of two ranks) and
  ``mappings`` (JAX ``test_mappings.py``'s cases over a ``model`` group of
  two ranks); ``tp_partition_rules`` leaf by leaf against JAX's.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
import torch_ep_scenarios as sc
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree
from deepspeed_tpu_torch.models import moe_transformer as pmt
from torch_rank_group import join_ranks, start_ranks

E, C, H = sc.EXCHANGE


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol,
                               err_msg=msg)


def _jax_flat(tree):
    import jax

    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


# --- the JAX references ----------------------------------------------------------------------
def _jax_topo(**axes):
    import jax
    from deepspeed_tpu.parallel import mesh as mesh_mod
    from deepspeed_tpu.runtime.config import MeshConfig

    n = int(np.prod(list(axes.values())))
    return mesh_mod.initialize_topology(MeshConfig(**axes), devices=jax.devices()[:n])


def _jax_engine(mesh):
    """JAX's engine on a mesh of CPU devices, its state made from the first
    batch with the rng key and the loss-scale state placed replicated, so
    its step compiles once."""
    import deepspeed_tpu as ds
    import jax
    from deepspeed_tpu.models import moe_transformer as jmt
    from jax.sharding import NamedSharding, PartitionSpec

    topo = _jax_topo(**mesh)
    dp = int(np.prod(list(mesh.values())))
    cfg = dict(sc.TRAIN, train_micro_batch_size_per_gpu=sc.MICRO, mesh=dict(mesh), zero_optimization={"stage": 1})
    engine, *_ = ds.initialize(model=jmt.MoETransformerLM(jmt.moe_llama_config("tiny", **sc.TINY)), config=cfg,
                               model_parameters=sc.tree())
    replicated = NamedSharding(topo.mesh, PartitionSpec())
    first = {k: v for k, v in sc.batches(1, sc.MICRO * dp)[0].items()}
    engine.init_params(first, rng=jax.device_put(jax.random.PRNGKey(42), replicated))
    engine._scale_state = jax.device_put(engine._scale_state, replicated)
    return engine


def _jax_train(engine, bs):
    return [(float(engine.train_batch(batch=b)), engine.get_global_grad_norm()) for b in bs]


def _jax_exchange():
    """``exchange_shard`` both ways under ``shard_map`` on a two-device
    expert mesh: outputs and the gradients of ``Σ out · upstream``."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.moe import a2a as ja2a
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:2]), ("expert",))
    x, y, gx, gy = sc.exchange_inputs(2)
    out = {}
    for quantized in (False, True):
        def both(a, b, q=quantized):
            d = shard_map(lambda t: ja2a.exchange_shard(t, quantized=q), mesh=mesh, in_specs=P("expert"),
                          out_specs=P("expert"), check_rep=False)(a)
            c = shard_map(lambda t: ja2a.exchange_shard(t, inverse=True, quantized=q), mesh=mesh,
                          in_specs=P("expert"), out_specs=P("expert"), check_rep=False)(b)
            return d, c

        xs, ys = jnp.asarray(x.reshape(2 * E, C, H)), jnp.asarray(y.reshape(2 * (E // 2), 2 * C, H))
        d, c = jax.jit(both)(xs, ys)
        g = jax.jit(jax.grad(lambda a, b: jnp.sum(both(a, b)[0] * gx.reshape(d.shape))
                             + jnp.sum(both(a, b)[1] * gy.reshape(c.shape)), argnums=(0, 1)))(xs, ys)
        out["int8" if quantized else "fp"] = dict(dispatch=np.asarray(d).reshape(2, E // 2, 2 * C, H),
                                                  combine=np.asarray(c).reshape(2, E, C, H),
                                                  grad_x=np.asarray(g[0]).reshape(x.shape),
                                                  grad_y=np.asarray(g[1]).reshape(y.shape))
    return out


NOISE_KEY = 7


def _jax_layer_noise():
    """The draws JAX's fast path makes in each token shard for the noisy
    case (``a2a.py:187-191``: the layer key folded with the shard index,
    then ``top2gating``'s split and Gumbel sample), one dict a rank."""
    import jax
    import jax.numpy as jnp

    out = []
    for i in range(2):
        _, sub = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(NOISE_KEY), i))
        gumbel = jax.random.gumbel(sub, (sc.LAYER_S // 2, sc.LAYER["num_experts"]), dtype=jnp.float32)
        out.append({"gumbel": np.asarray(gumbel)})
    return out


def _jax_layers():
    """JAX's ``MoE.apply`` (training) on the ``expert=2`` mesh, without an
    rng and, for ``k2_noise``, with one: output, l_aux, counts and the
    gradients of ``Σ out · upstream + l_aux``."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.moe import layer as jlayer

    _jax_topo(expert=2)
    x, upstream = sc.layer_inputs()
    out = {}
    for name, k, quantized, rng in (("k1", 1, False, None), ("k2", 2, False, None), ("k1_int8", 1, True, None),
                                    ("k2_noise", 2, False, jax.random.PRNGKey(NOISE_KEY))):
        layer = jlayer.MoE(**sc.LAYER, k=k, quantized_a2a=quantized)
        params = jax.tree_util.tree_map(jnp.asarray, sc.layer_tree(k))

        def f(p, h, layer=layer, rng=rng):
            y, l_aux, counts = layer.apply(p, h, train=True, rng=rng)
            return jnp.sum(y * upstream) + l_aux, (y, l_aux, counts)

        (_, (y, l_aux, counts)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            params, jnp.asarray(x))
        out[name] = dict(out=np.asarray(y), l_aux=float(l_aux), counts=np.asarray(counts), grad_x=np.asarray(gx),
                         grads=_jax_flat(gp))
    return out


def _jax_drops():
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.moe import a2a as ja2a

    topo = _jax_topo(expert=2)
    tokens, logits = sc.skewed()
    s = tokens.shape[0] // 2
    moved = logits.copy()
    moved[:s, 1] += 6.0
    gate = jax.jit(lambda tok, lg: ja2a.ep_gate_dispatch(tok, lg, topo, k=1, capacity_factor=1.0, min_capacity=1,
                                                         drop_tokens=True, use_rts=True, rng=None))
    out = {}
    for name, lg in (("base", logits), ("moved", moved)):
        d, cw, _aux, counts = gate(jnp.asarray(tokens), jnp.asarray(lg))
        out[name] = dict(dispatched=np.asarray(d), combine=np.asarray(cw), counts=np.asarray(counts))
    return out


def _jax_inference():
    import deepspeed_tpu as ds
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models import moe_transformer as jmt

    _jax_topo(expert=2)
    toks, odd, prompts, budgets = sc.infer_inputs()
    jcfg = jmt.moe_llama_config("tiny", **sc.TINY)
    engine = ds.init_inference(jmt.MoETransformerLM(jcfg), dtype="fp32", paged_kv=dict(sc.SERVE, attn_impl="xla"))
    engine.set_params(jax.tree_util.tree_map(jnp.asarray, sc.tree()))
    engine._ds_config = jcfg  # the JAX converted-family contract for the KV-cached generate and serve()
    return dict(logits=np.asarray(engine(jnp.asarray(toks))), logits_odd=np.asarray(engine(jnp.asarray(odd))),
                generate=np.asarray(engine.generate(jnp.asarray(toks[:, :8]), max_new_tokens=6)),
                serve=[np.asarray(o).tolist() for o in engine.serve(prompts, max_new_tokens=budgets)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from deepspeed_tpu.parallel import mesh as mesh_mod
    from torch_ckpt_convert import jax_tag_to_port, port_tag_to_jax

    tmp = str(tmp_path_factory.mktemp("moe_ep"))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        h2 = start_ranks(sc.rank_ep2, 2, os.path.join(tmp, "ranks2"), tmp, _jax_layer_noise())
        h4 = start_ranks(sc.rank_ep4, 4, os.path.join(tmp, "ranks4"), tmp)
        out = {}
        # JAX's ep = 2 engine: its tag after CKPT_AT steps goes to the ranks, then its last step
        bs = sc.batches(sc.STEPS, sc.MICRO * 2)
        je = _jax_engine({"expert": 2})
        jrec = _jax_train(je, bs[:sc.CKPT_AT])
        je.save_checkpoint(os.path.join(tmp, "jax_native"), tag="jax")
        out["jax_saved"] = _jax_flat(je.get_master_params())
        jax_tag_to_port(os.path.join(tmp, "jax_native"), "jax", os.path.join(tmp, "jax_ep2"))
        open(os.path.join(tmp, "jax_ep2", "READY"), "w").close()
        jrec += _jax_train(je, bs[sc.CKPT_AT:])
        out["expert"] = (jrec, _jax_flat(je.get_master_params()))
        jd = _jax_engine({"data": 2})
        out["data"] = (_jax_train(jd, bs), _jax_flat(jd.get_master_params()))
        del jd
        out["exchange"] = _jax_exchange()
        out["layer"] = _jax_layers()
        out["drops"] = _jax_drops()
        out["inference"] = _jax_inference()
        j4 = _jax_engine({"data": 2, "expert": 2})
        out["ep4"] = (_jax_train(j4, sc.batches(sc.STEPS, sc.MICRO * 4)), _jax_flat(j4.get_master_params()))
        del j4
        out["ranks"] = join_ranks(h2, limit_s=400.0)
        out["ranks4"] = join_ranks(h4, limit_s=200.0)
        # the JAX engine resumes the ranks' ep = 2 tag and takes the step they took after saving it
        mesh_mod.set_topology(je.topology)
        port_tag_to_jax(os.path.join(tmp, "ep2"), "ep2", os.path.join(tmp, "p2j"),
                        mesh=dict(zip(je.mesh.axis_names, map(int, je.mesh.devices.shape))))
        je.load_checkpoint(os.path.join(tmp, "p2j"), tag="ep2")
        out["jax_from_port"] = dict(master=_jax_flat(je.get_master_params()), rec=_jax_train(je, bs[sc.CKPT_AT:]))
    finally:
        torch.set_num_threads(prev)
    return out


def _joined(ranks, key, name, field):
    return np.concatenate([r[key][name][field] for r in ranks])


# --- groups and mappings ------------------------------------------------------------------------
def test_groups_carve_the_expert_axis_out_of_data(runs):
    """JAX ``test_groups.py`` at a world of two: ``initialize(ep_size=2)``
    carves the expert axis out of ``data`` (dense DP stays the world), is
    idempotent, refuses a resize and an indivisible size; the accessors'
    sizes, the comm duck type, a mesh-less ``initialize`` adopting the
    topology and an explicit mesh winning."""
    for rank, res in enumerate(runs["ranks"]):
        g = res["groups"]
        assert "does not divide" in g["indivisible"] and "already sized" in g["resize"]
        assert g["sizes"] == (2, 2, 1, 1, 1, 2)
        assert g["world_sizes"] == (2, 2, 1, 1, 1)
        assert g["name"] == "ep_size_2" and g["established"]
        assert g["ranks"] == ([0, 1], 2, [0, 1])
        assert (g["comm_size"], g["comm_rank"]) == (2, rank)
        assert g["rank"] == (rank, rank, 0)
        assert g["topo"]["expert"] == 2 and g["topo"]["data"] == 1
        assert g["adopted"] == (2, 1, 1, 2)


def test_mappings_drop_and_gather_over_the_model_group(runs):
    """JAX ``test_mappings.py``: drop keeps the rank's chunk and gather
    restores the whole; an indivisible drop raises; the gradients of
    ``Σ gather(drop(x))²`` are ``2x``; the identity without a model axis."""
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    for rank, res in enumerate(runs["ranks"]):
        m = res["mappings"]
        assert m["identity"] and m["aliases"]
        np.testing.assert_array_equal(m["dropped"], x[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(m["dim1"], x[:, 3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(m["gathered"], x)
        np.testing.assert_allclose(m["grad"][2 * rank:2 * rank + 2], 2 * x[2 * rank:2 * rank + 2], rtol=1e-6)
        assert "not divisible" in m["indivisible"]


# --- the exchange and the layer -------------------------------------------------------------------
@pytest.mark.parametrize("wire", ["fp", "int8"])
def test_exchange_and_its_gradient_match_jax_shard_map(runs, wire):
    ref = runs["exchange"][wire]
    for rank, res in enumerate(runs["ranks"]):
        got = res["exchange"][wire]
        for field in ("dispatch", "combine", "grad_x", "grad_y"):
            _close(got[field], ref[field][rank], 1e-5, f"{wire} {field} rank {rank}")
    if wire == "int8":  # the wire is lossy: the int8 exchange is not the fp one
        fp = runs["exchange"]["fp"]
        assert not np.array_equal(ref["dispatch"], fp["dispatch"])
        assert np.abs(ref["dispatch"] - fp["dispatch"]).max() <= 0.02 * np.abs(fp["dispatch"]).max()


@pytest.mark.parametrize("name", ["k1", "k2", "k1_int8", "k2_noise"])
def test_layer_fast_path_matches_jax(runs, name):
    """Per-shard gating at the local capacity (tokens dropped), the two
    all-to-alls, the rank's experts: the output rows, the mean of the
    shards' ``l_aux``, the summed counts and every gradient (the ranks'
    parameter gradients summed) within 1e-5 of JAX's fast path; in
    ``k2_noise`` each rank takes JAX's own draws of its shard (the key
    folded with the shard index)."""
    ref = runs["layer"][name]
    ranks = runs["ranks"]
    _close(_joined(ranks, "layer", name, "out"), ref["out"], 1e-5, "out")
    _close(_joined(ranks, "layer", name, "grad_x"), ref["grad_x"], 1e-5, "grad_x")
    for res in ranks:
        _close(res["layer"][name]["l_aux"], ref["l_aux"], 1e-5, "l_aux")
        np.testing.assert_array_equal(res["layer"][name]["counts"], ref["counts"])
    for path, g in ref["grads"].items():
        _close(sum(r["layer"][name]["grads"][path] for r in ranks), g, 1e-5, path)
    k = 2 if name.startswith("k2") else 1
    assert int(ref["counts"].sum()) == sc.LAYER_S * k  # routed before the capacity...
    assert np.sum(np.any(ref["out"] != 0, axis=1)) < sc.LAYER_S or name != "k1"  # ...which dropped tokens
    if name == "k1_int8":
        fp = runs["layer"]["k1"]["out"]
        gap = np.abs(ref["out"] - fp).max()
        assert 0.0 < gap < 0.05 * np.abs(fp).max()


def test_drops_are_shard_local_and_match_jax(runs):
    """Skewed logits (JAX ``test_moe_fast_path.py``): each rank's combine
    weights and dispatched buffer equal JAX's, bitwise repeatable; pushing
    shard 0's tokens moves shard 0's routing and leaves shard 1's bit for
    bit."""
    ranks = runs["ranks"]
    for name in ("base", "moved"):
        ref = runs["drops"][name]
        for rank, res in enumerate(ranks):
            got = res["drops"][name]
            assert got["bitwise"]
            s = got["combine"].shape[0]
            _close(got["combine"], ref["combine"][rank * s:(rank + 1) * s], 1e-6, f"{name} combine")
            np.testing.assert_array_equal(got["dispatched"], ref["dispatched"][rank * (E // 2):(rank + 1) * (E // 2)])
            np.testing.assert_array_equal(got["counts"], ref["counts"][rank])
    kept = sum(int((r["drops"]["base"]["combine"].sum(axis=(1, 2)) > 0).sum()) for r in ranks)
    assert kept < 64  # the capacity bound
    assert not np.array_equal(ranks[0]["drops"]["base"]["combine"], ranks[0]["drops"]["moved"]["combine"])
    np.testing.assert_array_equal(ranks[1]["drops"]["base"]["combine"], ranks[1]["drops"]["moved"]["combine"])


# --- the engine -------------------------------------------------------------------------------
def _check_run(rec, master, ref, label):
    ref_rec, ref_master = ref
    rec, want = np.asarray(rec, np.float64), np.asarray(ref_rec, np.float64)
    np.testing.assert_allclose(rec[:, 0], want[:, 0], rtol=1e-5, err_msg=f"{label} losses")
    np.testing.assert_allclose(rec[:, 1], want[:, 1], rtol=1e-5, err_msg=f"{label} grad norms")
    assert set(master) == set(ref_master)
    for k, v in master.items():
        assert np.abs(v - ref_master[k]).max() <= 1e-5, (label, k)


@pytest.mark.parametrize("key", ["expert_1", "expert_3", "data_1"])
def test_engine_steps_match_jax(runs, key):
    """3 steps on two ranks at ``expert=2`` (the fast path; the expert
    leaves hold 2 of 4 experts and no ZeRO slice, the dense leaves sharded
    at stage 3) and at ``data=2`` (the global gate over the all-gathered
    logits) against JAX's engine on the same mesh."""
    ref = runs["expert"] if key.startswith("expert") else runs["data"]
    assert all(n > 0.1 for _, n in ref[0])  # clipping engaged
    for rank, res in enumerate(runs["ranks"]):
        run = res["engines"][key]
        _check_run(run["rec"], run["master"], ref, f"{key} rank {rank}")
        shapes = run["shapes"]
        expert = "layers/moe/experts/w_up"
        assert shapes[expert][1] == (2 if key.startswith("expert") else 4)
        assert (shapes["layers/wq"] != ref[1]["layers/wq"].shape) == (key == "expert_3")


def test_engine_optimizer_offload_under_the_expert_axis(runs):
    """ZeRO optimizer offload at ``expert=2``, each rank's expert slices on
    the host: the streamed path at stage 1 bitwise the on-device stage-1
    run; the host Adam at stage 2 within 1e-5 of JAX's engine."""
    for rank, res in enumerate(runs["ranks"]):
        streamed, on_device = res["engines"]["expert_streamed"], res["engines"]["expert_1"]
        assert streamed["offload"] == "HostOffloadStreamer" and streamed["rec"] == on_device["rec"]
        for k, v in streamed["master"].items():
            np.testing.assert_array_equal(v, on_device["master"][k], err_msg=k)
        host = res["engines"]["expert_host_adam"]
        assert host["offload"] == "HostOffloadAdam"
        _check_run(host["rec"], host["master"], runs["expert"], f"host adam rank {rank}")


def test_engine_int8_wire_stays_close_to_fp(runs):
    """``moe_quantized_a2a`` rides the a2a stage into the layers: the run
    is within 1e-3 of the fp wire's and not equal to it."""
    for res in runs["ranks"]:
        q, fp = res["engines"]["expert_int8"], res["engines"]["expert_1"]
        assert q["plan"] == (None, True) and fp["plan"] == (None, False)
        rq, rf = np.asarray(q["rec"]), np.asarray(fp["rec"])
        np.testing.assert_allclose(rq, rf, rtol=1e-3)
        assert not np.array_equal(rq, rf)


def test_resize_arms_no_window_for_moe_across_ranks(runs):
    """An MoE engine at ``expert=2`` refuses ``compile.multi_step`` at
    construction (a multi-process run); resized to gas 1 with the switch
    on, it arms no window, and ``train_batch(data_iter=)`` takes the
    sequential engine's steps exactly."""
    for res in runs["ranks"]:
        r = res["resize"]
        assert "single-process run" in r["refused"]
        assert r["windows"] == (False, 0)
        assert r["resized"] == r["sequential"]


def test_engine_data2_expert2_matches_jax(runs):
    """Four ranks, ``data=2 × expert=2``: rank r at (data r // 2, expert
    r % 2), the expert groups {0, 1} and {2, 3}, the expert-data groups {0,
    2} and {1, 3}; 3 steps within 1e-5 of JAX's four-device engine."""
    for rank, res in enumerate(runs["ranks4"]):
        assert res["coords"]["data"] == rank // 2 and res["coords"]["expert"] == rank % 2
        assert res["groups"] == ([rank - rank % 2, rank - rank % 2 + 1], [rank % 2, rank % 2 + 2])
        _check_run(res["rec"], res["master"], runs["ep4"], f"data2 x expert2 rank {rank}")


# --- checkpoints ------------------------------------------------------------------------------
def test_ep2_checkpoint_resumes_bitwise(runs):
    """The ep = 2 tag holds the whole gathered master; a fresh ep = 2 engine
    loads it bitwise and takes the original's next step bit for bit, also
    after a ``train.mid_step`` kill; the 16-bit export and ``zero_to_fp32``
    give the whole expert leaves."""
    shapes = {k: v.shape for k, v in runs["expert"][1].items()}
    for res in runs["ranks"]:
        ck = res["ckpt"]
        for k, v in ck["saved"].items():
            assert v.shape == shapes[k]
            np.testing.assert_array_equal(ck["loaded"][k], v, err_msg=k)
            np.testing.assert_array_equal(ck["zero_to_fp32"][k], v, err_msg=k)
        assert ck["resumed"] == ck["continue"] and ck["after_kill"] == ck["continue"] and ck["killed"]
        assert ck["steps"] == (sc.STEPS, sc.STEPS * sc.MICRO * 2)
        assert ck["16bit_shapes"] == shapes


def test_ep2_checkpoint_is_read_by_both_packages(runs):
    """JAX's ep = 2 tag, loaded by the port ranks, holds JAX's master bitwise
    and its next step is JAX's within 1e-5; the port's tag, loaded by the
    JAX engine at ep = 2, holds the ranks' master and JAX's next step is
    the ranks' within 1e-5."""
    jrec = runs["expert"][0]
    for res in runs["ranks"]:
        got = res["ckpt"]["from_jax"]
        for k, v in runs["jax_saved"].items():
            np.testing.assert_array_equal(got["master"][k], v, err_msg=k)
        np.testing.assert_allclose(np.asarray(got["rec"]), np.asarray(jrec[sc.CKPT_AT:]), rtol=1e-5)
    ck = runs["ranks"][0]["ckpt"]
    for k, v in ck["saved"].items():
        np.testing.assert_array_equal(runs["jax_from_port"]["master"][k], v, err_msg=k)
    np.testing.assert_allclose(np.asarray(runs["jax_from_port"]["rec"]), np.asarray(ck["continue"]), rtol=1e-5)


# --- inference --------------------------------------------------------------------------------
def test_expert_parallel_inference_matches_jax(runs):
    """Each rank keeps its 2 of the 4 experts and gathers the whole tree
    back; ``forward`` on the fast path and on a batch JAX gates globally,
    greedy ``generate`` and ragged ``serve`` against JAX's engine on the
    ``expert=2`` mesh; every rank emits the same streams and host
    fingerprints."""
    ref = runs["inference"]
    full = flatten_tree(sc.tree())
    prints = set()
    for res in runs["ranks"]:
        inf = res["inference"]
        assert inf["local_shapes"]["layers/moe/experts/w_up"][1] == 2
        for k, v in inf["full"].items():
            np.testing.assert_array_equal(v, full[k], err_msg=k)
        _close(inf["logits"], ref["logits"], 1e-5, "fast-path logits")
        _close(inf["logits_odd"], ref["logits_odd"], 1e-5, "global-gate logits")
        np.testing.assert_array_equal(inf["generate"], ref["generate"])
        assert inf["serve"] == ref["serve"]
        assert inf["stats"]["ep_degree"] == 2 and inf["stats"]["tp_degree"] == 1 and inf["stats"]["finished"] == 4
        prints.add(inf["stats"]["step_fingerprint"])
    assert len(prints) == 1


def test_tensor_parallel_forward_runs_moe_replicated(runs):
    """At tp = 2 each rank holds half of every attention projection and the
    whole expert stack; the forward's logits are JAX's within 1e-5 (a batch
    JAX gates globally); ``generate`` and ``serve`` refuse with JAX's words
    (``decode.py:115-125``, ``scheduler.py:269-273``)."""
    refusal = ("tensor-parallel MoE serving is not supported: expert placement is the 'expert' mesh axis, not a "
               "TP weight split")
    for res in runs["ranks"]:
        tp = res["tp"]
        _close(tp["logits_odd"], runs["inference"]["logits_odd"], 1e-5, "tp logits")
        assert tp["local_wq"][2] == sc.TINY["hidden_size"] // 2 and tp["local_experts"][1] == sc.TINY["num_experts"]
        assert tp["generate"] == refusal and tp["serve"] == refusal


def test_tp_partition_rules_match_jax():
    """``MoETransformerLM.tp_partition_rules`` against JAX's, leaf by leaf:
    the dim a leaf splits over ``model`` (the dense leaves Megatron's, every
    MoE leaf none: JAX puts the experts on ``expert``), top-level and
    interleaved."""
    from deepspeed_tpu.models import moe_transformer as jmt

    for kw in ({}, {"moe_layer_freq": 2, "use_residual": True}):
        shapes = sc.tree(**kw)
        want = flatten_tree(jmt.MoETransformerLM(jmt.moe_llama_config("tiny", **dict(sc.TINY, **kw)))
                            .tp_partition_rules(shapes))
        got = flatten_tree(pmt.MoETransformerLM(sc.model_cfg(**kw)).tp_partition_rules(shapes))
        assert set(got) == set(want)
        for path, spec in want.items():
            entries = list(spec)
            model_dim = next((i for i, e in enumerate(entries) if e == "model"), None)
            assert got[path] == model_dim, (path, spec, got[path])
            if "/experts/" in path:
                assert entries[1] == "expert", (path, spec)
