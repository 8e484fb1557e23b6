"""Tensor-parallel ragged serving (ROADMAP S9) against the JAX package's
``TPServing``, on the CPU: the core scenarios.

The port runs one process a rank over ``torch.distributed``: the module
starts one gloo rank group at tp = 2 and one at tp = 4
(``torch_rank_group.py``), every rank runs every scenario on its shard,
and the parent holds the results against JAX's TP servers and the port's
single-rank server (``torch_tp_scenarios.py``; JAX's tiny TP config, fp32):

* greedy streams byte-identical to JAX's TP streams and to the port's
  tp = 1 streams on every rank, in mixed serving with admission between
  two waves, GQA with the kv-head shard (8 heads over 4 kv heads, so both
  degrees divide), recompute preemption and a prefix-cache attach;
  ``serve_stats()`` counters equal to JAX's;
* every rank's step fingerprint equal;
* the quantized all-reduce: its comm-free arithmetic
  (``quantized_all_reduce_local``) within 1e-6 of JAX's on the same
  per-rank inputs, the gloo path equal to it and within JAX's bound
  ``2 * scale * 2 / 127`` of the exact sum (``test_tp_serving.py:356``),
  the plain sum when the last dim does not split, and a
  quantized-all-reduce serve that finishes;
* the refusals ("ragged", "divide", the config's "ragged", int8 bits),
  tenancy and the fleet building over a tp server, and FOLLOW-mode routing
  (``test_tp_serving.py:225-280``), and the engine's
  ``paged_kv.sharded.tp_degree`` knob.

Speculation, windows and int8 weights are in
``test_torch_tp_spec_windows_int8.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.inference.tp import TPServing, quantized_all_reduce, quantized_all_reduce_local
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from torch_tp_scenarios import (
    CFG,
    DEGREES,
    SCENARIOS,
    SERVER,
    check_fingerprints,
    check_streams,
    collect,
    port_params,
    port_run,
    prompts,
    tree,
)

NAMES = ("mixed", "gqa", "preempt", "prefix")


# --- rank-side work ---------------------------------------------------------------------
def _qar_partials(world):
    return np.random.RandomState(0).randn(world, 3, 5, 16).astype(np.float32)


def _qar_gloo(rank, world):
    from deepspeed_tpu_torch import comm

    x = torch.from_numpy(_qar_partials(world)[rank])
    odd = torch.from_numpy(np.random.RandomState(1).randn(world, 3, 7).astype(np.float32)[rank])
    return dict(got=quantized_all_reduce(x.clone()).numpy(), exact=comm.all_reduce(x.clone()).numpy(),
                odd=quantized_all_reduce(odd.clone()).numpy(), odd_exact=comm.all_reduce(odd.clone()).numpy())


def _comm_surface(rank, world):
    """The comm layer's collectives on CPU tensors, each result as the
    collective defines it."""
    from deepspeed_tpu_torch import comm

    out = dict(rank=comm.get_rank(), world=comm.get_world_size(), initialized=comm.is_initialized())
    x = torch.full((2, 3), float(rank + 1))
    out["sum"] = comm.all_reduce(x.clone()).numpy()
    out["max"] = comm.all_reduce(x.clone(), op=comm.ReduceOp.MAX).numpy()
    out["avg"] = comm.all_reduce(x.clone(), op=comm.ReduceOp.AVG).numpy()
    work = comm.all_reduce(y := x.clone(), async_op=True)
    work.wait()
    out["async_sum"] = y.numpy()
    out["gather"] = torch.stack(comm.all_gather(None, x)).numpy()
    out["gather_into"] = comm.all_gather_into_tensor(torch.empty(2 * world, 3), x).numpy()
    out["broadcast"] = comm.broadcast(x.clone(), src=world - 1).numpy()
    a = torch.arange(2 * world, dtype=torch.int32) + 100 * rank
    out["all_to_all"] = comm.all_to_all_single(torch.empty_like(a), a).numpy()
    objs = [{"from": rank}] if rank == 0 else [None]
    comm.broadcast_object_list(objs, src=0)
    out["object"] = objs[0]
    out["objects"] = comm.all_gather_object(("rank", rank))
    pair = comm.new_group([0, 1])
    out["pair_sum"] = comm.all_reduce(x.clone(), group=pair).numpy() if rank < 2 else None
    comm.barrier()
    return out


def _refusals(world):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.fleet import FleetRouter, ReplicaHandle
    from deepspeed_tpu_torch.inference.traffic import MultiTenantServer

    seen = {}
    cfg, params = port_params("mha")

    def server(c=cfg, **kw):
        return PagedServer(c, params, attn_impl="plain", device="cpu", tp=TPServing(degree=world),
                           **{**SERVER, **kw})

    def refused(key, exc, match, fn):
        with pytest.raises(exc, match=match):
            fn()
        seen[key] = True

    refused("ragged", ValueError, "ragged", lambda: server(ragged=False))
    refused("divide", ValueError, "divide",
            lambda: server(TransformerConfig(**{**CFG, "num_heads": 6, "num_kv_heads": 3})))
    refused("config_ragged", Exception, "ragged",
            lambda: DeepSpeedInferenceConfig(paged_kv={"ragged": False, "sharded": {"tp_degree": 2}}))
    refused("weight_quant_bits", Exception, "weight_quant_bits",
            lambda: DeepSpeedInferenceConfig(paged_kv={"sharded": {"weight_quant_bits": 4}}))
    # tenancy and the fleet build over a tp server (the serving itself: test_torch_tp_tenancy.py)
    seen["tenancy"] = MultiTenantServer(server(), tenants=[]).server.tp.degree == world
    seen["fleet"] = FleetRouter([ReplicaHandle(name="r0", server=server())]).replicas["r0"].inner.tp.degree == world
    # FOLLOW mode (sharded.tp_degree=0 defers to tensor_parallel.tp_size) with the bucketed oracle stays
    # valid: tp_size drives the dense path, and the bucketed server stays single-rank
    engine = dst.init_inference(TransformerLM(cfg), dtype="fp32", device="cpu", tensor_parallel={"tp_size": world},
                                paged_kv={**SERVER, "ragged": False, "attn_impl": "plain"})
    engine.set_params(tree("mha"))
    seen["follow_tp"] = engine._build_paged_server().tp
    seen["follow_degree"] = engine._config.paged_kv.sharded.tp_degree
    return seen


def _engine_route(world):
    import deepspeed_tpu_torch as dst

    engine = dst.init_inference(TransformerLM(TransformerConfig(**CFG)), dtype="fp32", device="cpu",
                                paged_kv={**SERVER, "attn_impl": "plain", "sharded": {"tp_degree": world}})
    engine.set_params(tree("mha"))
    outs = engine.serve(prompts(2, seed=8), max_new_tokens=4)
    st = engine.serve_stats()
    return dict(outs=[o.tolist() for o in outs], tp_degree=st["tp_degree"], finished=st["finished"])


def _rank_main(rank, world, tmp):  # noqa: ARG001
    out = {name: port_run(name, world) for name in NAMES}
    out["qar_serve"] = port_run("quantized", world, quantized_allreduce=True)
    out["qar_gloo"] = _qar_gloo(rank, world)
    out["comm"] = _comm_surface(rank, world)
    out["refusals"] = _refusals(world)
    out["engine"] = _engine_route(world)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return collect(_rank_main, NAMES, str(tmp_path_factory.mktemp("tp_serving")))


@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("scenario", NAMES)
def test_tp_streams_match_jax_and_single_rank(runs, scenario, degree):
    """Every rank's greedy streams byte-identical to JAX's TP server's and
    to the port's tp = 1 server's; the scheduler counters equal JAX's."""
    got = check_streams(runs, scenario, degree)
    if scenario == "preempt":
        assert got["stats"]["preempted"] >= 1, "the pool was sized to force preemption"
    if scenario == "prefix":
        assert got["prefix_hit_pages"] > 0, "the prefix cache never engaged"


@pytest.mark.parametrize("degree", DEGREES)
def test_tp_step_fingerprints_equal_across_ranks(runs, degree):
    check_fingerprints(runs, degree, NAMES + ("qar_serve",))


@pytest.mark.parametrize("degree", DEGREES)
def test_comm_collectives(runs, degree):
    """``deepspeed_tpu_torch.comm`` over gloo: all-reduce (sum, max, avg,
    async), all-gather (list and into one tensor), broadcast, int32
    all-to-all, the object collectives and a sub-group."""
    total = sum(range(1, degree + 1))
    for rank, res in enumerate(runs["port"][degree]):
        got = res["comm"]
        assert (got["rank"], got["world"], got["initialized"]) == (rank, degree, True)
        np.testing.assert_array_equal(got["sum"], np.full((2, 3), total, np.float32))
        np.testing.assert_array_equal(got["async_sum"], got["sum"])
        np.testing.assert_array_equal(got["max"], np.full((2, 3), degree, np.float32))
        np.testing.assert_allclose(got["avg"], np.full((2, 3), total / degree, np.float32), rtol=1e-6)
        ranks = np.arange(1, degree + 1, dtype=np.float32)[:, None, None] * np.ones((1, 2, 3), np.float32)
        np.testing.assert_array_equal(got["gather"], ranks)
        np.testing.assert_array_equal(got["gather_into"], ranks.reshape(2 * degree, 3))
        np.testing.assert_array_equal(got["broadcast"], np.full((2, 3), degree, np.float32))
        np.testing.assert_array_equal(got["all_to_all"], [2 * rank + i + 100 * src
                                                          for src in range(degree) for i in range(2)])
        assert got["object"] == {"from": 0} and got["objects"] == [("rank", r) for r in range(degree)]
        if rank < 2:
            np.testing.assert_array_equal(got["pair_sum"], np.full((2, 3), 3, np.float32))


@pytest.mark.parametrize("degree", DEGREES)
def test_quantized_all_reduce_arithmetic_matches_jax(degree):
    """The comm-free arithmetic on the same per-rank partials within 1e-6
    of JAX's exchange over a ``degree``-way mesh axis; the plain sum when
    the last dim does not split."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.inference.tp import quantized_all_reduce as jax_qar, serving_mesh
    from deepspeed_tpu.utils.jax_compat import shard_map

    mesh = serving_mesh(degree)

    def run(xs, fn):
        sm = shard_map(lambda x: fn(x[0]), mesh=mesh, in_specs=(P("model"),), out_specs=P(), check_vma=False)
        return np.asarray(sm(jnp.asarray(xs)))

    partials = _qar_partials(degree)
    ref = run(partials, lambda x: jax_qar(x, "model", degree))
    for got in quantized_all_reduce_local([torch.from_numpy(p) for p in partials]):
        assert got.shape == ref.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    odd = np.random.RandomState(1).randn(degree, 3, 7).astype(np.float32)
    got_odd = quantized_all_reduce_local([torch.from_numpy(p) for p in odd])[0].numpy()
    np.testing.assert_allclose(got_odd, run(odd, lambda x: jax.lax.psum(x, "model")), rtol=0, atol=1e-6)


@pytest.mark.parametrize("degree", DEGREES)
def test_quantized_all_reduce_gloo_within_jax_bound(runs, degree):
    """Over gloo every rank gets the arithmetic's result, within JAX's bound
    ``2 * scale * 2 / 127`` of the exact sum; an indivisible last dim takes
    the exact all-reduce."""
    local = quantized_all_reduce_local([torch.from_numpy(p) for p in _qar_partials(degree)])[0].numpy()
    for res in runs["port"][degree]:
        q = res["qar_gloo"]
        np.testing.assert_array_equal(q["got"], local)
        scale = np.max(np.abs(q["exact"]))
        np.testing.assert_allclose(q["got"], q["exact"], rtol=0, atol=2.0 * scale * 2.0 / 127.0)
        np.testing.assert_array_equal(q["odd"], q["odd_exact"])


@pytest.mark.parametrize("degree", DEGREES)
def test_quantized_allreduce_serve_finishes(runs, degree):
    """Serving with the quantized exchange finishes every request with its
    whole budget and reports the knob (allclose, so streams are not held)."""
    (batch, new), = SCENARIOS["quantized"][1]
    for res in runs["port"][degree]:
        got = res["qar_serve"]
        assert got["quantized"] is True and got["stats"]["finished"] == len(batch)
        assert [len(o) for o in got["outs"]] == [p.size + new for p in batch]


@pytest.mark.parametrize("degree", DEGREES)
def test_tp_refusals_and_follow_mode(runs, degree):
    """The "ragged" and "divide" refusals and the config's; tenancy and the
    fleet build over a tp server; FOLLOW mode with the bucketed oracle
    builds a single-rank server."""
    for res in runs["port"][degree]:
        seen = res["refusals"]
        assert all(seen[k] for k in ("ragged", "divide", "config_ragged", "weight_quant_bits", "tenancy", "fleet"))
        assert seen["follow_tp"] is None and seen["follow_degree"] == 0


@pytest.mark.parametrize("degree", DEGREES)
def test_tp_engine_knob_routing(runs, degree):
    """``paged_kv.sharded.tp_degree`` routes through ``init_inference``: the
    built server reports the degree and serves the single-rank streams."""
    ref = PagedServer(*port_params("mha"), attn_impl="plain", device="cpu", **SERVER)
    want = [o.tolist() for o in ref.serve(prompts(2, seed=8), max_new_tokens=4)]
    for res in runs["port"][degree]:
        got = res["engine"]
        assert got["tp_degree"] == degree and got["finished"] == 2
        assert got["outs"] == want

