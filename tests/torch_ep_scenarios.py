"""Expert parallelism on gloo ranks: the rank functions of
``test_torch_moe_ep.py`` (JAX-free, so the fork server imports no JAX).

``rank_ep2`` runs every two-rank scenario in one group: the MoE model
under tensor parallelism, the groups API,
the token mappings, the exchanges and their gradients, the layer's fast
path, shard-local drops, engine steps at ``expert=2`` (stages 1 and 3, the
int8 wire, the streamed and the host-Adam optimizer offload) and at
``data=2``, a resize that must arm no multi-step window, the ep = 2 checkpoint (resume, a
``train.mid_step`` kill, a JAX-written tag read back), and the inference
engine's ``forward``, ``generate`` and ``serve`` under the expert axis.
``rank_ep4`` runs the engine at ``data=2 × expert=2``. Every input comes
from a numpy seed named here, so the parent builds the same inputs for
the JAX references.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree
from deepspeed_tpu_torch.models import moe_transformer as pmt
from deepspeed_tpu_torch.models.transformer import init_params

T = 16
MICRO = 4  # rows a rank; every rank passes the global micro batch (MICRO x dp rows)
STEPS = 3
CKPT_AT = 2
LR = 1e-3
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=64,
            dtype="float32", remat=False, flash_attention=False, num_experts=4, moe_top_k=1, moe_use_rts=False,
            capacity_factor=1.0, eval_capacity_factor=1.0, min_capacity=2, intermediate_size=48)
TRAIN = {"optimizer": {"type": "adam", "params": {"lr": LR}}, "gradient_clipping": 0.1, "steps_per_print": 10**6}
LAYER = dict(hidden_size=16, num_experts=4, capacity_factor=1.0, min_capacity=2, intermediate_size=24,
             activation="gelu")
LAYER_S = 32  # global tokens of the layer cases
EXCHANGE = (4, 3, 8)  # a rank's [E, C, H] dispatch buffer
SERVE = {"page_size": 8, "max_slots": 4, "num_pages": 40, "prefill_chunk": 8}
JAX_TAG_WAIT_S = 150.0


def model_cfg(**kw):
    return pmt.moe_llama_config("tiny", **dict(TINY, **kw))


def tree(**kw):
    return unflatten_tree(init_params(model_cfg(**kw), 0))


def batches(n, rows, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rs.randint(0, TINY["vocab_size"], (rows, T + 1)).astype(np.int32)
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def layer_tree(k):
    from deepspeed_tpu_torch.moe.layer import MoE

    return MoE(**LAYER, k=k).init(np.random.default_rng(10 + k))


def layer_inputs():
    rs = np.random.RandomState(11)
    x = rs.randn(LAYER_S, LAYER["hidden_size"]).astype(np.float32)
    upstream = rs.randn(LAYER_S, LAYER["hidden_size"]).astype(np.float32)
    return x, upstream


def exchange_inputs(world):
    """Each rank's ``[E, C, H]`` buffer (dispatch input) and ``[E/e, e·C,
    H]`` buffer (combine input), and the upstream gradients of both
    outputs, stacked over the ranks."""
    E, C, H = EXCHANGE
    rs = np.random.RandomState(12)
    x = rs.randn(world, E, C, H).astype(np.float32)
    y = rs.randn(world, E // world, world * C, H).astype(np.float32)
    gx = rs.randn(world, E // world, world * C, H).astype(np.float32)
    gy = rs.randn(world, E, C, H).astype(np.float32)
    x[:, 1, 2] = 0.0  # an all-zero row: the int8 wire's scale floor
    return x, y, gx, gy


def skewed(seed=3, S=64, E=4, H=16):
    """JAX ``test_moe_fast_path.py``'s skewed logits: most tokens want
    expert 0, so the capacity binds."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(S, E).astype(np.float32)
    logits[:, 0] += 4.0
    tokens = rs.randn(S, H).astype(np.float32)
    return tokens, logits


def infer_inputs():
    rs = np.random.RandomState(13)
    toks = rs.randint(0, TINY["vocab_size"], (2, 16)).astype(np.int32)  # 32 tokens: the fast path at n = 2
    odd = rs.randint(0, TINY["vocab_size"], (3, 5)).astype(np.int32)  # 15 tokens: JAX gates globally
    prompts = [rs.randint(0, TINY["vocab_size"], (n,)).astype(np.int32) for n in (5, 11, 3, 9)]
    return toks, odd, prompts, [6, 4, 7, 5]


STREAMED = {"device": "cpu", "pipeline_read": True, "pipeline_write": True, "bucket_size": 20000}


def port_engine(mesh, stage, offload=None, **model_kw):
    dp = int(np.prod(list(mesh.values())))
    zero = {"stage": stage, "stage3_param_persistence_threshold": 0}
    if offload is not None:
        zero["offload_optimizer"] = offload
    cfg = dict(TRAIN, train_micro_batch_size_per_gpu=MICRO, mesh=dict(mesh), zero_optimization=zero)
    engine, *_ = dst.initialize(model=pmt.MoETransformerLM(model_cfg(**model_kw)), config=cfg,
                                model_parameters=tree(), device="cpu")
    assert engine.data_parallel_world_size() == dp
    return engine


def train(engine, bs):
    return [(engine.train_batch(batch=b), engine.get_global_grad_norm()) for b in bs]


def master(engine):
    return {k: np.array(v) for k, v in flatten_tree(engine.get_master_params()).items()}


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# --- the scenarios --------------------------------------------------------------------------------
def _groups_checks(rank):
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import mesh
    from deepspeed_tpu_torch.utils import groups

    out = {}
    mesh.reset_topology()
    try:
        groups.initialize(ep_size=3)
    except ValueError as e:
        out["indivisible"] = str(e)
    groups.initialize(ep_size=2)
    groups.initialize(ep_size=2)  # the same size: validated, nothing rebuilt
    try:
        groups.initialize(ep_size=4)
    except ValueError as e:
        out["resize"] = str(e)
    dp, ep, edp = groups._get_data_parallel_group(), groups._get_expert_parallel_group(), \
        groups._get_expert_data_parallel_group()
    out.update(sizes=(dp.size, ep.size, edp.size, groups._get_model_parallel_group().size,
                      groups._get_sequence_parallel_group().size, groups._get_sequence_data_parallel_group().size),
               world_sizes=(groups.get_data_parallel_world_size(), groups.get_expert_parallel_world_size(),
                            groups.get_expert_data_parallel_world_size(), groups.get_model_parallel_world_size(),
                            groups.get_sequence_parallel_world_size()),
               name=groups._get_max_expert_size_name(), ranks=(dp.ranks, len(dp), ep.global_ranks),
               comm_size=comm.get_world_size(group=ep), comm_rank=comm.get_rank(group=ep),
               rank=(groups.get_data_parallel_rank(), groups.get_expert_parallel_rank(),
                     groups.get_model_parallel_rank()),
               established=mesh.get_topology().user_established, topo=mesh.get_topology().sizes)
    # a mesh-less initialize adopts the established topology; an explicit mesh wins
    adopted = dst.initialize(model=pmt.MoETransformerLM(model_cfg()), model_parameters=tree(), device="cpu",
                             config=dict(TRAIN, train_micro_batch_size_per_gpu=MICRO))[0]
    explicit = dst.initialize(model=pmt.MoETransformerLM(model_cfg()), model_parameters=tree(), device="cpu",
                              config=dict(TRAIN, train_micro_batch_size_per_gpu=MICRO, mesh={"data": 2}))[0]
    out["adopted"] = (adopted.topo.sizes["expert"], adopted.topo.sizes["data"], explicit.topo.sizes["expert"],
                      explicit.topo.sizes["data"])
    groups.initialize(ep_size=2)  # the explicit mesh replaced the live topology: establish it again
    return out


def _mappings_checks(rank, world):
    from deepspeed_tpu_torch.moe import mappings
    from deepspeed_tpu_torch.parallel import mesh

    live = mesh.live_topology()
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    out = {"identity": mappings.drop_tokens(x, 0) is x and mappings.gather_tokens(x, 0) is x}
    mesh.set_topology(mesh.Topology({"model": world}, rank=rank).build_groups())
    try:
        xg = x.clone().requires_grad_(True)
        dropped = mappings.drop_tokens(xg, dim=0)
        gathered = mappings.gather_tokens(dropped, dim=0)
        (gathered ** 2).sum().backward()
        out.update(dropped=dropped.detach().numpy(), gathered=gathered.detach().numpy(), grad=xg.grad.numpy(),
                   dim1=mappings.drop_tokens(x, dim=1).numpy(), aliases=mappings._drop_tokens is mappings.drop_tokens)
        try:
            mappings.drop_tokens(torch.ones(3, 4), dim=0)
        except ValueError as e:
            out["indivisible"] = str(e)
    finally:
        mesh.set_topology(live)
    return out


def _exchange_checks(rank, world):
    from deepspeed_tpu_torch.moe import a2a
    from deepspeed_tpu_torch.parallel import mesh

    topo = mesh.get_topology()
    x, y, gx, gy = exchange_inputs(world)
    out = {}
    for quantized in (False, True):
        xi, yi = _t(x[rank], True), _t(y[rank], True)
        dispatched = a2a.exchange_shard(xi, topo, quantized=quantized)
        combined = a2a.exchange_shard(yi, topo, inverse=True, quantized=quantized)
        ((dispatched * _t(gx[rank])).sum() + (combined * _t(gy[rank])).sum()).backward()
        out["int8" if quantized else "fp"] = dict(dispatch=dispatched.detach().numpy(),
                                                  combine=combined.detach().numpy(), grad_x=xi.grad.numpy(),
                                                  grad_y=yi.grad.numpy())
    return out


def _layer_checks(rank, world, noise):
    """``noise``: each rank's JAX draws (the second-expert Gumbel sample of
    the key JAX folds with the rank's token-shard index)."""
    from deepspeed_tpu_torch.moe.layer import MoE

    x, upstream = layer_inputs()
    s = LAYER_S // world
    rows = slice(rank * s, (rank + 1) * s)
    out = {}
    for name, k, quantized, draws in (("k1", 1, False, None), ("k2", 2, False, None), ("k1_int8", 1, True, None),
                                      ("k2_noise", 2, False, noise[rank])):
        layer = MoE(**LAYER, k=k, quantized_a2a=quantized)
        params = {g: {n: _t(v, True) for n, v in leaves.items()} for g, leaves in layer_tree(k).items()}
        xi = _t(x[rows], True)
        y, l_aux, counts = layer.apply(params, xi, train=True,
                                       noise=None if draws is None else {n: _t(v) for n, v in draws.items()})
        ((y * _t(upstream[rows])).sum() + l_aux).backward()
        out[name] = dict(out=y.detach().numpy(), l_aux=float(l_aux.detach()), counts=counts.numpy(),
                         grad_x=xi.grad.numpy(),
                         grads={f"{g}/{n}": p.grad.numpy() for g, leaves in params.items()
                                for n, p in leaves.items()})
    return out


def _drop_checks(rank, world):
    from deepspeed_tpu_torch.moe import a2a, sharded_moe
    from deepspeed_tpu_torch.parallel import mesh

    topo = mesh.get_topology()
    tokens, logits = skewed()
    s = tokens.shape[0] // world
    rows = slice(rank * s, (rank + 1) * s)
    moved = logits.copy()
    moved[:s, 1] += 6.0  # shard 0's tokens pushed toward expert 1
    out = {}
    for name, lg in (("base", logits), ("moved", moved)):
        runs = []
        for _ in range(2):
            d, r, _aux, counts = a2a.ep_gate_dispatch(_t(tokens[rows]), _t(lg[rows]), topo, k=1, capacity_factor=1.0,
                                                      min_capacity=1, drop_tokens=True, use_rts=True)
            runs.append((d.numpy(), sharded_moe.dense_routing(r)[0].numpy(), counts.numpy()))
        out[name] = dict(dispatched=runs[0][0], combine=runs[0][1], counts=runs[0][2],
                         bitwise=all(np.array_equal(a, b) for a, b in zip(runs[0], runs[1])))
    return out


def _engine_runs(rank, world):
    out = {}
    bs = batches(STEPS, MICRO * world)
    for key, mesh, stage, kw in (("expert_1", {"expert": 2}, 1, {}), ("expert_3", {"expert": 2}, 3, {}),
                                 ("expert_int8", {"expert": 2}, 1, {"moe_quantized_a2a": True}),
                                 ("expert_streamed", {"expert": 2}, 1, {"offload": STREAMED}),
                                 ("expert_host_adam", {"expert": 2}, 2, {"offload": {"device": "cpu"}}),
                                 ("data_1", {"data": 2}, 1, {})):
        engine = port_engine(mesh, stage, **kw)
        out[key] = dict(rec=train(engine, bs), master=master(engine),
                        shapes={k: tuple(p.shape) for k, p in engine._params.items()},
                        offload=type(engine._host_offload).__name__,
                        plan=(None if engine._plan is None else engine._plan.a2a_world, engine._a2a.a2a_quantized))
    return out


def _resize_runs(rank, world):  # noqa: ARG001
    """The step programs' switches under an expert axis: construction
    refuses ``compile.multi_step`` across processes, and a resize to gas 1
    of an engine whose config turns it on arms no window (an MoE layer
    across ranks gates each rank's own rows), so ``train_batch(data_iter=)``
    steps as the sequential engine does."""
    out = {}
    cfg = dict(TRAIN, train_micro_batch_size_per_gpu=MICRO, mesh={"expert": 2}, zero_optimization={"stage": 1},
               compile={"fuse_grad_accum": True})
    try:
        dst.initialize(model=pmt.MoETransformerLM(model_cfg()), model_parameters=tree(), device="cpu",
                       config=dict(cfg, compile={"fuse_grad_accum": True, "multi_step": {"enable": True}}))
    except NotImplementedError as e:
        out["refused"] = str(e)
    bs = batches(STEPS, MICRO * world)
    out["sequential"] = train(port_engine({"expert": 2}, 1), bs)
    engine, *_ = dst.initialize(model=pmt.MoETransformerLM(model_cfg()), config=cfg, model_parameters=tree(),
                                device="cpu")
    ms = engine._config.compile_config.multi_step  # the switch a resize re-reads; 2 steps fit in the data
    ms.enable, ms.horizon = True, 2
    engine.set_train_batch_size(2 * MICRO * world)
    engine.set_train_batch_size(MICRO * world)
    it = iter(bs)
    out["resized"] = [(engine.train_batch(data_iter=it), engine.get_global_grad_norm()) for _ in bs]
    stats = engine.window_stats()
    out["windows"] = (stats["multi_step_enabled"], stats["window_steps"])
    return out


def _checkpoint_runs(rank, world, tmp):
    from deepspeed_tpu_torch.utils import chaos
    from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

    out = {}
    bs = batches(STEPS, MICRO * world)  # the JAX engine's: its tag comes after CKPT_AT of them
    a = port_engine({"expert": 2}, 1)
    train(a, bs[:CKPT_AT])
    a.save_checkpoint(os.path.join(tmp, "ep2"), tag="ep2")
    out["saved"] = master(a)
    out["continue"] = train(a, bs[CKPT_AT:])
    b = port_engine({"expert": 2}, 1)
    b.load_checkpoint(os.path.join(tmp, "ep2"), tag="ep2")
    out["loaded"] = master(b)
    out["resumed"] = train(b, bs[CKPT_AT:])
    out["steps"] = (b.global_steps, b.global_samples)
    sd = b.consolidated_16bit_state_dict()
    out["16bit_shapes"] = {k: tuple(v.shape) for k, v in sd.items()}
    fp32 = get_fp32_state_dict_from_zero_checkpoint(os.path.join(tmp, "ep2"), tag="ep2")
    out["zero_to_fp32"] = {k: np.asarray(v) for k, v in fp32.items()}

    # train.mid_step: the kill lands after the update, before anything of the step is committed
    c = port_engine({"expert": 2}, 1)
    train(c, bs[:CKPT_AT])
    chaos.install(chaos.ChaosSchedule([chaos.ChaosRule("train.mid_step", hit=1)]))
    try:
        train(c, bs[CKPT_AT:CKPT_AT + 1])
        out["killed"] = False
    except chaos.ChaosKilled:
        out["killed"] = True
    finally:
        chaos.uninstall()
    d = port_engine({"expert": 2}, 1)
    d.load_checkpoint(os.path.join(tmp, "ep2"), auto_resume=True)
    out["after_kill"] = train(d, bs[CKPT_AT:])

    # the JAX engine's ep = 2 tag (the parent writes it while the ranks run)
    ready = os.path.join(tmp, "jax_ep2", "READY")
    deadline = time.monotonic() + JAX_TAG_WAIT_S
    while not os.path.exists(ready):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no JAX tag at {ready} after {JAX_TAG_WAIT_S} s")
        time.sleep(0.2)
    e = port_engine({"expert": 2}, 1)
    e.load_checkpoint(os.path.join(tmp, "jax_ep2"), tag="jax")
    out["from_jax"] = dict(master=master(e), rec=train(e, bs[CKPT_AT:CKPT_AT + 1]))
    return out


def _inference_runs(rank, world):
    from deepspeed_tpu_torch.parallel import mesh

    assert mesh.get_topology().sizes["expert"] == world
    toks, odd, prompts, budgets = infer_inputs()
    engine = dst.init_inference(pmt.MoETransformerLM(model_cfg()), dtype="fp32", device="cpu", paged_kv=SERVE)
    engine.load_jax_params(tree())
    local = {k: tuple(v.shape) for k, v in flatten_tree(engine.module.param_tree()).items()}
    full = {k: v.numpy() for k, v in flatten_tree(engine._full_params()).items()}
    outs = engine.serve(prompts, max_new_tokens=budgets)
    return dict(logits=engine(toks).numpy(), logits_odd=engine(odd).numpy(),
                generate=engine.generate(toks[:, :8], max_new_tokens=6).numpy(), serve=[o.tolist() for o in outs],
                stats={k: engine.serve_stats()[k] for k in ("ep_degree", "tp_degree", "step_fingerprint",
                                                            "finished")},
                local_shapes=local, full=full)


def _tp_moe_checks(rank, world):  # noqa: ARG001
    """Tensor parallelism without an expert axis: the forward runs each MoE
    block on the replicated activation (the experts whole on every rank);
    ``generate`` and ``serve`` keep JAX's refusal."""
    _toks, odd, prompts, _budgets = infer_inputs()
    engine = dst.init_inference(pmt.MoETransformerLM(model_cfg()), dtype="fp32", device="cpu", paged_kv=SERVE,
                                tensor_parallel={"tp_size": world})
    engine.load_jax_params(tree())
    out = {"logits_odd": engine(odd).numpy(), "local_wq": tuple(engine._tp_params["layers"]["wq"].shape),
           "local_experts": tuple(engine._tp_params["layers"]["moe"]["experts"]["w_up"].shape)}
    for name, call in (("generate", lambda: engine.generate(odd, max_new_tokens=2)),
                       ("serve", lambda: engine.serve(prompts[:1], max_new_tokens=2))):
        try:
            call()
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def rank_ep2(rank, world, tmp, layer_noise):
    """Every two-rank scenario, in order (see the module docstring);
    ``layer_noise`` holds each rank's JAX gate draws for the noisy layer
    case."""
    out = {"tp": _tp_moe_checks(rank, world)}
    out.update(groups=_groups_checks(rank), mappings=_mappings_checks(rank, world))
    out["exchange"] = _exchange_checks(rank, world)
    out["layer"] = _layer_checks(rank, world, layer_noise)
    out["drops"] = _drop_checks(rank, world)
    out["inference"] = _inference_runs(rank, world)
    out["engines"] = _engine_runs(rank, world)
    out["resize"] = _resize_runs(rank, world)
    out["ckpt"] = _checkpoint_runs(rank, world, tmp)
    return out


def rank_ep4(rank, world, tmp):  # noqa: ARG001
    """``data=2 × expert=2``: the expert leaves reduce over the expert-data
    group (ranks 0 and 2, 1 and 3)."""
    bs = batches(STEPS, MICRO * world)
    engine = port_engine({"data": 2, "expert": 2}, 1)
    topo = engine.topo
    return dict(rec=train(engine, bs), master=master(engine), coords=topo.coords(),
                groups=(topo.group_ranks(("expert",)), topo.group_ranks(("data_outer", "data"))))
