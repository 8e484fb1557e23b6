"""The port's data pipeline against the JAX package's.

* indexed datasets: the same items (and a merged second dataset) written
  by each package's ``MMapIndexedDatasetBuilder`` give byte-identical
  ``.bin`` / ``.idx`` files, each package reads the other's; the
  ``DataAnalyzer`` map-reduce over two workers writes the same files with
  the same bytes;
* schedules and samplers: curriculum difficulties over steps 0..N for
  ``fixed_linear``, ``fixed_root``, ``fixed_discrete`` and a custom
  function, the random-LTD schedule, PLD's theta, the ``DistributedSampler``
  and ``DeepSpeedDataSampler`` index streams (over ``sampler_from_analysis``)
  and their ``state_dict``: equal to JAX's (host arithmetic, exact);
* loaders: ``DeepSpeedDataLoader`` under ``set_epoch``, wraparound through
  ``RepeatingLoader`` and a resume, and ``PrefetchingLoader``'s cursor
  while it holds batches ahead: the same batches and cursors as JAX's;
* the model: random-LTD with JAX's own token indices (not a prefix) on a
  tiny GPT-2 (the port's flash route; JAX's masked einsum) and a tiny Llama
  (GQA, RoPE): logits, loss and every gradient within 1e-5, remat bit for
  bit; PLD with JAX's own keep decisions (its key splits replayed): loss
  and gradients within 1e-5, the host-skip and the ``torch.where`` forms
  bit for bit each other;
* the engine: curriculum with random-LTD and PLD runs against the JAX
  engine (JAX's LTD indices and keep decisions handed to the port), fp32
  losses and grad norms within 1e-5; the fused step program bit for bit
  the eager steps under curriculum and LTD, releasing the shapes it left;
  ``initialize(training_data=...)``, the post-process hook and a custom
  schedule; a checkpoint cut while the window's look-ahead holds batches
  resumes bit for bit; JAX's refusals.
"""

from __future__ import annotations

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import config as jcfg_mod
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu.runtime import progressive_layer_drop as jpld
from deepspeed_tpu.runtime.data_pipeline import curriculum_scheduler as jcs
from deepspeed_tpu.runtime.data_pipeline import data_routing as jdr
from deepspeed_tpu.runtime.data_pipeline import data_sampler as jds
from deepspeed_tpu.runtime.data_pipeline.data_sampling import data_analyzer as jda
from deepspeed_tpu.runtime.data_pipeline.data_sampling import indexed_dataset as jid
from deepspeed_tpu_torch.checkpoint.jax_params import unflatten_tree
from deepspeed_tpu_torch.models import TransformerLM
from deepspeed_tpu_torch.models import config as pcfg_mod
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.runtime import dataloader as pdl
from deepspeed_tpu_torch.runtime import progressive_layer_drop as ppld
from deepspeed_tpu_torch.runtime.data_pipeline import curriculum_scheduler as pcs
from deepspeed_tpu_torch.runtime.data_pipeline import data_routing as pdr
from deepspeed_tpu_torch.runtime.data_pipeline import data_sampler as pds
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import data_analyzer as pda
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import indexed_dataset as pid

GPT2 = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=2, max_seq_len=32, dtype="float32",
            remat=False)
LLAMA = dict(GPT2, num_heads=4, num_kv_heads=2, norm="rmsnorm", position="rope", activation="swiglu",
             use_bias=False, tie_embeddings=False, flash_attention=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _docs(seed=0, n=12):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 1000, rs.randint(1, 9)) for _ in range(n)]


def _build(mod, prefix, docs, dtype=np.int32, merge=None):
    b = mod.make_builder(prefix + ".bin", dtype=dtype)
    for i, d in enumerate(docs):
        b.add_item(d)
        if i % 3 == 2:
            b.end_document()
    if merge is not None:
        b.merge_file_(merge)
    b.finalize(prefix + ".idx")


def _bytes(prefix):
    return tuple(open(prefix + ext, "rb").read() for ext in (".bin", ".idx"))


# --- indexed datasets and the analyzer -------------------------------------------
@pytest.mark.parametrize("dtype", [np.int32, np.uint16], ids=["int32", "uint16"])
def test_indexed_dataset_bytes_identical_both_ways(tmp_path, dtype):
    docs, more = _docs(0), _docs(1, 5)
    for mod, name in ((jid, "jax_more"), (pid, "port_more")):
        _build(mod, str(tmp_path / name), more, dtype)
    _build(jid, str(tmp_path / "jax"), docs, dtype, merge=str(tmp_path / "jax_more"))
    _build(pid, str(tmp_path / "port"), docs, dtype, merge=str(tmp_path / "port_more"))
    assert _bytes(str(tmp_path / "jax")) == _bytes(str(tmp_path / "port"))
    for reader, prefix in ((pid, "jax"), (jid, "port")):  # each package reads the other's files
        ds_ = reader.make_dataset(str(tmp_path / prefix))
        assert len(ds_) == len(docs) + len(more)
        for i, d in enumerate(docs + more):
            np.testing.assert_array_equal(ds_[i], d.astype(dtype))
        np.testing.assert_array_equal(ds_.get(2, 1, 2), docs[2].astype(dtype)[1:3])
        assert ds_.dtype == dtype and pid.code(ds_.dtype) == jid.code(dtype)
        np.testing.assert_array_equal(ds_.doc_idx, jid.make_dataset(str(tmp_path / "jax")).doc_idx)
    assert pid.MMapIndexedDataset.exists(str(tmp_path / "jax")) and not pid.MMapIndexedDataset.exists(str(tmp_path))


def _analyze(mod, docs, path):
    a = mod.DataAnalyzer(docs, num_workers=2, metric_names=["seqlen", "tokens"],
                         metric_functions=[len, lambda d: np.bincount(d % 7, minlength=7)],
                         metric_types=["single_value_per_sample", "accumulate_value_over_samples"], save_path=path)
    a.run()
    return a


def test_data_analyzer_files_equal_jax(tmp_path):
    docs = _docs(2, 15)
    ja = _analyze(jda, docs, str(tmp_path / "jax"))
    pa = _analyze(pda, docs, str(tmp_path / "port"))
    files = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        files[side] = {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
                       for d, _, fs in os.walk(root) for f in fs}
    assert files["jax"] == files["port"] and len(files["port"]) == 11
    np.testing.assert_array_equal(pa.load_sample_to_metric("seqlen"), ja.load_sample_to_metric("seqlen"))
    np.testing.assert_array_equal(pa.load_metric_values("seqlen"), ja.load_metric_values("seqlen"))
    np.testing.assert_array_equal(pa.load_accumulate("tokens"), ja.load_accumulate("tokens"))
    m2s = pa.load_metric_to_sample("seqlen")
    for i in range(len(m2s)):
        np.testing.assert_array_equal(m2s[i], ja.load_metric_to_sample("seqlen")[i])


# --- schedules and samplers ------------------------------------------------------------
SCHEDULES = {
    "fixed_linear": {"schedule_type": "fixed_linear",
                     "schedule_config": {"total_curriculum_step": 17, "difficulty_step": 8}},
    "fixed_root": {"schedule_type": "fixed_root",
                   "schedule_config": {"total_curriculum_step": 17, "difficulty_step": 8, "root_degree": 2}},
    "fixed_discrete": {"schedule_type": "fixed_discrete",
                       "schedule_config": {"difficulty": [16, 40, 64], "max_step": [5, 11]}},
    "custom": {"schedule_type": "custom"},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_curriculum_schedules_equal_jax(name):
    cfg = dict(min_difficulty=8, max_difficulty=64, **SCHEDULES[name])
    j, p = jcs.CurriculumScheduler(copy.deepcopy(cfg)), pcs.CurriculumScheduler(copy.deepcopy(cfg))
    if name == "custom":
        fn = lambda s: 8 + 3 * s  # noqa: E731
        j.set_custom_get_difficulty(fn)
        p.set_custom_get_difficulty(fn)
    assert [p.update_difficulty(s) for s in range(25)] == [j.update_difficulty(s) for s in range(25)]
    assert p.get_state() == j.get_state() and p.get_current_difficulty() == j.get_current_difficulty()
    state = copy.deepcopy(p.get_state())
    p.update_difficulty(3)
    p.set_state(state)
    assert p.get_current_difficulty() == j.get_current_difficulty()


def test_ltd_and_pld_schedules_equal_jax():
    j, p = jdr.RandomLTDScheduler(128, 1000, 37, 16), pdr.RandomLTDScheduler(128, 1000, 37, 16)
    assert [p.update(s) for s in range(45)] == [j.update(s) for s in range(45)]
    assert p.state_dict() == j.state_dict()
    jp, pp = jpld.ProgressiveLayerDrop(0.5, 0.01), ppld.ProgressiveLayerDrop(0.5, 0.01)
    for s in (0, 1, 10, 300):
        jp.update_state(s)
        pp.update_state(s)
        assert pp.get_state() == jp.get_state()


def test_random_layer_token_drop_and_gather_scatter_match_jax():
    """``RandomLayerTokenDrop`` on JAX's own ``random_token_select``
    indices, ``gather_tokens`` and ``scatter_tokens``: equal to JAX's (the
    same values moved); eval and a full kept count run the layer on every
    token."""
    x = np.random.RandomState(3).randn(2, 10, 4).astype(np.float32)
    idx = np.asarray(jdr.random_token_select(jax.random.PRNGKey(1), 10, 6, 2))
    fn_j = lambda p, h: h * p + 1.0  # noqa: E731
    fn_p = lambda p, h: h * p + 1.0  # noqa: E731
    want = np.asarray(jdr.RandomLayerTokenDrop(fn_j, jdr.RandomLTDScheduler(6, 10, 4))(
        2.0, jnp.asarray(x), jax.random.PRNGKey(1)))
    drop = pdr.RandomLayerTokenDrop(fn_p, pdr.RandomLTDScheduler(6, 10, 4))
    np.testing.assert_array_equal(drop(2.0, torch.from_numpy(x), idx=torch.from_numpy(idx)).numpy(), want)
    np.testing.assert_array_equal(drop(2.0, torch.from_numpy(x), train=False).numpy(), x * 2.0 + 1.0)
    sub = pdr.gather_tokens(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(sub.numpy(), np.asarray(jdr.gather_tokens(jnp.asarray(x), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        pdr.scatter_tokens(torch.from_numpy(x), sub * 3, torch.from_numpy(idx)).numpy(),
        np.asarray(jdr.scatter_tokens(jnp.asarray(x), jnp.asarray(np.asarray(sub) * 3), jnp.asarray(idx))))
    gen = torch.Generator().manual_seed(0)
    drawn = pdr.sample_layer_token_indices(gen, 3, 2, 10, 6)
    assert drawn.shape == (3, 2, 6) and (drawn.diff(dim=-1) > 0).all() and int(drawn.max()) < 10


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "ordered"])
def test_distributed_sampler_streams_equal_jax(shuffle):
    for rank in range(3):
        for drop_last in (True, False):
            kw = dict(dataset_len=11, num_replicas=3, rank=rank, shuffle=shuffle, seed=5, drop_last=drop_last)
            j, p = jds.DistributedSampler(**kw), pds.DistributedSampler(**kw)
            for epoch in range(2):
                j.set_epoch(epoch)
                p.set_epoch(epoch)
                assert list(p) == list(j) and len(p) == len(j)


def test_curriculum_sampler_from_analysis_equals_jax(tmp_path):
    docs = _docs(3, 20)
    _analyze(pda, docs, str(tmp_path))
    cl = {"min_difficulty": 2, "max_difficulty": 8, "schedule_type": "fixed_linear",
          "schedule_config": {"total_curriculum_step": 4, "difficulty_step": 2}}
    streams, states = [], []
    for mod in (jds, pds):
        sched = (jcs if mod is jds else pcs).CurriculumScheduler(copy.deepcopy(cl))
        s = mod.sampler_from_analysis(str(tmp_path), "seqlen", sched, num_replicas=2, rank=1, seed=3,
                                      global_batch_size=4)
        it = iter(s)
        streams.append([next(it) for _ in range(14)])
        states.append((s.state_dict(), s.eligible_indices().tolist()))
    assert streams[0] == streams[1] and states[0] == states[1]


# --- loaders ----------------------------------------------------------------------------
class _Items:
    """A map-style dataset of (tokens, labels) pairs."""

    def __init__(self, n=10, T=4):
        self.rows = np.arange(n * (T + 1)).reshape(n, T + 1) % 50

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return {"input_ids": self.rows[i, :-1], "labels": self.rows[i, 1:]}


def _drive(mod):
    """set_epoch, a wraparound through RepeatingLoader, and a resume from a
    saved cursor: the batches' first tokens and the cursors along the way."""
    loader = mod.DeepSpeedDataLoader(_Items(), batch_size=3, shuffle=True, seed=2)
    out = []
    loader.set_epoch(1)
    rep = mod.RepeatingLoader(loader)
    for _ in range(5):
        out.append((int(next(rep)["input_ids"][0, 0]), loader.state_dict(), rep.state_dict()))
    saved = rep.state_dict()
    fresh = mod.DeepSpeedDataLoader(_Items(), batch_size=3, shuffle=True, seed=2)
    rep2 = mod.RepeatingLoader(fresh)
    rep2.load_state_dict(saved)
    fresh.set_epoch(fresh.epoch)  # the canonical resumed loop: the same epoch keeps the cursor
    out += [(int(next(rep2)["input_ids"][0, 0]), fresh.state_dict()) for _ in range(3)]
    stream = mod.DeepSpeedDataLoader(iter(_Items()), batch_size=4, drop_last=False)
    stream.load_state_dict({"epoch": 0, "cursor": 1})
    out.append([b["input_ids"][:, 0].tolist() for b in stream])
    return out


def test_dataloader_cursors_equal_jax():
    assert _drive(pdl) == _drive(jdl)


def _prefetch(mod):
    """A look-ahead of depth 3 over a RepeatingLoader: the cursor it
    reports while batches wait, and a resume from that cursor in place."""
    loader = mod.DeepSpeedDataLoader(_Items(), batch_size=2)
    placed = []
    pl = mod.PrefetchingLoader(mod.RepeatingLoader(loader), place_fn=lambda b: placed.append(1) or b, depth=3,
                               state_source=loader)
    out = []
    for _ in range(4):
        out.append((int(next(pl)["input_ids"][0, 0]), pl.buffered(), pl.state_dict(), loader.state_dict()))
    assert pl.fill(5) == 5
    cursor = pl.state_dict()
    resumed = mod.DeepSpeedDataLoader(_Items(), batch_size=2)
    resumed.load_state_dict(cursor)
    out.append([int(b["input_ids"][0, 0]) for b, _ in zip(mod.RepeatingLoader(resumed), range(4))])
    again = mod.PrefetchingLoader(loader, depth=2)  # a re-iterable source resumes in place
    next(again)
    again.load_state_dict(cursor)
    out.append(int(next(again)["input_ids"][0, 0]))
    out.append(len(placed))
    with pytest.raises(ValueError, match="re-iterable"):
        mod.PrefetchingLoader(iter(loader)).load_state_dict(cursor)
    return out


def test_prefetching_loader_cursor_while_ahead_equals_jax():
    assert _prefetch(pdl) == _prefetch(jdl)


# --- the model: random-LTD and PLD ------------------------------------------------------
def _tokens(rs, rows, T, vocab=64):
    toks = rs.randint(0, vocab, (rows, T + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _port_run(model_kw, flat, tokens, labels, remat=False, **kwargs):
    model = TransformerLM(pcfg_mod.TransformerConfig(**dict(model_kw, remat=remat)))
    params = {p: torch.tensor(a, requires_grad=True) for p, a in flat.items()}
    loss = model.apply(unflatten_tree(params), (torch.from_numpy(tokens).long(), torch.from_numpy(labels).long()),
                       train=True, **kwargs)
    loss.backward()
    return float(loss.detach()), {p: t.grad.numpy() for p, t in params.items()}


def _jax_run(model_kw, flat, tokens, labels, **kwargs):
    jm = JaxLM(jcfg_mod.TransformerConfig(**dict(model_kw, flash_attention=False)))
    tree = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jm.apply(p, (jnp.asarray(tokens), jnp.asarray(labels)),
                                                                train=True, **kwargs)))(tree)
    flat_g = {}
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        flat_g["/".join(k.key for k in path)] = np.asarray(g)
    return float(loss), flat_g


def _assert_matches(port, ref, tol=1e-5):
    np.testing.assert_allclose(port[0], ref[0], rtol=tol)
    for path, g in ref[1].items():
        np.testing.assert_allclose(port[1][path], g, rtol=tol, atol=tol, err_msg=path)


@pytest.mark.parametrize("name", ["gpt2-flash", "llama-gqa"])
def test_random_ltd_model_matches_jax(name):
    """Layers 1-2 of 4 on JAX's sampled token subsets (12 of 16, not a
    prefix): loss and gradients within 1e-5; remat bit for bit."""
    model_kw = GPT2 if name == "gpt2-flash" else LLAMA
    flat = init_params(pcfg_mod.TransformerConfig(**model_kw), 0)
    tokens, labels = _tokens(np.random.RandomState(1), 2, 16)
    idx = np.asarray(jdr.sample_layer_token_indices(jax.random.PRNGKey(4), 2, 2, 16, 12))
    assert (idx[..., -1] != 11).any()  # the subsets are not the prefix
    ref = _jax_run(model_kw, flat, tokens, labels, ltd_idx=jnp.asarray(idx))
    got = _port_run(model_kw, flat, tokens, labels, ltd_idx=torch.from_numpy(idx).long())
    _assert_matches(got, ref)
    rem = _port_run(model_kw, flat, tokens, labels, remat=True, ltd_idx=torch.from_numpy(idx).long())
    assert rem[0] == got[0]
    for path in got[1]:
        np.testing.assert_array_equal(rem[1][path], got[1][path], err_msg=path)


def _jax_keep(key, L, theta):
    """JAX ``_forward``'s PLD keep draws for ``rngs={"dropout": key}``:
    per layer ``rng, sub = split(rng)``; ``sub, keep_rng = split(sub)``."""
    rng, keep = key, []
    for i in range(L):
        rng, sub = jax.random.split(rng)
        sub, keep_rng = jax.random.split(sub)
        keep.append(bool(jax.random.bernoulli(keep_rng, 1.0 - (i + 1) / L * (1.0 - theta))))
    return keep


def test_pld_model_matches_jax_with_its_keep_decisions():
    """theta 0.3 over 4 layers with a key whose draws drop some layers and
    keep others: loss and gradients within 1e-5 of JAX's; the host skip
    and the torch.where form (a step program's) bit for bit."""
    flat = init_params(pcfg_mod.TransformerConfig(**GPT2), 0)
    tokens, labels = _tokens(np.random.RandomState(2), 2, 16)
    key = next(k for k in (jax.random.PRNGKey(s) for s in range(50)) if 0 < sum(_jax_keep(k, 4, 0.3)) < 4)
    keep = _jax_keep(key, 4, 0.3)
    ref = _jax_run(GPT2, flat, tokens, labels, rngs={"dropout": key}, pld_theta=jnp.float32(0.3))
    got = _port_run(GPT2, flat, tokens, labels, pld_keep=keep)
    _assert_matches(got, ref)
    where = _port_run(GPT2, flat, tokens, labels, pld_keep=torch.tensor(keep))
    assert where[0] == got[0]
    for path in got[1]:
        np.testing.assert_array_equal(where[1][path], got[1][path], err_msg=path)


# --- the engine -------------------------------------------------------------------------
CURRICULUM = {"enabled": True, "min_difficulty": 8, "max_difficulty": 16, "schedule_type": "fixed_linear",
              "schedule_config": {"total_curriculum_step": 2, "difficulty_step": 8}}
LTD = {"enabled": True, "data_routing": {"enabled": True, "random_ltd": {
    "enabled": True, "random_ltd_layer_num": 2,
    "random_ltd_schedule": {"min_value": 4, "max_value": 16, "schedule_config": {"require_steps": 2,
                                                                                 "seq_per_step": 4}}}}}
BASE = {"optimizer": {"type": "adam", "params": {"lr": 1e-3}}, "gradient_clipping": 1.0, "steps_per_print": 10_000}


def _jax_engine(model_kw, cfg, tree, batch):
    je, *_ = ds.initialize(model=JaxLM(jcfg_mod.TransformerConfig(**dict(model_kw, flash_attention=False))),
                           model_parameters=tree, config=dict(cfg, train_micro_batch_size_per_gpu=1))
    je.init_params(batch)
    return je


def _port_engine(model_kw, cfg, tree, **kw):
    pe, *_ = dst.initialize(model=TransformerLM(pcfg_mod.TransformerConfig(**model_kw)), model_parameters=tree,
                            device="cpu", config=dict(cfg, train_micro_batch_size_per_gpu=8), **kw)
    return pe


def _batches(n, T=16):
    rs = np.random.RandomState(6)
    return [dict(zip(("input_ids", "labels"), _tokens(rs, 8, T))) for _ in range(n)]


def _step(e, batch):
    loss = e(batch)
    e.backward(loss)
    e.step()
    return float(loss)


def test_curriculum_and_random_ltd_engine_matches_jax():
    """One step at gas 1, 3 layers (random-LTD on layer 1): the batch of 16
    cut to the curriculum's 8 and layer 1 on 4 of them. JAX's LTD indices
    (its ``_model_kwargs``) go to the port's engine in place of its own
    draws: loss and grad norm within 1e-5, both schedules' states equal
    after the step (8 -> 16, 4 -> 8). The schedules across steps are held
    by the fused-program test below."""
    model_kw = dict(GPT2, num_layers=3)
    tree = unflatten_tree(init_params(pcfg_mod.TransformerConfig(**model_kw), 3))
    ltd = copy.deepcopy(LTD)
    ltd["data_routing"]["random_ltd"]["random_ltd_layer_num"] = 1
    cfg = dict(BASE, curriculum_learning=CURRICULUM, data_efficiency=ltd)
    batches = _batches(1)
    je = _jax_engine(model_kw, cfg, tree, batches[0])
    pe = _port_engine(model_kw, cfg, tree)
    drawn = []
    orig = je._model_kwargs
    je._model_kwargs = lambda placed=None: drawn.append(orig(placed)) or drawn[-1]
    pe._model_kwargs = lambda B, T, seed, host_keep: {k: torch.from_numpy(np.asarray(v)).long()
                                                      for k, v in drawn[-1].items()}
    shapes = []
    for b in batches:
        lj = _step(je, b)
        lp = _step(pe, b)
        shapes.append((pe.curriculum_scheduler.get_current_difficulty(),
                       tuple(np.shape(drawn[-1]["ltd_idx"])) if "ltd_idx" in drawn[-1] else None))
        np.testing.assert_allclose(lp, lj, rtol=1e-5)
        np.testing.assert_allclose(pe.get_global_grad_norm(), je.get_global_grad_norm(), rtol=1e-5)
    assert shapes == [(8, (1, 8, 4))]
    assert pe.random_ltd_scheduler.state_dict() == je.random_ltd_scheduler.state_dict()
    assert pe.curriculum_scheduler.get_state() == je.curriculum_scheduler.get_state()


def test_pld_engine_matches_jax():
    """PLD theta 0.1, gamma 1 over 4 layers, gas 2, 2 steps: JAX draws its
    keep decisions inside its step from the step's key; the test replays
    them (its key splits) and hands them to the port. Losses and grad norms
    within 1e-5."""
    tree = unflatten_tree(init_params(pcfg_mod.TransformerConfig(**GPT2), 4))
    cfg = dict(BASE, progressive_layer_drop={"enabled": True, "theta": 0.1, "gamma": 1.0},
               gradient_accumulation_steps=2)
    batches = _batches(4)
    je = _jax_engine(GPT2, cfg, tree, batches[0])
    pe = _port_engine(GPT2, cfg, tree)
    keys = []
    fwd = je._jit_fwd_bwd
    je._jit_fwd_bwd = lambda *a: keys.append((a[3], float(a[5]["pld_theta"]))) or fwd(*a)
    pe._model_kwargs = lambda B, T, seed, host_keep: {"pld_keep": _jax_keep(keys[-1][0], 4, keys[-1][1])}
    kept = []
    for b in batches:
        lj = _step(je, b)
        lp = _step(pe, b)
        kept.append(sum(_jax_keep(keys[-1][0], 4, keys[-1][1])))
        np.testing.assert_allclose(lp, lj, rtol=1e-5)
    np.testing.assert_allclose(pe.get_global_grad_norm(), je.get_global_grad_norm(), rtol=1e-5)
    assert min(kept) < 4  # layers did drop
    assert pe.progressive_layer_drop.get_theta() == je.progressive_layer_drop.get_theta()


def test_fused_step_program_equals_eager_under_curriculum_and_ltd():
    """``fuse_grad_accum`` at gas 2 with curriculum and random-LTD: every
    step equal to the eager engine's bit for bit (the same draws from the
    same seeds), and the step programs of lengths the schedule left are
    released (one program alive)."""
    tree = unflatten_tree(init_params(pcfg_mod.TransformerConfig(**GPT2), 5))
    cfg = dict(BASE, curriculum_learning=CURRICULUM, data_efficiency=LTD, gradient_accumulation_steps=2)
    fused = _port_engine(GPT2, dict(cfg, compile={"fuse_grad_accum": True}), tree)
    eager = _port_engine(GPT2, cfg, tree)
    rs = np.random.RandomState(8)
    for _ in range(3):
        batch = dict(zip(("input_ids", "labels"), _tokens(rs, 16, 16)))
        assert fused.train_batch(batch=batch) == eager.train_batch(batch=batch)
        assert fused.get_global_grad_norm() == eager.get_global_grad_norm()
        assert len(fused._graphs) == 1
    assert fused.window_stats()["graphs"]["uncaptured"] == 3
    m1, m2 = fused.get_master_params(), eager.get_master_params()
    for p in ("embed/tokens", "layers/wq"):
        a, b = m1, m2
        for k in p.split("/"):
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a, b)


def test_training_data_hooks_and_custom_schedule():
    """``initialize(training_data=...)`` returns the engine dataloader
    (micro x dp rows a batch); the post-process hook runs on each batch; a
    custom curriculum function drives the truncation."""
    tree = unflatten_tree(init_params(pcfg_mod.TransformerConfig(**GPT2), 0))
    pe, _, loader, _ = dst.initialize(model=TransformerLM(pcfg_mod.TransformerConfig(**GPT2)), model_parameters=tree,
                                      device="cpu", training_data=_Items(20, 16),
                                      config=dict(BASE, train_micro_batch_size_per_gpu=4,
                                                  curriculum_learning=dict(CURRICULUM, schedule_type="custom")))
    assert loader is pe.training_dataloader and loader.batch_size == 4
    seen = []
    pe.set_data_post_process_func(lambda b: seen.append(1) or b)
    pe.set_custom_curriculum_learning_schedule({"seqlen": lambda step: 4 * step})
    it = iter(pdl.RepeatingLoader(loader))
    for _ in range(2):
        _step(pe, next(it))
    assert len(seen) == 2 and pe.curriculum_scheduler.get_current_difficulty() == 8
    assert pe._last_batch[0].shape == (4, 8)
    with pytest.raises(ValueError, match="engine-owned dataloader"):
        _port_engine(GPT2, BASE, tree).set_data_post_process_func(lambda b: b)
    with pytest.raises(ValueError, match="needs data_iter or batch"):
        pe.train_batch()


def test_checkpoint_cut_while_prefetching_resumes_bitwise(tmp_path):
    """Windows of 2 (multi_step) over the engine dataloader: after 2
    windows the look-ahead holds batches it pulled; a checkpoint there
    carries the cursor of the first untrained one, and a fresh engine
    resumed from it trains steps 5-8 bit for bit as the uninterrupted run."""
    tree = unflatten_tree(init_params(pcfg_mod.TransformerConfig(**GPT2), 6))
    cfg = dict(BASE, compile={"multi_step": {"enable": True, "horizon": 2}})

    def run(n, load=False):
        pe = _port_engine(GPT2, cfg, tree, training_data=_Items(40, 16))
        if load:
            pe.load_checkpoint(str(tmp_path))
        it = pdl.RepeatingLoader(pe.training_dataloader)
        losses = [float(pe.train_batch(data_iter=it)) for _ in range(n)]
        return pe, losses

    full_engine, full = run(8)
    pe, first = run(4)
    assert pe._active_prefetcher.buffered() == 2  # batches pulled ahead, not trained
    pe.save_checkpoint(str(tmp_path))
    assert pe._checkpoint_state(None)["data_cursor"] == {"epoch": 0, "cursor": 4}
    _, rest = run(4, load=True)
    assert first + rest == full


def test_refusals_as_jax():
    """JAX's refusals, word for word: PLD with random-LTD; curriculum, PLD
    and random-LTD with ``compile.multi_step``; PLD on the param-offload
    path."""
    tree = unflatten_tree(init_params(pcfg_mod.TransformerConfig(**GPT2), 0))
    pld = {"progressive_layer_drop": {"enabled": True}}
    with pytest.raises(ValueError, match="progressive_layer_drop and random_ltd cannot be combined"):
        _port_engine(GPT2, dict(BASE, data_efficiency=LTD, **pld), tree)
    for extra in ({"curriculum_learning": CURRICULUM}, pld, {"data_efficiency": LTD}):
        with pytest.raises(ValueError, match="compile.multi_step is incompatible"):
            _port_engine(GPT2, dict(BASE, compile={"multi_step": {"enable": True}}, **extra), tree)
    with pytest.raises(NotImplementedError, match="param-offload path"):
        _port_engine(GPT2, dict(BASE, zero_optimization={"stage": 3, "offload_param": {"device": "cpu"}}, **pld),
                     tree)
