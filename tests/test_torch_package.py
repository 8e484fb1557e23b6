"""Package rules of ``deepspeed_tpu_torch`` and its small modules' parity.

* the port and ``chip_smoke.py`` import neither ``jax`` nor ``deepspeed_tpu``;
* the entry points run on ``cuda`` by default and raise without a card;
* switches whose paths are not ported raise ``NotImplementedError``;
* the configs, presets, norm, RoPE, dense FFN and the page allocator agree
  with the JAX package (fp32; tolerances stated at each check).
"""

from __future__ import annotations

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.kv_pool import PagePool as JaxPagePool
from deepspeed_tpu.models import config as jax_model_config
from deepspeed_tpu.models.transformer import _norm as jax_norm, _rope as jax_rope
from deepspeed_tpu.moe.experts import apply_dense_ffn as jax_ffn
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.compression.int8 import quantize_params_int8
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.decode import init_cache
from deepspeed_tpu_torch.inference.fleet import FleetRouter, ReplicaHandle
from deepspeed_tpu_torch.inference.kv_pool import PagePool, init_paged_cache
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.inference.traffic import MultiTenantServer
from deepspeed_tpu_torch.models import TransformerLM
from deepspeed_tpu_torch.models import config as port_model_config
from deepspeed_tpu_torch.models.transformer import _norm, _rope
from deepspeed_tpu_torch.moe.experts import apply_dense_ffn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            max_seq_len=32, norm="rmsnorm", position="rope", activation="swiglu",
            use_bias=False, tie_embeddings=False, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast and leaves the cores to
    the JAX tests running in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "deepspeed_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax") or top == "deepspeed_tpu"


def test_port_imports_no_jax_and_no_jax_package():
    bad = []
    files = _port_sources()
    assert len(files) > 10 and os.path.exists(files[0])
    for module in ("inference/sampling.py", "inference/decode.py", "profiling/decode_profile.py",
                   "compression/int8.py", "ops/quantizer/__init__.py", "elasticity/fleet_policy.py",
                   "elasticity/elasticity.py", "utils/loadgen.py", "inference/traffic.py", "inference/fleet.py",
                   "comm/comm.py", "comm/__init__.py", "comm/reduce_op.py", "inference/tp.py",
                   "inference/mp_checkpoint.py", "module_inject/auto_tp.py", "utils/tensor_fragment.py"):
        assert any(f.endswith(os.path.join("deepspeed_tpu_torch", module)) for f in files), module
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [f"{path}: import {a.name}" for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                if _forbidden(node.module):
                    bad.append(f"{path}: from {node.module}")
    assert not bad, bad


def test_init_inference_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    model = TransformerLM(port_model_config.TransformerConfig(**TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        dst.init_inference(model, dtype="fp32")
    with pytest.raises(RuntimeError, match="CUDA"):
        dst.init_inference(model, dtype="fp32", device="cuda")
    engine = dst.init_inference(model, dtype="fp32", device="cpu")
    assert engine.device.type == "cpu"


def _tiny_tree():
    jcfg = jax_model_config.TransformerConfig(**TINY)
    from deepspeed_tpu.models import TransformerLM as JaxLM

    return jax.tree_util.tree_map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))


def _server(cfg, tree, **kw):
    return PagedServer(cfg, load_jax_params(TransformerLM(cfg), tree, device="cpu").param_tree(), num_pages=6,
                       max_slots=2, **kw)


LOWER_ENTRY_POINTS = {
    "PagedServer": _server,
    # TINY's FFN is empty (intermediate size 0): the attention projections and the head take int8
    "PagedServer_int8": lambda cfg, tree, **kw: PagedServer(
        cfg, quantize_params_int8(load_jax_params(TransformerLM(cfg), tree, device="cpu").param_tree(),
                                  leaves=frozenset({"wq", "wk", "wv", "wo", "lm_head"})),
        num_pages=6, max_slots=2, **kw),
    "MultiTenantServer": lambda cfg, tree, **kw: MultiTenantServer(_server(cfg, tree, **kw), tenants=[]),
    "FleetRouter": lambda cfg, tree, **kw: FleetRouter(
        [ReplicaHandle(name=f"r{i}", server=_server(cfg, tree, **kw)) for i in range(2)]),
    "PagePool": lambda cfg, tree, **kw: PagePool(cfg, 6, 4, 2, **kw),
    "init_paged_cache": lambda cfg, tree, **kw: init_paged_cache(cfg, 6, 4, **kw),
    "init_cache": lambda cfg, tree, **kw: init_cache(cfg, 2, 16, **kw),
    "load_jax_params": lambda cfg, tree, **kw: load_jax_params(TransformerLM(cfg), tree, **kw),
}


@pytest.mark.parametrize("name", sorted(LOWER_ENTRY_POINTS))
def test_lower_entry_points_default_to_cuda(name):
    """The public pieces under the engine take the same default as
    ``init_inference``: ``cuda``, raising without a card; the CPU only by
    name."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = port_model_config.TransformerConfig(**TINY)
    tree = _tiny_tree()
    build = LOWER_ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        build(cfg, tree)
    build(cfg, tree, device="cpu")


# switch -> (config, the refusal, its message)
UNPORTED = {
    # tensor parallelism is ported: without a torch.distributed group the engine refuses the degree
    "tp_degree": ({"paged_kv": {"sharded": {"tp_degree": 2}}}, ValueError, "torch.distributed"),
    "tp_size": ({"tensor_parallel": {"tp_size": 2}}, ValueError, "torch.distributed"),
    "int8_dtype": ({"dtype": "int8"}, NotImplementedError, "ROADMAP|not ported"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_switches_raise(name):
    """The same JSON parses in both packages; the port then refuses the
    switch by name: an unported one pointing at its ROADMAP item, a
    tensor-parallel degree without the process group it needs."""
    config, exc, match = UNPORTED[name]
    JaxInferenceConfig(**config)
    model = TransformerLM(port_model_config.TransformerConfig(**TINY))
    with pytest.raises(exc, match=match):
        dst.init_inference(model, config=config, device="cpu")


def test_multi_step_alone_builds():
    """``paged_kv.multi_step`` alone is served (the window path is ported)."""
    model = TransformerLM(port_model_config.TransformerConfig(**TINY))
    engine = dst.init_inference(model, config={"paged_kv": {"multi_step": {"enable": True, "horizon": 4}}},
                                device="cpu")
    assert engine._config.paged_kv.multi_step.horizon == 4


@pytest.mark.parametrize("paged_kv", [{"ragged": False, "multi_step": {"enable": True}},
                                      {"multi_step": {"enable": True, "horizon": 1}}])
def test_multi_step_bad_settings_raise_as_jax(paged_kv):
    """Windows without the ragged path, or with a horizon of 1, raise
    ``ValueError`` in both packages."""
    with pytest.raises(ValueError):
        JaxInferenceConfig(paged_kv=paged_kv)
    model = TransformerLM(port_model_config.TransformerConfig(**TINY))
    with pytest.raises(ValueError):
        dst.init_inference(model, config={"paged_kv": paged_kv}, device="cpu")


@pytest.mark.parametrize("jax_name,port_name", [("pallas", "kernel"), ("xla", "plain"), ("auto", "auto"),
                                                ("kernel", "kernel"), ("plain", "plain")])
def test_attn_impl_names(jax_name, port_name):
    cfg = DeepSpeedInferenceConfig(paged_kv={"attn_impl": jax_name})
    assert cfg.paged_kv.attn_impl == port_name


def test_unknown_attn_impl_rejected():
    with pytest.raises(ValueError):
        DeepSpeedInferenceConfig(paged_kv={"attn_impl": "flash"})


def test_same_json_same_values():
    doc = {"dtype": "bf16", "tp": {"tp_size": 1}, "max_tokens": 77,
           "paged_kv": {"page_size": 32, "max_slots": 4, "prefill_chunk": 64, "num_pages": 100,
                        "prefix_cache": False, "max_seq_len": 512}}
    a, b = JaxInferenceConfig(**doc), DeepSpeedInferenceConfig(**doc)
    for key in ("page_size", "max_slots", "prefill_chunk", "num_pages", "prefix_cache", "max_seq_len"):
        assert getattr(a.paged_kv, key) == getattr(b.paged_kv, key)
    assert a.max_out_tokens == b.max_out_tokens == 77 and a.dtype.value == b.dtype.value


@pytest.mark.parametrize("family,size", [("gpt2_config", "125m"), ("llama_config", "1b"),
                                         ("llama_config", "7b"), ("qwen2_config", "0.5b"),
                                         ("qwen2_config", "tiny"), ("bert_config", "large"),
                                         ("bert_config", "base")])
def test_presets_match(family, size):
    a = getattr(jax_model_config, family)(size)
    b = getattr(port_model_config, family)(size)
    assert a.__dict__ == b.__dict__


def test_llama_1b_shape():
    cfg = port_model_config.llama_config("1b")
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.intermediate_size, cfg.vocab_size) == (22, 2048, 32, 4, 64, 5376, 32000)
    n = sum(int(np.prod(p.shape)) for p in TransformerLM(cfg).parameters())
    assert 1.0e9 < n < 1.1e9  # meta tensors: no memory taken


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(kind):
    rs = np.random.RandomState(0)
    x, s, b = rs.randn(3, 5, 48).astype(np.float32), rs.randn(48).astype(np.float32), rs.randn(48).astype(np.float32)
    ref = np.asarray(jax_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), kind, 1e-5))
    out = _norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), kind, 1e-5).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)  # fp32, reduction order only


@pytest.mark.parametrize("rope_dim", [None, 8])
def test_rope_matches_jax(rope_dim):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 6, 3, 16).astype(np.float32)
    pos = rs.randint(0, 2048, (2, 6)).astype(np.int32)
    ref = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, rope_dim))
    out = _rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, rope_dim).numpy()
    # angles up to 2048 rad: one fp32 ulp of the angle (~2.4e-4) bounds the gap
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("activation", ["gelu", "relu", "quick_gelu", "swiglu", "geglu"])
def test_dense_ffn_matches_jax(activation):
    rs = np.random.RandomState(2)
    H, I = 16, 40
    p = {"w_out": rs.randn(I, H), "b_out": rs.randn(H)}
    if activation in ("swiglu", "geglu"):
        p.update(w_gate=rs.randn(H, I), w_up=rs.randn(H, I))
    else:
        p.update(w_in=rs.randn(H, I), b_in=rs.randn(I))
    p = {k: (0.2 * v).astype(np.float32) for k, v in p.items()}
    x = rs.randn(3, 4, H).astype(np.float32)
    ref = np.asarray(jax_ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), activation))
    out = apply_dense_ffn({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), activation)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_load_jax_params_checks_the_tree():
    cfg = port_model_config.TransformerConfig(**TINY)
    params = _tiny_tree()
    model = load_jax_params(TransformerLM(cfg), params, device="cpu")
    np.testing.assert_array_equal(model.layers["wq"].numpy(), params["layers"]["wq"])
    flat = {"embed/tokens": params["embed"]["tokens"]}
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(TransformerLM(cfg), flat, device="cpu")
    bad = dict(params, lm_head=params["lm_head"][:, :-1])
    with pytest.raises(ValueError, match="lm_head"):
        load_jax_params(TransformerLM(cfg), bad, device="cpu")


def test_page_allocator_matches_jax():
    """The same random sequence of admissions, writes, prefix publishes,
    rollbacks and frees leaves both allocators with identical tables,
    lengths, refcounts, free lists and prefix stats."""
    cfg = port_model_config.TransformerConfig(**TINY)
    jcfg = jax_model_config.TransformerConfig(**TINY)
    rs = np.random.RandomState(5)
    a = JaxPagePool(jcfg, 14, 4, 3, dtype=jnp.float32)
    b = PagePool(cfg, 14, 4, 3, dtype=torch.float32, device="cpu")
    shared = rs.randint(0, 64, (9,)).astype(np.int32)
    ctx = {}
    for _ in range(120):
        op = rs.randint(4)
        live = [s for s in range(3) if s not in a._free_slots]
        if op == 0:
            toks = np.concatenate([shared, rs.randint(0, 64, (int(rs.randint(1, 6)),))]).astype(np.int32)
            sa, sb = a.alloc_slot(toks.size + 1, prefix_tokens=toks), b.alloc_slot(toks.size + 1, prefix_tokens=toks)
            assert sa == sb
            if sa is not None:
                ctx[sa] = toks
        elif op == 1 and live:
            s = live[rs.randint(len(live))]
            n = int(rs.randint(1, 4))
            ok_a = a.prepare_write(s, int(a.seq_lens[s]) + n)
            assert ok_a == b.prepare_write(s, int(b.seq_lens[s]) + n)
            if ok_a:
                a.advance(s, n)
                b.advance(s, n)
                ctx[s] = np.concatenate([ctx[s], rs.randint(0, 64, (n,)).astype(np.int32)])
                a.register_prefix(s, ctx[s])
                b.register_prefix(s, ctx[s])
        elif op == 2 and live:
            s = live[rs.randint(len(live))]
            n = int(rs.randint(0, int(a.seq_lens[s]) + 1))
            assert a.rollback(s, n) == b.rollback(s, n)
        elif op == 3 and live:
            s = live[rs.randint(len(live))]
            assert a.free_slot(s) == b.free_slot(s)
        np.testing.assert_array_equal(a.page_table, b.page_table)
        np.testing.assert_array_equal(a.seq_lens, b.seq_lens)
        np.testing.assert_array_equal(a._refcount, b._refcount)
        assert a._free == b._free and list(a._cached) == list(b._cached)
    assert a.prefix_stats() == b.prefix_stats()
    assert a.stats["cow_copies"] > 0 and a.stats["prefix_hit_tokens"] > 0
    b.integrity_check()


def test_kernel_digest_covers_headers(tmp_path):
    """The CUDA build is keyed by a hash of the source, every ``csrc/*.cuh``
    header and the flags: an edited header gives a new digest (so a stale
    library in ``_build/`` is not loaded), an untouched copy the same one.
    No ``nvcc`` is needed."""
    import shutil

    from deepspeed_tpu_torch.ops import native

    copy = tmp_path / "csrc"
    shutil.copytree(native.CSRC, copy)
    headers = sorted(p.name for p in copy.glob("*.cuh"))
    assert headers, "the tensor-core kernels share a csrc/*.cuh header"
    for name in ("flash_attention", "block_sparse_attention"):
        assert native.source_digest(name, str(copy)) == native.source_digest(name)
    before = {name: native.source_digest(name, str(copy)) for name in ("flash_attention", "ragged_paged_attention")}
    with open(copy / headers[0], "a") as f:
        f.write("\n// edited\n")
    after = {name: native.source_digest(name, str(copy)) for name in before}
    assert all(after[name] != before[name] for name in before)
    (copy / "extra.cuh").write_text("// a new header\n")
    assert native.source_digest("flash_attention", str(copy)) != after["flash_attention"]
