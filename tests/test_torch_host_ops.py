"""The port's host operations of the offload paths against the JAX package's.

Pure host code, no engine: both packages build their own copy of the host
C++ (``csrc/host/`` here, ``csrc/`` there) with the same ``g++`` flags, and
the same numpy inputs go through both.

* ``NativeCPUAdam`` and ``NativeCPUAdagrad`` bitwise equal to JAX's: sizes
  off the SIMD width and past the threading threshold, ``adamw_mode`` on
  and off, weight decay, a ``step`` override, several steps;
* aio: sync and async round trips, and a file the port writes byte-equal
  to JAX's ``aio_write`` of the same array;
* the swap buffers (``SwapBuffer``, ``SwapBufferPool``,
  ``SwapBufferManager``), the async swapper and the partitioned swapper's
  prefetch, fetch and writeback: the same sequences give the same offsets,
  free lists and file bytes;
* ``ContiguousMemoryAllocator`` sequences (best fit, release, merge,
  defragment) give JAX's offsets and contents;
* ``split_offload_buckets`` equal; the device ``DeepSpeedCPUAdagrad``
  against JAX's at 1e-7.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import aio as jax_aio
from deepspeed_tpu.ops.adam import cpu_adam_native as jax_adam
from deepspeed_tpu.runtime.swap_tensor import async_swapper as jax_async
from deepspeed_tpu.runtime.swap_tensor import partitioned_optimizer_swapper as jax_pswap
from deepspeed_tpu.runtime.swap_tensor import utils as jax_swap_utils
from deepspeed_tpu.runtime.swap_tensor.aio_config import AioConfig as JaxAioConfig
from deepspeed_tpu.runtime.zero import contiguous_memory_allocator as jax_alloc
from deepspeed_tpu.runtime.zero import host_offload as jax_host_offload
from deepspeed_tpu_torch.ops import aio
from deepspeed_tpu_torch.ops import native
from deepspeed_tpu_torch.ops.adam import cpu_adam_native
from deepspeed_tpu_torch.runtime.swap_tensor import async_swapper, partitioned_optimizer_swapper
from deepspeed_tpu_torch.runtime.swap_tensor import utils as swap_utils
from deepspeed_tpu_torch.runtime.swap_tensor.aio_config import AioConfig
from deepspeed_tpu_torch.runtime.zero import contiguous_memory_allocator, host_offload


def _state(n, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(n).astype(np.float32) for _ in range(2)] + [
        (rs.rand(n).astype(np.float32) * 0.1), (rs.rand(n).astype(np.float32) * 0.01)]


# --- host optimizers ------------------------------------------------------------------
ADAM_CASES = {
    "n15-adamw-wd": (15, True, 0.01, None),
    "n17-adam-wd": (17, False, 0.01, None),
    "n33-adamw-nowd": (33, True, 0.0, None),
    "n1049-adamw-step7": (1049, True, 0.01, 7),
    "threaded-1M+3-adam": (2**20 + 3, False, 0.01, None),
}


@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_native_adam_bitwise_matches_jax(case):
    """Three host Adam steps (or one at an explicit ``step``) on the same
    arrays: params and both moments bitwise JAX's."""
    n, adamw, wd, step = ADAM_CASES[case]
    kw = dict(lr=3e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=wd, adamw_mode=adamw)
    port, ref = cpu_adam_native.NativeCPUAdam(**kw), jax_adam.NativeCPUAdam(**kw)
    a, b = _state(n, 0), _state(n, 0)
    for i in range(1 if step else 3):
        g = np.random.RandomState(10 + i).randn(n).astype(np.float32)
        port.step(a[0], g, a[2], a[3], step=step)
        ref.step(b[0], g, b[2], b[3], step=step)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()
    assert cpu_adam_native.simd_width() == jax_adam.simd_width()
    assert cpu_adam_native.native_adam_available()


def test_native_adagrad_bitwise_matches_jax():
    for n, wd in ((17, 0.0), (1000, 0.01)):
        a, b = _state(n, 1), _state(n, 1)
        port = cpu_adam_native.NativeCPUAdagrad(lr=1e-2, eps=1e-10, weight_decay=wd)
        ref = jax_adam.NativeCPUAdagrad(lr=1e-2, eps=1e-10, weight_decay=wd)
        for i in range(2):
            g = np.random.RandomState(i).randn(n).astype(np.float32)
            port.step(a[0], g, a[2])
            ref.step(b[0], g, b[2])
        assert a[0].tobytes() == b[0].tobytes() and a[2].tobytes() == b[2].tobytes()


def test_host_build_is_the_jax_flags_and_lands_in_build_dir():
    flags = native.host_flags()
    assert flags[:5] == ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
    path = native.build_host("cpu_adam")
    assert os.path.dirname(path) == native.BUILD_DIR and os.path.basename(path).startswith("libcpu_adam_host_")
    assert native.HOST_CSRC.endswith(os.path.join("deepspeed_tpu_torch", "csrc", "host"))


def test_device_adagrad_matches_jax():
    import jax.numpy as jnp

    from deepspeed_tpu.ops.adagrad.cpu_adagrad import DeepSpeedCPUAdagrad as JaxAdagrad
    from deepspeed_tpu_torch.ops import DeepSpeedCPUAdagrad, DeepSpeedCPUAdam, FusedAdam

    assert DeepSpeedCPUAdam is FusedAdam
    rs = np.random.RandomState(3)
    params = {"a": rs.randn(5, 7).astype(np.float32), "b": rs.randn(3).astype(np.float32)}
    ja, pa = JaxAdagrad(lr=1e-2, weight_decay=0.01), DeepSpeedCPUAdagrad(lr=1e-2, weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = ja.init_state(jp), pa.init_state(pp)
    for i in range(3):
        g = {k: np.random.RandomState(i).randn(*v.shape).astype(np.float32) for k, v in params.items()}
        jp, js = ja.apply({k: jnp.asarray(v) for k, v in g.items()}, js, jp, 1e-2)
        pp, ps = pa.apply({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp, 1e-2)
    assert ps.step == int(js.step) == 3
    for k in params:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-7, atol=1e-7)
        np.testing.assert_allclose(ps.sum_sq[k].numpy(), np.asarray(js.sum_sq[k]), rtol=1e-7)


# --- aio ------------------------------------------------------------------------------
def test_aio_round_trips_and_files_equal_jax(tmp_path):
    data = np.random.RandomState(0).randn(3 * 2**18 + 5).astype(np.float32)  # 3 MB and a tail: several blocks
    aio.aio_write(data, str(tmp_path / "port.bin"))
    jax_aio.aio_write(data, str(tmp_path / "jax.bin"))
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes() == data.tobytes()
    assert aio.file_size(str(tmp_path / "port.bin")) == data.nbytes
    back = np.empty_like(data)
    assert aio.aio_read(back, str(tmp_path / "jax.bin")) == data.nbytes
    assert back.tobytes() == data.tobytes()
    h = aio.AsyncIOHandle(block_size=4096, queue_depth=4, thread_count=2)
    parts = [data[i::3].copy() for i in range(3)]
    for i, p in enumerate(parts):
        h.async_pwrite(p, str(tmp_path / f"a{i}.bin"))
    assert h.wait() == 3
    outs = [np.empty_like(p) for p in parts]
    for i, o in enumerate(outs):
        h.async_pread(o, str(tmp_path / f"a{i}.bin"))
    assert h.wait() == 3
    assert all(o.tobytes() == p.tobytes() for o, p in zip(outs, parts))
    assert aio.AIO_DEFAULT_DICT == jax_aio.AIO_DEFAULT_DICT and aio.AsyncIOBuilder().is_compatible()
    assert aio.IO_MODE == "buffered"
    with pytest.raises(IOError):
        h.sync_pread(np.empty(4, np.float32), str(tmp_path / "missing.bin"))


def test_aio_config_matches_jax():
    for d in ({}, {"block_size": 8192, "queue_depth": 2, "thread_count": 4}):
        assert AioConfig(**d).model_dump() == JaxAioConfig(**d).model_dump()


# --- swap buffers ----------------------------------------------------------------------
def _manager_trace(mod):
    m = mod.SwapBufferManager(num_elems=64, count=4)
    out = []
    a = m.allocate(40, count=3)
    out.append((len(a), [b.size for b in a], sorted(m.free_buffer_index)))
    assert m.allocate(10, count=2) is None
    m.free(a[1:])
    b = m.allocate_all(64)
    out.append(([x.size for x in b], sorted(m.free_buffer_index), m.gigabytes))
    pool = mod.SwapBufferPool([np.zeros(32, np.float32), np.zeros(32, np.float32)])
    recs = []
    for n in (10, 12, 16, 8, 30):
        s, c = pool.insert_tensor(np.arange(n, dtype=np.float32), f"p{n}", (n + 7) // 8 * 8)
        recs.append(None if s is None else (s.size, c.size, pool.current_index))
    out.append((recs, pool.get_swap_paths(), [t.size for t in pool.get_compute_tensors()]))
    return out


def test_swap_buffers_match_jax():
    assert _manager_trace(swap_utils) == _manager_trace(jax_swap_utils)
    bufs = [np.arange(10, dtype=np.float32)]
    assert [b.tolist() for b in swap_utils.get_sized_buffers(bufs, [4])] == \
        [b.tolist() for b in jax_swap_utils.get_sized_buffers(bufs, [4])]


def _async_swap(mod, handle_mod, root):
    os.makedirs(root, exist_ok=True)
    s = mod.AsyncTensorSwapper(handle_mod.AsyncIOHandle(), numel_alignment=256)
    s.add_buffers([np.zeros(1024, np.float32) for _ in range(2)])
    rs = np.random.RandomState(4)
    for i, n in enumerate((300, 500, 700, 100, 900)):
        s.swap_out_tensors([rs.randn(n).astype(np.float32)], [os.path.join(root, f"t{i}.swp")])
    s.release_buffers()
    return {f: open(os.path.join(root, f), "rb").read() for f in sorted(os.listdir(root))}


def test_async_swapper_files_match_jax(tmp_path):
    assert _async_swap(async_swapper, aio, str(tmp_path / "p")) == _async_swap(jax_async, jax_aio, str(tmp_path / "j"))


def _pswap(mod, cfg_cls, root):
    class Cfg:
        buffer_count = 4

    sw = mod.PartitionedOptimizerSwapper(swap_config=Cfg(), aio_config=cfg_cls(), base_folder=root,
                                         largest_numel=5000, device_id=0)
    rs = np.random.RandomState(5)
    sizes = {"a": 3000, "b": 5000, "c": 17}
    state = {k: {"exp_avg": rs.randn(n).astype(np.float32), "exp_avg_sq": rs.rand(n).astype(np.float32)}
             for k, n in sizes.items()}
    for k, n in sizes.items():
        sw.register_param(k, n, ["exp_avg", "exp_avg_sq"])
        sw.swap_out_param(k, state[k])
    trace = []
    sw.prefetch_param("a")
    for k, nxt in (("a", "b"), ("b", "c"), ("c", None)):
        out = {f: np.empty(sizes[k], np.float32) for f in ("exp_avg", "exp_avg_sq")}
        sw.fetch_param(k, out)
        if nxt:
            sw.prefetch_param(nxt)
        trace.append({f: out[f].tobytes() == state[k][f].tobytes() for f in out})
        sw.writeback_param(k, {f: v * 2 for f, v in out.items()})
    sw.prefetch_param("c")  # a mispredicted prefetch, drained by the next fetch
    out = {f: np.empty(sizes["a"], np.float32) for f in ("exp_avg", "exp_avg_sq")}
    sw.fetch_param("a", out)
    sw.drain_writes()
    trace.append((sorted(sw.buffers.free_buffer_index), sw.numel_alignment, sw.largest_numel, sw.swappable_tensor(17)))
    files = {f: open(os.path.join(sw.swap_folder, f), "rb").read() for f in sorted(os.listdir(sw.swap_folder))}
    return trace, files, out["exp_avg"].tobytes()


def test_partitioned_swapper_matches_jax(tmp_path):
    port = _pswap(partitioned_optimizer_swapper, AioConfig, str(tmp_path / "p"))
    ref = _pswap(jax_pswap, JaxAioConfig, str(tmp_path / "j"))
    assert port == ref
    assert all(all(t.values()) for t in port[0][:3])


# --- the allocator and the buckets -------------------------------------------------------
def _alloc_trace(mod):
    a = mod.ContiguousMemoryAllocator(64, np.float32)
    views, out = [], []
    for n in (10, 20, 8, 16):
        v = a.allocate_tensor(n)
        v[:] = len(views) + 1
        views.append(v)
    a.release_tensor(views[1])
    a.release_tensor(views[3])
    out.append((dict(a.contiguous_sizes), dict(a.tensor_addresses), a.available_memory))
    views.append(a.allocate_tensor(15))  # best fit: the 20-element hole
    views[-1][:] = 9
    a.release_tensor(views[0])
    out.append((dict(a.contiguous_sizes), dict(a.tensor_addresses)))
    big = a.allocate_tensor(28)  # no hole fits: defragment first
    big[:] = 7
    out.append((dict(a.contiguous_sizes), dict(a.tensor_addresses), dict(a.tensor_sizes), a.available_memory))
    buf = a.buffer.numpy() if hasattr(a.buffer, "numpy") else a.buffer
    out.append(buf.tolist())
    out.append([np.asarray(a.get_tensor(t)).tolist() for t in sorted(a.tensor_map)])
    with pytest.raises(RuntimeError):
        a.allocate_tensor(100)
    return out


def test_contiguous_memory_allocator_matches_jax():
    assert _alloc_trace(contiguous_memory_allocator) == _alloc_trace(jax_alloc)
    a = contiguous_memory_allocator.ContiguousMemoryAllocator(8, torch.bfloat16)
    assert a.buffer.dtype == torch.bfloat16 and a.buffer.device.type == "cpu"


@pytest.mark.parametrize("budget", [1, 7, 100, 10**9])
def test_split_offload_buckets_match_jax(budget):
    sizes = [5, 3, 50, 2, 2, 2, 90, 1]
    assert host_offload.split_offload_buckets(sizes, budget) == jax_host_offload.split_offload_buckets(sizes, budget)
    with pytest.raises(ValueError):
        host_offload.split_offload_buckets(sizes, 0)


@pytest.mark.parametrize("name", ["adagrad", "DeepSpeedCPUAdagrad", "DeepSpeedCPUAdam"])
def test_engine_builds_the_host_optimizer_types(name):
    """``adagrad`` and ``DeepSpeedCPUAdagrad`` train through the device
    ``DeepSpeedCPUAdagrad`` and ``DeepSpeedCPUAdam`` through ``FusedAdam``
    (JAX ``engine.py:118-125``): a step of the engine equals the optimizer
    applied by hand to its gradients."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.models.config import TransformerConfig
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops import DeepSpeedCPUAdagrad, FusedAdam

    kw = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2, max_seq_len=16, dtype="float32", remat=False)
    cfg = {"train_micro_batch_size_per_gpu": 2, "optimizer": {"type": name, "params": {"lr": 1e-2}}}
    engine = dst.initialize(model=TransformerLM(TransformerConfig(**kw)), config=cfg, device="cpu",
                            model_parameters=unflatten_tree(init_params(TransformerConfig(**kw), 0)))[0]
    assert type(engine.optimizer) is (FusedAdam if name == "DeepSpeedCPUAdam" else DeepSpeedCPUAdagrad)
    toks = np.random.RandomState(0).randint(0, 64, (2, 9))
    batch = {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}
    before = {k: torch.from_numpy(v.copy()) for k, v in flatten_tree(engine.get_master_params()).items()}
    state = engine.optimizer.init_state(before)
    loss = engine(batch)
    engine.backward(loss)
    grads = {k: g.clone() for k, g in engine._grad_acc.items()}
    engine.step()
    want, _ = engine.optimizer.apply(grads, state, before, 1e-2)
    got = flatten_tree(engine.get_master_params())
    assert all(np.array_equal(got[k], want[k].numpy()) for k in want)
