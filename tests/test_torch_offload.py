"""Optimizer offload (ZeRO-Offload, ZeRO-Infinity streamed) against the
port's on-device engine and the JAX package's offload engines.

The model is the tiny GPT-2 of ``test_torch_training.py`` (2 layers,
hidden 64, T = 16, micro 8), fp32 unless a case says otherwise.

* streamed (``pipeline_read``/``pipeline_write``, small buckets so a step
  streams several): bitwise the port's on-device engine of the same stage
  (losses, grad norms, master) at stages 1 and 3 x fp32 / bf16 / fp16 (one
  overflow step, skipped alike) x gas 1 / 2;
* the port's streamed and legacy engines against JAX's (one device, micro
  8) over 4 steps within 1e-5; the legacy ``nvme`` arm bitwise the ``cpu``
  arm (the swap moves bytes only);
* checkpoints across the packages (``torch_ckpt_convert``): a JAX tag of
  each layout loaded by the port, and a port tag loaded by the JAX engine,
  each resumed within 1e-5 of the other package's run; ``zero_to_fp32``
  and the universal export of the legacy layout equal JAX's;
* a ``train.mid_offload_stream`` kill, then a fresh engine resumed from the
  last tag: bitwise the uninterrupted run; each format refusing the
  other's (JAX's ``ValueError``s and ``NotImplementedError``).

The two JAX engines are built and run in one module fixture (the suite
resets the JAX topology after every test).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree
from deepspeed_tpu_torch.models import TransformerLM
from deepspeed_tpu_torch.models.config import TransformerConfig
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.utils import chaos
from torch_ckpt_convert import jax_tag_to_port, port_tag_to_jax

GPT2 = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2, max_seq_len=128, dtype="float32", remat=False)
LR = 3e-4
BASE = {"train_micro_batch_size_per_gpu": 8, "optimizer": {"type": "adam", "params": {"lr": LR, "weight_decay": 0.01}},
        "gradient_clipping": 0.1, "steps_per_print": 10**6}
STREAMED = {"device": "cpu", "pipeline_read": True, "pipeline_write": True, "bucket_size": 20000}
STEPS, AT = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(model_kw=GPT2):
    return unflatten_tree(init_params(TransformerConfig(**model_kw), 0))


def _batches(n, rows=8, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rs.randint(0, GPT2["vocab_size"], (rows, 17)).astype(np.int32)
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _port(zero, dtype="float32", extra=None, gas=1):
    model_kw = dict(GPT2, dtype=dtype)
    cfg = dict(BASE, zero_optimization=zero, gradient_accumulation_steps=gas, **(extra or {}))
    if dtype == "bfloat16":
        cfg["bf16"] = {"enabled": True}
    return dst.initialize(model=TransformerLM(TransformerConfig(**model_kw)), config=cfg,
                          model_parameters=_tree(model_kw), device="cpu")[0]


def _train(engine, batches):
    return [(engine.train_batch(batch=b), engine.get_global_grad_norm()) for b in batches]


def _master(engine):
    return flatten_tree(engine.get_master_params())


def _jax_engine(zero):
    """JAX's engine on one CPU device at micro 8 (one shard record a leaf,
    as the port writes), flash attention off (the Pallas interpret mode
    costs too much here)."""
    import jax

    import deepspeed_tpu as ds
    from deepspeed_tpu.models import TransformerLM as JaxLM
    from deepspeed_tpu.models import config as jax_model_config
    from deepspeed_tpu.parallel import mesh as mesh_mod
    from deepspeed_tpu.runtime.config import MeshConfig

    mesh_mod.initialize_topology(MeshConfig(data=1), devices=jax.devices()[:1])
    jm = JaxLM(jax_model_config.TransformerConfig(**dict(GPT2, flash_attention=False)))
    return ds.initialize(model=jm, config=dict(BASE, zero_optimization=zero, mesh={"data": 1}),
                         model_parameters=_tree())[0]


def _jax_master(engine):
    import jax

    return flatten_tree(jax.tree_util.tree_map(np.asarray, engine.get_master_params()))


def _jax_mesh(engine):
    return dict(zip(engine.mesh.axis_names, map(int, engine.mesh.devices.shape)))


ARMS = {"streamed": {"stage": 1, "offload_optimizer": STREAMED},
        "legacy": {"stage": 2, "offload_optimizer": {"device": "cpu"}}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per arm: JAX's 4 steps with a save after step 2, the port's 4 steps
    with a save after step 2, each package resumed from the other's tag."""
    from deepspeed_tpu.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint as jax_fp32
    from deepspeed_tpu.checkpoint import deepspeed_checkpoint as jax_universal
    from deepspeed_tpu_torch.checkpoint import deepspeed_checkpoint as port_universal
    from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

    tmp = str(tmp_path_factory.mktemp("offload"))
    batches = _batches(STEPS)
    out = {}
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arm, zero in ARMS.items():
            d = os.path.join(tmp, arm)
            je = _jax_engine(zero)
            jrec = _train(je, batches[:AT])
            je.save_checkpoint(os.path.join(d, "jax"), tag="j")
            jrec += _train(je, batches[AT:])
            jmaster = _jax_master(je)
            pe = _port(zero)
            prec = _train(pe, batches[:AT])
            pe.save_checkpoint(os.path.join(d, "port"), tag="p")
            prec += _train(pe, batches[AT:])
            pmaster = _master(pe)
            # the port resumes JAX's tag; JAX resumes the port's
            jax_tag_to_port(os.path.join(d, "jax"), "j", os.path.join(d, "j2p"), mesh={"data": 1})
            p2 = _port(zero)
            p2.load_checkpoint(os.path.join(d, "j2p"), tag="j")
            p_from_j = _train(p2, batches[AT:])
            port_tag_to_jax(os.path.join(d, "port"), "p", os.path.join(d, "p2j"), mesh=_jax_mesh(je))
            je.load_checkpoint(os.path.join(d, "p2j"), tag="p")
            j_from_p = _train(je, batches[AT:])
            rec = dict(jax=np.array(jrec), port=np.array(prec), jmaster=jmaster, pmaster=pmaster,
                       p_from_j=np.array(p_from_j), p_from_j_master=_master(p2), j_from_p=np.array(j_from_p),
                       j_from_p_master=_jax_master(je), tags=d)
            if arm == "legacy":
                rec["fp32"] = (get_fp32_state_dict_from_zero_checkpoint(os.path.join(d, "port"), "p"),
                               jax_fp32(os.path.join(d, "p2j"), "p"),
                               get_fp32_state_dict_from_zero_checkpoint(os.path.join(d, "j2p"), "j"),
                               jax_fp32(os.path.join(d, "jax"), "j"))
                port_universal.convert_to_universal(os.path.join(d, "port"), os.path.join(d, "pu"), tag="p")
                jax_universal.convert_to_universal(os.path.join(d, "p2j"), os.path.join(d, "ju"), tag="p")
                rec["universal"] = (dict(np.load(os.path.join(d, "pu", port_universal.ZERO_FILE))),
                                    dict(np.load(os.path.join(d, "ju", jax_universal.ZERO_FILE))))
            out[arm] = rec
            del je
    finally:
        torch.set_num_threads(prev)
    return out


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=tol)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=tol)


def _masters_close(got, want, tol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_offload_matches_jax(runs, arm):
    """Losses and grad norms within 1e-5 relative, the master within 1e-5,
    over 4 steps (the clip of 0.1 engaged)."""
    r = runs[arm]
    assert (r["jax"][:, 1] > 0.1).all()
    _close(r["port"], r["jax"])
    _masters_close(r["pmaster"], r["jmaster"])


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_checkpoints_cross_load_with_jax(runs, arm):
    """A JAX tag resumed by the port and a port tag resumed by JAX each
    continue within 1e-5 of the other package's uninterrupted run."""
    r = runs[arm]
    _close(r["p_from_j"], r["jax"][AT:])
    _masters_close(r["p_from_j_master"], r["jmaster"])
    _close(r["j_from_p"], r["port"][AT:])
    _masters_close(r["j_from_p_master"], r["pmaster"])


def test_legacy_zero_to_fp32_and_universal_equal_jax(runs):
    port_p, jax_p, port_j, jax_j = runs["legacy"]["fp32"]
    for got, want in ((port_p, jax_p), (port_j, jax_j)):
        assert list(got) == list(want)
        for k in want:
            assert got[k].tobytes() == np.asarray(want[k], np.float32).tobytes(), k
    pu, ju = runs["legacy"]["universal"]
    assert sorted(pu) == sorted(ju)
    for k in ju:
        np.testing.assert_array_equal(pu[k], ju[k], err_msg=k)


# --- streamed = on-device, bit for bit ------------------------------------------------
FP16 = {"fp16": {"enabled": True, "initial_scale_power": 19, "hysteresis": 1}}
BITWISE = {f"stage{st}-{dt}-gas{gas}": (st, dt, gas) for st in (1, 3) for dt in ("fp32", "bf16", "fp16")
           for gas in (1, 2)}


@pytest.mark.parametrize("case", sorted(BITWISE))
def test_streamed_bitwise_on_device(case):
    """3 steps: losses, grad norms, master and loss scale bitwise the
    on-device engine's; under fp16 the first step overflows and both
    skip it."""
    stage, dt, gas = BITWISE[case]
    dtype = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16"}[dt]
    extra = FP16 if dt == "fp16" else None
    batches = _batches(3, rows=8 * gas)
    ref = _port({"stage": stage}, dtype, extra, gas)
    off = _port({"stage": stage, "offload_optimizer": STREAMED}, dtype, extra, gas)
    assert off.offload_stream_stats()["buckets"] > 2 and ref.offload_stream_stats() is None
    a, b = _train(ref, batches), _train(off, batches)
    assert a == b
    assert off.skipped_steps == ref.skipped_steps == (1 if dt == "fp16" else 0)
    assert off.loss_scale == ref.loss_scale
    ma, mb = _master(ref), _master(off)
    assert all(ma[k].tobytes() == mb[k].tobytes() for k in ma)
    pa, pb = flatten_tree(ref.get_params()), flatten_tree(off.get_params())
    assert all(pa[k].tobytes() == pb[k].tobytes() for k in pa)
    stats = off.offload_stream_stats()
    assert stats["steps"] == 3 and stats["pending_writes"] <= 1
    mem = off._host_offload.memory_report()
    assert mem["master_location"] == "host" and mem["host_bytes"] == 12 * off.num_parameters()


def test_streamed_schedule_and_one_bucket():
    """The declared schedule (JAX's names and bytes), and a single bucket,
    whose deferred writeback lands before the next step's upload."""
    e = _port({"stage": 1, "offload_optimizer": dict(STREAMED, bucket_size=10**9)})
    ref = _port({"stage": 1})
    b = _batches(3)
    assert _train(e, b) == _train(ref, b)
    sched = e._host_offload.stream_schedule()
    assert [t["name"] for t in sched["transfers"]] == ["h2d_b0", "d2h_b0"]
    assert sched["transfers"][0]["bytes"] == 8 * e.num_parameters()  # fp32: the moments only go up
    assert sched["transfers"][1]["hide_behind"] == "fwd_bwd"
    with pytest.raises(ValueError, match="buffer_count"):
        _port({"stage": 1, "offload_optimizer": dict(STREAMED, buffer_count=1)})


def test_legacy_nvme_is_bitwise_cpu(tmp_path):
    batches = _batches(3)
    cpu = _port({"stage": 2, "offload_optimizer": {"device": "cpu"}})
    nvme = _port({"stage": 2, "offload_optimizer": {"device": "nvme", "nvme_path": str(tmp_path)}})
    assert _train(cpu, batches) == _train(nvme, batches)
    a, b = _master(cpu), _master(nvme)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    swap = os.path.join(str(tmp_path), "ds_tpu_swap", "zero_stage_3", "optimizer", "rank0")
    assert len(os.listdir(swap)) == 2 * len(a)  # exp_avg and exp_avg_sq, one file each a leaf
    assert nvme._host_offload.swapper is not None and set(nvme._host_offload.timing()) == {
        "adam_ms", "swap_read_ms", "swap_write_ms"}


def test_mid_offload_stream_kill_resumes_bitwise(tmp_path):
    """A kill inside the stream (bucket 1 of step 3) leaves the host state
    torn; a fresh engine resumes from the step-2 tag, bit for bit the
    uninterrupted run."""
    zero = {"stage": 1, "offload_optimizer": STREAMED}
    batches = _batches(STEPS)
    whole = _port(zero)
    want = _train(whole, batches)
    e = _port(zero)
    _train(e, batches[:AT])
    e.save_checkpoint(str(tmp_path), tag="two")
    chaos.install(chaos.ChaosSchedule([chaos.ChaosRule("train.mid_offload_stream", 2)]))
    try:
        with pytest.raises(chaos.ChaosKilled):
            _train(e, batches[AT:])
    finally:
        chaos.uninstall()
    fresh = _port(zero)
    fresh.load_checkpoint(str(tmp_path), auto_resume=True)
    assert _train(fresh, batches[AT:]) == want[AT:]
    a, b = _master(whole), _master(fresh)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)


def test_formats_refuse_each_other(runs):
    tags = runs["streamed"]["tags"], runs["legacy"]["tags"]
    streamed = _port(ARMS["streamed"])
    with pytest.raises(ValueError, match="legacy per-shard"):
        streamed.load_checkpoint(os.path.join(tags[1], "port"), tag="p")
    legacy = _port(ARMS["legacy"])
    with pytest.raises(ValueError, match="STREAMED"):
        legacy.load_checkpoint(os.path.join(tags[0], "port"), tag="p")
    with pytest.raises(ValueError, match="streamed-format"):
        legacy.load_checkpoint(os.path.join(tags[0], "port"), tag="p", load_optimizer_states=False)
    plain = _port({"stage": 1})
    with pytest.raises(NotImplementedError, match="host_offload offload engine"):
        plain.load_checkpoint(os.path.join(tags[0], "port"), tag="p")
    # module and master only: the non-offload engine adopts the offload tag's module
    plain.load_checkpoint(os.path.join(tags[1], "port"), tag="p", load_optimizer_states=False)
    # a non-offload tag: the offload engine adopts its master with fresh moments
    plain.save_checkpoint(os.path.join(tags[1], "plain"), tag="q")
    legacy.load_checkpoint(os.path.join(tags[1], "plain"), tag="q", load_optimizer_states=False)
    a, b = _master(plain), _master(legacy)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    with pytest.raises(ValueError, match="stage >= 1"):
        _port({"stage": 0, "offload_optimizer": {"device": "cpu"}})
    with pytest.raises(ValueError, match="unsupported"):
        dst.initialize(model=TransformerLM(TransformerConfig(**GPT2)), model_parameters=_tree(), device="cpu",
                       config=dict(BASE, optimizer={"type": "adagrad", "params": {"lr": 1e-2}},
                                   zero_optimization=ARMS["legacy"]))
