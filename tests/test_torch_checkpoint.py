"""Training checkpoints of the port: the atomic layout, the async writer and
bit-exact resume (port only; ``test_torch_checkpoint_interop.py`` holds
the files and the losses against the JAX package).

* resume: an engine that saves mid-run and a fresh engine that loads the
  checkpoint take the remaining steps with losses, grad norms, loss scales
  and fp32 masters bitwise equal to an uninterrupted run's: sync, async
  and interval saves; fp32, bf16, and fp16 with overflowing steps around
  the save; dropout on; gas 2; a warm-up lr. Also
  ``load_optimizer_states=False``, ``load_module_only`` and
  ``auto_resume`` on an empty directory;
* kills (``utils.chaos``) at each of ``ckpt.mid_array_write``,
  ``ckpt.pre_commit``, ``ckpt.mid_commit``, ``ckpt.post_commit`` and
  ``train.mid_step`` never expose a torn tag (the JAX package's
  ``TestCheckpointKills``), and a process that exits with 137 at
  ``ckpt.pre_commit`` resumes bitwise through ``auto_resume``;
* the async writer killed mid-flight: training goes on and the tag stays
  hidden; a persist error re-raises at the next fence; eight async saves
  back to back each commit their own step;
* torn layouts raise ``CheckpointCorruptError``; a checkpoint that does
  not fit (leaf shape, dtype, tree, mesh) raises ``CheckpointLoadError``
  naming the leaf.

Tiny shapes: 2 layers, hidden 32, T 16, micro batch 4, on the CPU.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree
from deepspeed_tpu_torch.models import TransformerLM
from deepspeed_tpu_torch.models import config as port_model_config
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.runtime.checkpoint_engine.atomic import (
    CheckpointCorruptError,
    CheckpointLoadError,
    find_latest_valid,
    list_valid_tags,
    read_latest_marker,
)
from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_checkpoint_engine import TorchCheckpointEngine
from deepspeed_tpu_torch.utils import chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, max_seq_len=32,
             attn_dropout=0.1, hidden_dropout=0.1)
DTYPES = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16"}
MICRO, T = 4, 16


@pytest.fixture(autouse=True)
def _one_thread_and_no_chaos():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    chaos.uninstall()


def _config(precision="fp32", gas=1, **over):
    cfg = {
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": gas,
        "optimizer": {"type": "adam", "params": {"lr": 1e-2, "weight_decay": 0.01}},
        "gradient_clipping": 1.0,
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-2, "warmup_num_steps": 4}},
        "seed": 7,
    }
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    if precision == "fp16":  # 2^20 overflows the first three steps (hysteresis 1), then fits
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 20, "hysteresis": 1}
    cfg.update(over)
    return cfg


def _engine(precision="fp32", gas=1, model=None, **over):
    kw = dict(model or MODEL, dtype=DTYPES[precision])
    tree = unflatten_tree(init_params(port_model_config.TransformerConfig(**kw), 0))
    engine, *_ = dst.initialize(model=TransformerLM(port_model_config.TransformerConfig(**kw)),
                                config=_config(precision, gas, **over), model_parameters=tree, device="cpu")
    return engine


def _batch(step, rows):
    """The batch of optimizer step ``step``: a resume at the wrong step
    trains on other tokens."""
    toks = np.random.RandomState(100 + step).randint(0, MODEL["vocab_size"], (rows, T + 1))
    return {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}


def _steps(engine, n):
    """``n`` optimizer steps; each record is the step's loss, grad norm and
    loss scale as float64 bytes (NaN and inf compare by their bits)."""
    gas = engine.gradient_accumulation_steps()
    out = []
    for _ in range(n):
        batch = _batch(engine.global_steps, MICRO * gas)
        if gas == 1:
            loss = engine(batch)
            engine.backward(loss)
            engine.step()
            loss = float(loss.detach())
        else:
            loss = engine.train_batch(batch=batch)
        out.append(np.array([loss, engine.get_global_grad_norm(), engine.loss_scale]).tobytes())
    return out


def _masters_equal(a, b):
    ma, mb = flatten_tree(a.get_master_params()), flatten_tree(b.get_master_params())
    assert set(ma) == set(mb)
    return all(np.array_equal(ma[k], mb[k]) for k in ma)


def _assert_resumes(engine, ref_records, ref_engine, first_step):
    """``engine`` (just loaded at ``first_step``) takes the rest of the
    reference's steps bit for bit."""
    assert engine.global_steps == first_step
    got = _steps(engine, len(ref_records) - first_step)
    assert got == ref_records[first_step:]
    assert engine.micro_steps == ref_engine.micro_steps and engine.global_samples == ref_engine.global_samples
    assert engine.skipped_steps == ref_engine.skipped_steps and engine.get_lr() == ref_engine.get_lr()
    assert _masters_equal(engine, ref_engine)
    assert np.array_equal(flatten_tree(engine.get_params())["embed/tokens"],
                          flatten_tree(ref_engine.get_params())["embed/tokens"])


# --- bit-exact resume ------------------------------------------------------------------------
RESUME = {  # name: (precision, gas, save after step, how)
    "fp32-sync": ("fp32", 1, 3, "sync"),
    "bf16-async": ("bf16", 1, 3, "async"),
    "fp16-overflow-sync": ("fp16", 1, 2, "sync"),  # saved between two overflowing steps
    "fp16-overflow-async": ("fp16", 1, 2, "async"),
    "fp32-interval-gas2": ("fp32", 2, 4, "interval"),
    "bf16-interval-async-gas2": ("bf16", 2, 4, "interval-async"),
}


@pytest.mark.parametrize("name", sorted(RESUME))
def test_resume_is_bit_identical(tmp_path, name):
    precision, gas, at, how = RESUME[name]
    ref = _engine(precision, gas)
    ref_records = _steps(ref, 6)
    save_dir = str(tmp_path)
    if how.startswith("interval"):  # saves itself every 2 steps; stopped after step 5
        ckpt = {"interval_steps": 2, "save_dir": save_dir, "async_snapshot": how == "interval-async"}
        a = _engine(precision, gas, checkpoint=ckpt)
        assert _steps(a, 5) == ref_records[:5]
        a.wait_pending_checkpoint()
        assert find_latest_valid(save_dir) == "global_step4" and a.checkpoint_stats()["saves"] == 2
    else:
        a = _engine(precision, gas)
        assert _steps(a, at) == ref_records[:at]
        a.save_checkpoint(save_dir, client_state={"epoch": 1}, asynchronous=how == "async")
        # the engine updates its tensors in place: an async snapshot holding
        # references would be overwritten by these steps before it is written
        assert _steps(a, 6 - at) == ref_records[at:]
        a.wait_pending_checkpoint()
        assert a.checkpoint_stats()["async_saves"] == (how == "async")
    b = _engine(precision, gas)
    path, client = b.load_checkpoint(save_dir, auto_resume=True)
    assert path == os.path.join(save_dir, f"global_step{at}")
    assert client == ({} if how.startswith("interval") else {"epoch": 1})
    assert b.checkpoint_stats()["last_restore_s"] > 0
    _assert_resumes(b, ref_records, ref, at)


def test_load_variants(tmp_path):
    """``load_optimizer_states=False`` keeps the fresh moments and takes
    everything else; ``load_module_only`` takes the weights alone (fp32:
    the module is the master); a directory with nothing valid, or without
    ``latest``, loads nothing."""
    a = _engine("fp32")
    _steps(a, 3)
    a.save_checkpoint(str(tmp_path))
    b = _engine("fp32")
    b.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert b.global_steps == 3 and b._opt_state.step == 0
    assert all(float(m.abs().max()) == 0 for m in b._opt_state.exp_avg.values())
    assert _masters_equal(a, b) and b.get_lr() == a.get_lr()
    c = _engine("fp32")
    c.load_checkpoint(str(tmp_path), tag="global_step3", load_module_only=True)
    assert c.global_steps == 0 and c.micro_steps == 0 and c._opt_state.step == 0
    assert _masters_equal(a, c)
    empty = tmp_path / "empty"
    assert c.load_checkpoint(str(empty), auto_resume=True) == (None, {})
    empty.mkdir()
    assert c.load_checkpoint(str(empty), auto_resume=True) == (None, {})
    assert c.load_checkpoint(str(empty)) == (None, {})


def test_bf16_module_only_takes_module_and_master(tmp_path):
    """A bf16 module-only load takes the compute weights and the fp32
    master, as JAX's does, and leaves the counters and moments fresh."""
    a = _engine("bf16")
    _steps(a, 2)
    a.save_checkpoint(str(tmp_path))
    b = _engine("bf16")
    b.load_checkpoint(str(tmp_path), load_module_only=True)
    pa, pb = flatten_tree(a.get_params()), flatten_tree(b.get_params())
    assert all(np.array_equal(pa[k], pb[k]) for k in pa) and _masters_equal(a, b)
    assert b.global_steps == 0 and b._opt_state.step == 0


# --- kills at the chaos points -----------------------------------------------------------
KILLS = ["ckpt.mid_array_write", "ckpt.pre_commit", "ckpt.post_commit", "ckpt.mid_commit", "train.mid_step"]


@pytest.mark.parametrize("point", KILLS)
def test_kill_never_exposes_a_torn_checkpoint(tmp_path, point):
    """A save of step 2 killed at each checkpoint point leaves step 1's
    checkpoint discoverable (step 2's after ``post_commit``, though
    ``latest`` still names step 1); ``mid_commit`` kills a re-save of the
    same tag, whose moved-aside directory discovery restores. A kill inside
    step 2 (``train.mid_step``) leaves step 1's. The resumed run is the
    uninterrupted one, bit for bit."""
    save_dir = str(tmp_path)
    ref = _engine()
    ref_records = _steps(ref, 4)
    a = _engine()
    _steps(a, 1)
    a.save_checkpoint(save_dir, tag="best" if point == "ckpt.mid_commit" else None)
    chaos.install(chaos.ChaosSchedule([chaos.ChaosRule(point)]))
    with pytest.raises(chaos.ChaosKilled):
        if point == "train.mid_step":
            _steps(a, 1)
        else:
            _steps(a, 1)
            a.save_checkpoint(save_dir, tag="best" if point == "ckpt.mid_commit" else None)
    chaos.uninstall()
    want = {"ckpt.post_commit": "global_step2", "ckpt.mid_commit": "best"}.get(point, "global_step1")
    assert find_latest_valid(save_dir) == want
    assert read_latest_marker(save_dir) == ("best" if point == "ckpt.mid_commit" else "global_step1")
    b = _engine()
    path, _ = b.load_checkpoint(save_dir, auto_resume=True)
    assert path.endswith(want)
    at = 2 if want == "global_step2" else 1
    _assert_resumes(b, ref_records, ref, at)
    if point == "ckpt.pre_commit":  # the next save of the tag reclaims the staging garbage
        b.save_checkpoint(save_dir, tag="global_step2")
        assert not [n for n in os.listdir(save_dir) if ".staging" in n]


_KILLED_RUN = r"""
import sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import test_torch_checkpoint as t
from deepspeed_tpu_torch.utils import chaos
a = t._engine()
t._steps(a, 2)
a.save_checkpoint({save_dir!r})
t._steps(a, 1)
chaos.install(chaos.ChaosSchedule([chaos.ChaosRule("ckpt.pre_commit", action="exit")]))
a.save_checkpoint({save_dir!r})
print("not killed")
"""


def test_process_killed_at_pre_commit_resumes(tmp_path):
    """A process exits (137, ``os._exit``) inside its second save; a new
    engine resumes from the first through ``auto_resume``, bitwise."""
    save_dir = str(tmp_path / "ckpt")
    script = _KILLED_RUN.format(repo=REPO, tests=os.path.dirname(os.path.abspath(__file__)), save_dir=save_dir)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 137, proc.stderr[-2000:]
    assert "not killed" not in proc.stdout
    assert [n for n in os.listdir(save_dir) if n.endswith(".staging")] == ["global_step3.staging"]
    ref = _engine()
    ref_records = _steps(ref, 5)
    b = _engine()
    path, _ = b.load_checkpoint(save_dir, auto_resume=True)
    assert path.endswith("global_step2")
    _assert_resumes(b, ref_records, ref, 2)


# --- the async writer ----------------------------------------------------------------------
def test_async_writer_killed_mid_flight_and_persist_error(tmp_path, monkeypatch):
    """A kill in the writer thread (``ckpt.mid_array_write``) loses that
    write only: training goes on, the tag never appears, and the next async
    save commits. A persist error (an ``OSError``) re-raises at the next
    ``wait_pending_checkpoint``."""
    save_dir = str(tmp_path)
    a = _engine("bf16", checkpoint={"async_snapshot": True, "max_inflight_snapshots": 1})
    _steps(a, 1)
    chaos.install(chaos.ChaosSchedule([chaos.ChaosRule("ckpt.mid_array_write")]))
    a.save_checkpoint(save_dir)
    _steps(a, 1)  # training goes on while (and after) the writer dies
    a.wait_pending_checkpoint()
    chaos.uninstall()
    assert find_latest_valid(save_dir) is None and read_latest_marker(save_dir) is None
    a.save_checkpoint(save_dir)
    a.wait_pending_checkpoint()
    assert find_latest_valid(save_dir) == "global_step2" and read_latest_marker(save_dir) == "global_step2"
    stats = a.checkpoint_stats()
    assert stats["async_snapshot"] is True and stats["pending"] == 0 and stats["async_saves"] == 2
    assert set(stats) == {"saves", "async_saves", "last_stall_ms", "total_stall_ms", "last_save_s",
                          "last_restore_s", "async_snapshot", "pending"}

    def broken(state, path):  # noqa: ARG001
        raise OSError("disk full")

    monkeypatch.setattr(a.checkpoint_engine, "save", broken)
    _steps(a, 1)
    a.save_checkpoint(save_dir)
    with pytest.raises(RuntimeError, match="disk full"):
        a.wait_pending_checkpoint()
    assert find_latest_valid(save_dir) == "global_step2"


def test_async_saves_back_to_back(tmp_path):
    """Eight async saves, one a step, through a queue of two with a tiny
    thread switch interval: every tag commits, ``latest`` names the last,
    and each checkpoint holds its own step's weights."""
    save_dir = str(tmp_path)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        a = _engine(checkpoint={"async_snapshot": True, "max_inflight_snapshots": 2})
        masters = {}
        for _ in range(8):
            _steps(a, 1)
            masters[a.global_steps] = {k: v.copy() for k, v in flatten_tree(a.get_master_params()).items()}
            a.save_checkpoint(save_dir)
        a.wait_pending_checkpoint()
    finally:
        sys.setswitchinterval(old)
    assert list_valid_tags(save_dir) == [f"global_step{i}" for i in range(1, 9)]
    assert read_latest_marker(save_dir) == "global_step8" and a.checkpoint_stats()["pending"] == 0
    for step, master in masters.items():
        module = flatten_tree(TorchCheckpointEngine().load(os.path.join(save_dir, f"global_step{step}"))["module"])
        assert all(np.array_equal(module[k].numpy(), v) for k, v in master.items()), step


# --- torn layouts and mismatches -----------------------------------------------------------
def _saved(tmp_path, precision="fp32", steps=1):
    a = _engine(precision)
    _steps(a, steps)
    a.save_checkpoint(str(tmp_path))
    return os.path.join(str(tmp_path), f"global_step{steps}")


def test_torn_layouts_raise_corrupt(tmp_path):
    """Each torn layout raises ``CheckpointCorruptError`` naming its cause;
    ``auto_resume`` falls back past a torn newest tag."""
    eng = TorchCheckpointEngine()
    with pytest.raises(CheckpointCorruptError, match="no checkpoint"):
        eng.load(str(tmp_path / "never"))
    (tmp_path / "global_step9").mkdir()
    with pytest.raises(CheckpointCorruptError, match="meta.pkl is missing"):
        eng.load(str(tmp_path / "global_step9"))
    shutil.rmtree(tmp_path / "global_step9")
    path = _saved(tmp_path, steps=1)
    b = _engine()
    _steps(b, 2)
    b.save_checkpoint(str(tmp_path))
    newest = os.path.join(str(tmp_path), "global_step2")
    arrays = os.path.join(newest, "arrays.pt")
    blob = open(arrays, "rb").read()
    cases = {
        "unreadable": lambda: open(arrays, "wb").write(blob[: len(blob) // 2]),
        "missing": lambda: os.remove(arrays),
        "lacks": lambda: torch.save({"root/module/lm_head": torch.zeros(1)}, arrays),
    }
    for match, tear in cases.items():
        tear()
        with pytest.raises(CheckpointCorruptError, match=match):
            eng.load(newest)
        c = _engine()
        with pytest.raises(CheckpointCorruptError, match=match):
            c.load_checkpoint(str(tmp_path), tag="global_step2")
        assert c.load_checkpoint(str(tmp_path), auto_resume=True)[0] == path and c.global_steps == 1
        open(arrays, "wb").write(blob)
    os.makedirs(os.path.join(newest, "arrays"))  # orbax's payload, as the JAX package writes it
    os.remove(arrays)
    with pytest.raises(CheckpointCorruptError, match="written by the JAX package"):
        eng.load(newest)
    with open(os.path.join(path, "meta.pkl"), "wb") as f:
        f.write(b"\x80garbage")
    with pytest.raises(CheckpointCorruptError, match="meta.pkl is unreadable"):
        eng.load(path)


def test_save_is_staged_until_commit(tmp_path):
    eng = TorchCheckpointEngine()
    final = str(tmp_path / "tagA")
    eng.save({"module": {"w": torch.arange(4.0)}, "step": 1, "seq": (1, [2.0, torch.ones(2)])}, final)
    assert not os.path.exists(final) and os.path.isfile(final + ".staging/_COMPLETE")
    eng.commit("tagA")
    assert os.path.isfile(os.path.join(final, "_COMPLETE")) and not os.path.exists(final + ".staging")
    got = eng.load(final)
    assert torch.equal(got["module"]["w"], torch.arange(4.0)) and got["step"] == 1
    assert got["seq"][0] == 1 and got["seq"][1][0] == 2.0 and torch.equal(got["seq"][1][1], torch.ones(2))
    with open(os.path.join(final, "meta.pkl"), "rb") as f:
        skel = pickle.load(f)["skeleton"]
    assert skel["module"]["w"] == {"__array_ref__": "root/module/w"}
    assert skel["seq"]["__seq__"] == "tuple" and skel["step"] == {"__meta_ref__": "root/step"}


MISMATCH = {  # name: (engine that loads, error pattern)
    "shape": (dict(MODEL, hidden_size=64), r"shape mismatch .* leaf 'embed/pos': checkpoint has \(32, 32\), "
                                           r"current state has \(32, 64\)"),
    "dtype": ("bf16", r"dtype mismatch .* leaf 'embed/pos': checkpoint has torch.float32, current state has "
                      r"torch.bfloat16"),
    "tree": (dict(MODEL, use_bias=False), r"module tree mismatch .* checkpoint has unknown \['layers/b_in', 'layers/b_out'"),
    "mesh": ("mesh", r"mesh topology mismatch .* \{'data': 2\} but this run uses \{'data': 1\}"),
}


@pytest.mark.parametrize("name", sorted(MISMATCH))
def test_mismatch_raises_load_error_naming_the_leaf(tmp_path, name):
    path = _saved(tmp_path)
    what, pattern = MISMATCH[name]
    if what == "mesh":
        with open(os.path.join(path, "meta.pkl"), "rb") as f:
            blob = pickle.load(f)
        blob["meta"]["root/mesh/data"] = 2
        with open(os.path.join(path, "meta.pkl"), "wb") as f:
            pickle.dump(blob, f)
        b = _engine()
    elif what == "bf16":
        b = _engine("bf16")
    else:
        b = _engine(model=what)
    with pytest.raises(CheckpointLoadError, match=pattern):
        b.load_checkpoint(str(tmp_path), auto_resume=True)
