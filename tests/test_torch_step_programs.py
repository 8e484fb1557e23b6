"""The port's step programs against its own eager run, on the CPU.

* fused steps (``compile.fuse_grad_accum``, gas 2) and windows
  (``compile.multi_step``, horizon 2, over the fused body at gas 2 and the
  single step at gas 1) against sequential eager steps (the switches off)
  on the same data, bit for bit: losses, grad norms, lr, master, skips and
  loss scale, in fp32, bf16, fp16 with overflows inside the windows (the
  skip, the scale walk and the lr cursor), and remat with dropout;
* the window breaks (``checkpoint`` at an interval boundary inside the
  horizon, ``data`` at the end of the iterator), ``drained_losses`` and
  ``flush_loss_drain``;
* a ``train.mid_window`` kill, then a resume from the interval checkpoint
  bitwise the uninterrupted run;
* the mid-window guards;
* windows over the streamed host offload, bitwise its sequential run;
* the fused step at dp = 2 (two gloo ranks, stage 2): its body runs
  uncaptured, bitwise the eager step, and ``window_stats`` says so.

On the CPU the step programs run their bodies eagerly; on the card the
same bodies are captured as CUDA graphs (``tests/test_torch_card.py``,
``chip_smoke.py``). The JAX comparison is ``test_torch_fused_training.py``.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.utils import chaos
from torch_step_helpers import GPT2, STEPS
from torch_step_helpers import cfg as _cfg
from torch_step_helpers import data as _data
from torch_step_helpers import drive as _drive
from torch_step_helpers import master as _master
from torch_step_helpers import port as _port
from torch_step_helpers import same_master as _same_master


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- bitwise the port's own eager run -----------------------------------------------------
BITWISE = {
    "fp32": (GPT2, "fp32"),
    "bf16": (dict(GPT2, dtype="bfloat16"), "bf16"),
    "fp16 overflow": (dict(GPT2, dtype="float16"), "fp16"),
    "remat dropout": (dict(GPT2, remat=True, attn_dropout=0.1, hidden_dropout=0.1, flash_attention=False), "fp32"),
}


@pytest.mark.parametrize("case", sorted(BITWISE))
def test_fused_and_windows_bitwise_the_eager_run(case):
    """Sequential eager steps, fused steps (gas 2) and windows (gas 2 over
    the fused body, gas 1 over the single step) on the same data: losses,
    master, skips, loss scale and lr equal bit for bit."""
    model_kw, precision = BITWISE[case]
    for gas in (2, 1):
        data = _data(gas, STEPS, rows=4, seed=3)
        ref = _port(_cfg(gas, precision=precision, micro=4), model_kw)
        want = _drive(ref, data, STEPS)
        arms = [_port(_cfg(gas, fuse=gas > 1, multi_step=True, precision=precision, micro=4), model_kw)]
        if gas > 1:
            arms.append(_port(_cfg(gas, fuse=True, precision=precision, micro=4), model_kw))
        for e in arms:
            got = _drive(e, data, STEPS)
            np.testing.assert_array_equal(got, want)
            assert _same_master(e, ref), (case, gas)
            assert (e.skipped_steps, e.loss_scale, e.get_lr()) == (ref.skipped_steps, ref.loss_scale, ref.get_lr())
        if precision == "fp16":
            assert 0 < ref.skipped_steps < STEPS  # overflows inside the windows, and taken steps
    if "dropout" in case:  # the masks act: the same run without dropout differs
        plain = _port(_cfg(1, micro=4), dict(model_kw, attn_dropout=0.0, hidden_dropout=0.0))
        assert not np.array_equal(_drive(plain, data, STEPS)[:, 0], want[:, 0])


# --- breaks, drains, chaos, refusals ---------------------------------------------------------
def test_breaks_and_the_deferred_drain(tmp_path):
    """A checkpoint interval of 3 with horizon 2: a window at steps 1-2, a
    ``checkpoint`` break at step 3 (the boundary inside the horizon), a
    window at 4-5, a ``checkpoint`` break at 6; an iterator of 7 steps
    ends in a ``data`` break at 7. The drain
    lags one window until ``flush_loss_drain``; its values equal the
    returned losses."""
    cfg = _cfg(2, fuse=True, multi_step=True, micro=4,
               checkpoint={"interval_steps": 3, "save_dir": str(tmp_path)})
    e = _port(cfg)
    rec = _drive(e, _data(2, 7, rows=4), 7)
    st = e.window_stats()
    assert st["window_steps"] == 2 and st["windowed_opt_steps"] == 4
    assert st["window_break_reasons"] == {"checkpoint": 2, "monitor": 0, "data": 1, "profiler": 0}
    assert st["pending_loss_drains"] == 1 and st["stashed_steps"] == 0
    assert [d["step"] for d in e.drained_losses()] == [1, 2]
    e.flush_loss_drain()
    drained = e.drained_losses()
    assert [d["step"] for d in drained] == [1, 2, 4, 5]
    np.testing.assert_array_equal([d["loss"] for d in drained], rec[[0, 1, 3, 4], 0])
    np.testing.assert_array_equal([d["grad_norm"] for d in drained], rec[[0, 1, 3, 4], 1])
    assert not any(d["overflow"] for d in drained)
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("global_step")) == \
        ["global_step3", "global_step6"]
    e.load_checkpoint(str(tmp_path), tag="global_step6")  # the drained log belongs to the abandoned timeline
    assert e.drained_losses() == [] and e.window_stats()["pending_loss_drains"] == 0


def test_mid_window_kill_resumes_bitwise(tmp_path):
    """``train.mid_window`` fires after a window ran and before any of its
    steps is committed. A fresh engine resumes from the last interval
    checkpoint (window-aligned) and the continued run equals the
    uninterrupted one bit for bit, losses and master (fp16 with overflows,
    dropout, autosave every 2 steps)."""
    steps = 9
    model_kw = dict(GPT2, dtype="float16", attn_dropout=0.1, flash_attention=False)
    data = _data(1, steps, rows=4, seed=7)

    def build():
        cfg = _cfg(1, multi_step=True, precision="fp16", micro=4, scheduler=None,
                   checkpoint={"interval_steps": 2, "save_dir": str(tmp_path / "ckpt")})
        return _port(cfg, model_kw)

    ref = build()
    want = _drive(ref, data, steps)[:, 0]
    ref_master = _master(ref)
    shutil.rmtree(tmp_path / "ckpt")
    e = build()
    it = iter(list(data))
    committed = []
    chaos.install(chaos.ChaosSchedule([chaos.ChaosRule("train.mid_window", hit=2)]))
    try:
        with pytest.raises(chaos.ChaosKilled):
            for _ in range(steps):
                committed.append(float(e.train_batch(data_iter=it)))
    finally:
        chaos.uninstall()
    assert committed == list(want[:len(committed)]) and len(committed) == 2
    e2 = build()
    path, _ = e2.load_checkpoint(str(tmp_path / "ckpt"), auto_resume=True)
    assert path is not None and e2.global_steps == 2
    resumed = _drive(e2, data[2:], steps - 2)[:, 0]
    np.testing.assert_array_equal(resumed, want[2:])
    got = _master(e2)
    assert all(got[k].tobytes() == ref_master[k].tobytes() for k in ref_master)
    assert e2.skipped_steps == ref.skipped_steps and e2.loss_scale == ref.loss_scale


def test_mid_window_guards():
    """Mid-window the engine refuses what would read or write an
    uncommitted state: eval, forward, a batch argument, save, load and a
    resize."""
    e = _port(_cfg(1, multi_step=True, micro=4, horizon=3))
    it = iter(_data(1, 6, rows=4))
    e.train_batch(data_iter=it)
    assert e.window_stats()["stashed_steps"] == 2
    for call in (lambda: e.eval(), lambda: e(_data(1, 1, rows=4)[0]), lambda: e.train_batch(batch=_data(1, 1)[0]),
                 lambda: e.save_checkpoint("/nonexistent"), lambda: e.load_checkpoint("/nonexistent"),
                 lambda: e.set_train_batch_size(8)):
        with pytest.raises(RuntimeError, match="mid-window|mid-flight"):
            call()
    e.train_batch(data_iter=it)
    e.train_batch(data_iter=it)
    assert e.window_stats()["stashed_steps"] == 0 and e.global_steps == 3


def test_streamed_offload_windows_bitwise_its_sequential_run():
    """Windows over the streamed host offload (stage 1, ``pipeline_read``):
    the window gathers the host master and moments to the device, runs the
    same step body, and scatters them back; bitwise the streamed sequential
    run, in bf16, and the host state agrees after the run."""
    off = {"stage": 1, "offload_optimizer": {"device": "cpu", "pipeline_read": True}}
    model_kw = dict(GPT2, dtype="bfloat16")
    data = _data(2, STEPS, rows=4, seed=5)
    ref = _port(_cfg(2, fuse=True, precision="bf16", micro=4, zero_optimization=off), model_kw)
    want = _drive(ref, data, STEPS)
    e = _port(_cfg(2, fuse=True, multi_step=True, precision="bf16", micro=4, zero_optimization=off), model_kw)
    got = _drive(e, data, STEPS)
    np.testing.assert_array_equal(got, want)
    assert e.window_stats()["window_steps"] == 2
    assert _same_master(e, ref)
    hs, hr = e._host_offload, ref._host_offload
    assert hs.step_count == hr.step_count == STEPS
    for a, b in zip(hs.state_dict()["leaves"], hr.state_dict()["leaves"]):
        for f in ("master", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[f], b[f])


def test_fused_step_at_two_ranks_runs_uncaptured_bitwise_eager(tmp_path):
    from torch_rank_group import join_ranks, start_ranks
    from torch_step_helpers import rank_fused

    for res in join_ranks(start_ranks(rank_fused, 2, str(tmp_path)), limit_s=120):
        (eager, m_eager, _), (fused, m_fused, graphs) = res[False], res[True]
        np.testing.assert_array_equal(fused, eager)
        assert all(m_fused[k].tobytes() == m_eager[k].tobytes() for k in m_eager)
        assert graphs == {"captures": 0, "replays": 0, "warmups": 0, "uncaptured": 3}
