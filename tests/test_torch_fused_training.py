"""The port's step programs against the JAX engine's, on the CPU.

* ``compile.fuse_grad_accum`` at gas 2 with ``compile.multi_step`` (horizon
  2), and ``multi_step`` at gas 1: the JAX engine (8-device CPU mesh, micro
  1, so 8 rows a microbatch) against the port's (one rank, micro 8) over 5
  steps from one data iterator: each step's loss and grad norm, the lr the
  schedule reaches and the fp32 master within 1e-5, and ``window_stats``
  with JAX's keys (the port adds ``graphs``). JAX runs its first step
  sequentially (its state is built lazily at that step), so the two
  engines form their windows at other steps; windows equal sequential
  steps bit for bit in both packages, so the per-step values compare.
* the refusals of ``_validate_multi_step``, with JAX's messages.

The port's step programs against its own eager run, the breaks, the drain,
the ``train.mid_window`` kill and the streamed offload in windows are
``test_torch_step_programs.py``.

On the CPU the step programs run their bodies eagerly; on the card the
same bodies are captured as CUDA graphs (``tests/test_torch_card.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import config as jax_model_config
from torch_step_helpers import GPT2, STEPS
from torch_step_helpers import cfg as _cfg
from torch_step_helpers import data as _data
from torch_step_helpers import drive as _drive
from torch_step_helpers import master as _master
from torch_step_helpers import port as _port
from torch_step_helpers import tree as _tree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- against JAX ------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_runs():
    """Both JAX engines, built and driven once for the module."""
    tree = _tree()
    runs = {}
    for gas in (1, 2):
        cfg = _cfg(gas, fuse=gas > 1, multi_step=True, micro=1)
        je, *_ = ds.initialize(model=JaxLM(jax_model_config.TransformerConfig(**dict(GPT2, flash_attention=False))),
                               config=cfg, model_parameters=tree)
        rec = _drive(je, _data(gas, STEPS), STEPS)
        je.flush_loss_drain()
        runs[gas] = dict(rec=rec, master=_master(je), stats=je.window_stats(), drained=je.drained_losses(),
                         steps=je.global_steps, micro_steps=je.micro_steps)
    return runs


@pytest.mark.parametrize("gas", [1, 2])
def test_windows_and_fused_steps_match_jax(jax_runs, gas):
    ref = jax_runs[gas]
    pe = _port(_cfg(gas, fuse=gas > 1, multi_step=True))
    rec = _drive(pe, _data(gas, STEPS), STEPS)
    np.testing.assert_allclose(rec[:, 0], ref["rec"][:, 0], rtol=1e-5)
    np.testing.assert_allclose(rec[:, 1], ref["rec"][:, 1], rtol=1e-5)
    np.testing.assert_allclose(rec[:, 2], ref["rec"][:, 2], rtol=1e-7)  # the lr the schedule reached
    want = ref["master"]
    for k, v in _master(pe).items():
        assert np.abs(v - want[k]).max() <= 1e-5, k
    stats = pe.window_stats()
    assert set(stats) - {"graphs"} == set(ref["stats"])
    assert set(stats["window_break_reasons"]) == set(ref["stats"]["window_break_reasons"])
    # the port forms its windows at steps 1-2 and 3-4 (JAX at 2-3 and 4-5, after its lazy init step)
    assert stats["window_steps"] == ref["stats"]["window_steps"] == 2
    assert stats["dispatches_per_opt_step"] == ref["stats"]["dispatches_per_opt_step"] == 3 / STEPS
    assert stats["window_break_reasons"]["data"] == 1 and stats["graphs"]["uncaptured"] == 3 - (gas == 1)
    assert (pe.global_steps, pe.micro_steps) == (ref["steps"], ref["micro_steps"])
    pe.flush_loss_drain()
    got = {d["step"]: d for d in pe.drained_losses()}
    for d in ref["drained"]:
        if d["step"] in got:  # both packages drained this step from a window
            np.testing.assert_allclose(got[d["step"]]["loss"], d["loss"], rtol=1e-5)
            np.testing.assert_allclose(got[d["step"]]["grad_norm"], d["grad_norm"], rtol=1e-5)


REFUSED = {
    "gas without fuse": (ValueError, dict(gradient_accumulation_steps=2)),
    "curriculum": (ValueError, dict(curriculum_learning={"enabled": True})),
    "pld": (ValueError, dict(progressive_layer_drop={"enabled": True})),
    "random_ltd": (ValueError, dict(data_efficiency={"enabled": True, "data_routing": {
        "enabled": True, "random_ltd": {"enabled": True}}})),
    "offload_param": (ValueError, dict(zero_optimization={"stage": 3, "offload_param": {"device": "cpu"}})),
    "legacy host adam": (ValueError, dict(zero_optimization={"stage": 1, "offload_optimizer": {"device": "cpu"}})),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_multi_step_refusals_as_jax(case):
    err, over = REFUSED[case]
    with pytest.raises(err, match="multi_step"):
        _port(_cfg(1, multi_step=True, micro=4, **over))
