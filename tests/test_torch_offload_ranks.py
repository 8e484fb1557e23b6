"""The offload paths across two gloo ranks, against one rank on the same
global batch.

One rank group (``torch_rank_group.py``, two ranks) runs every scenario
while the parent runs the one-rank references. The model is the tiny GPT-2
of ``test_torch_training.py`` (T = 16), fp32, gas 2, clip 0.1; every rank
passes the global micro batch (8 rows) and takes its 4:

* streamed offload at stage 1 (the host buffers hold each rank's master
  slices): bitwise the dp = 2 on-device stage-1 run, and within 1e-5 of
  the one-rank streamed run (GEMMs over 4 rows round otherwise than over 8);
* legacy host-Adam offload at stage 2 (``cpu``, and ``nvme`` bitwise it):
  within 1e-5 of the one-rank legacy run;
* ``offload_param`` at stage 3 (each layer's gradient summed over the
  ranks before the host sums it): within 1e-5 of the one-rank run;
* a dp = 2 streamed tag (whole leaves, gathered) resumed at dp = 1 within
  1e-5 of the ranks' own continuation.
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
from torch_rank_group import join_ranks, start_ranks

DP, MICRO, T = 2, 4, 16
GPT2 = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2, max_seq_len=128, dtype="float32", remat=False)
FP32 = {"gradient_accumulation_steps": 2, "optimizer": {"type": "adam", "params": {"lr": 3e-4, "weight_decay": 0.01}},
        "gradient_clipping": 0.1, "steps_per_print": 10**6}
STREAMED = {"device": "cpu", "pipeline_read": True, "pipeline_write": True, "bucket_size": 20000}
STEPS, AT = 3, 2
SCENARIOS = {
    "streamed": {"stage": 1, "offload_optimizer": STREAMED},
    "on_device_1": {"stage": 1},
    "legacy": {"stage": 2, "offload_optimizer": {"device": "cpu"}},
    "legacy_nvme": {"stage": 2, "offload_optimizer": {"device": "nvme"}},
    "param": {"stage": 3, "offload_param": {"device": "cpu"}},
}


def _batches(n, rows, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rs.randint(0, GPT2["vocab_size"], (rows, T + 1)).astype(np.int32)
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _port(zero, dp, tmp=None):
    if tmp is not None and "offload_optimizer" in zero and zero["offload_optimizer"]["device"] == "nvme":
        zero = dict(zero, offload_optimizer=dict(zero["offload_optimizer"], nvme_path=tmp))
    cfg = dict(FP32, zero_optimization=zero, train_micro_batch_size_per_gpu=MICRO * DP // dp)
    return dst.initialize(model=TransformerLM(TransformerConfig(**GPT2)), config=cfg,
                          model_parameters=unflatten_tree(init_params(TransformerConfig(**GPT2), 0)), device="cpu")[0]


def _train(engine, batches):
    return [(engine.train_batch(batch=b), engine.get_global_grad_norm()) for b in batches]


def _master(engine):
    return {k: np.array(v) for k, v in flatten_tree(engine.get_master_params()).items()}


def _rank_main(rank, world, tmp):  # noqa: ARG001
    batches = _batches(STEPS, 2 * MICRO * DP)
    out = {}
    for name, zero in SCENARIOS.items():
        engine = _port(zero, DP, os.path.join(tmp, f"swap{rank}"))
        out[name] = (_train(engine, batches), _master(engine))
    engine = _port(SCENARIOS["streamed"], DP)
    _train(engine, batches[:AT])
    engine.save_checkpoint(os.path.join(tmp, "streamed_dp2"), tag="s")
    out["ckpt_continue"] = _train(engine, batches[AT:])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("offload_ranks"))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        handle = start_ranks(_rank_main, DP, os.path.join(tmp, "ranks"), tmp)
        batches = _batches(STEPS, 2 * MICRO * DP)
        one = {}
        for name in ("streamed", "legacy", "param"):
            engine = _port(SCENARIOS[name], 1)
            one[name] = (_train(engine, batches), _master(engine))
        ranks = join_ranks(handle)
        resumed = _port(SCENARIOS["streamed"], 1)
        resumed.load_checkpoint(os.path.join(tmp, "streamed_dp2"), tag="s", load_module_strict=False)
        one["resumed"] = _train(resumed, batches[AT:])
    finally:
        torch.set_num_threads(prev)
    return ranks, one


def _close(got, want, tol=1e-5):
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=tol)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=tol)


def _masters_close(got, want, tol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def test_streamed_at_two_ranks_is_on_device_bitwise(runs):
    ranks, _ = runs
    for r in ranks:
        assert r["streamed"][0] == r["on_device_1"][0]
        assert all(r["streamed"][1][k].tobytes() == r["on_device_1"][1][k].tobytes() for k in r["streamed"][1])
    assert ranks[0]["streamed"][0] == ranks[1]["streamed"][0]


@pytest.mark.parametrize("name", ["streamed", "legacy", "param"])
def test_offload_at_two_ranks_matches_one_rank(runs, name):
    ranks, one = runs
    for r in ranks:
        _close(r[name][0], one[name][0])
        _masters_close(r[name][1], one[name][1])
    assert all(ranks[0][name][1][k].tobytes() == ranks[1][name][1][k].tobytes() for k in ranks[0][name][1])


def test_legacy_nvme_at_two_ranks_is_bitwise_cpu(runs):
    ranks, _ = runs
    for r in ranks:
        assert r["legacy_nvme"][0] == r["legacy"][0]
        assert all(r["legacy_nvme"][1][k].tobytes() == r["legacy"][1][k].tobytes() for k in r["legacy"][1])


def test_streamed_dp2_tag_resumes_at_one_rank(runs):
    ranks, one = runs
    _close(one["resumed"], ranks[0]["ckpt_continue"])
