"""Tensor-parallel ragged serving (ROADMAP S9) against the JAX package's
``TPServing``, on the CPU: speculation, windows and int8 weights.

As ``test_torch_tp_serving.py`` (one gloo rank group at tp = 2 and one at
tp = 4, ``torch_tp_scenarios.py``; JAX's tiny TP config, fp32): greedy
streams byte-identical to JAX's TP streams and to the port's tp = 1
streams on every rank, ``serve_stats()`` counters equal to JAX's and the
step fingerprints equal across ranks, for

* speculative verify rows from a scripted drafter (0, 1 and 2 drafts a
  row in one step), resolved through the global argmax;
* windows of 4 decode rounds, which under tp run their rounds eagerly
  (no CUDA graph: ``serve_stats()["window_graph"]`` is False);
* int8 serving weights (quantized whole, then sliced codes and scales).
"""

from __future__ import annotations

import pytest

from torch_tp_scenarios import DEGREES, check_fingerprints, check_streams, collect, port_run

NAMES = ("spec", "windows", "int8")


def _rank_main(rank, world, tmp):  # noqa: ARG001
    return {name: port_run(name, world) for name in NAMES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return collect(_rank_main, NAMES, str(tmp_path_factory.mktemp("tp_spec_windows_int8")))


@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("scenario", NAMES)
def test_tp_streams_match_jax_and_single_rank(runs, scenario, degree):
    got = check_streams(runs, scenario, degree)
    if scenario == "spec":
        assert got["stats"]["spec_rounds"] >= 1, "the mix never drafted"
    if scenario == "windows":
        assert got["stats"]["window_steps"] >= 1 and not got["window_graph"]


@pytest.mark.parametrize("degree", DEGREES)
def test_tp_step_fingerprints_equal_across_ranks(runs, degree):
    check_fingerprints(runs, degree, NAMES)
