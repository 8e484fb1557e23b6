"""Offline dataset analysis for curriculum / data-efficiency sampling.

Counterpart of the reference's ``DataAnalyzer``
(``deepspeed/runtime/data_pipeline/data_sampling/data_analyzer.py``): a
map-reduce over the dataset computing per-sample difficulty metrics. The
map phase shards samples across workers, each writing per-metric index
files; the reduce phase merges them into the two lookup tables the
curriculum sampler consumes:

* ``<metric>_sample_to_metric`` — metric value per sample index;
* ``<metric>_metric_to_sample`` — sample indices grouped per metric value
  (an ``MMapIndexedDataset``: one "sequence" of sample ids per value).

Metric types, as in the reference: ``single_value_per_sample`` (one number
per sample, e.g. seqlen) and ``accumulate_value_over_samples`` (one running
total, e.g. token histogram).

The port's own copy of
``deepspeed_tpu/runtime/data_pipeline/data_sampling/data_analyzer.py``
(the port imports nothing of the JAX package): the same names, the
same numbers, the same bytes on disk.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.indexed_dataset import (
    MMapIndexedDataset,
    MMapIndexedDatasetBuilder,
)
from deepspeed_tpu_torch.utils.logging import logger


def _metric_prefix(save_path: str, metric_name: str, kind: str, worker_id: Optional[int] = None) -> str:
    base = os.path.join(save_path, metric_name)
    os.makedirs(base, exist_ok=True)
    suffix = f"_worker{worker_id}" if worker_id is not None else ""
    return os.path.join(base, f"{metric_name}_{kind}{suffix}")


class DataAnalyzer:
    def __init__(
        self,
        dataset,
        num_workers: int = 1,
        metric_names: Sequence[str] = (),
        metric_functions: Sequence[Callable] = (),
        metric_types: Sequence[str] = (),
        save_path: str = "./data_analysis",
        batch_size: int = 1,  # noqa: ARG002 - parity; map iterates samples
        metric_dtypes: Optional[Sequence] = None,
    ):
        assert len(metric_names) == len(metric_functions) == len(metric_types)
        for t in metric_types:
            if t not in ("single_value_per_sample", "accumulate_value_over_samples"):
                raise ValueError(f"unknown metric_type {t!r}")
        self.dataset = dataset
        self.num_workers = max(1, num_workers)
        self.metric_names = list(metric_names)
        self.metric_functions = list(metric_functions)
        self.metric_types = list(metric_types)
        self.metric_dtypes = list(metric_dtypes or [np.int64] * len(metric_names))
        self.save_path = save_path

    # --- map -------------------------------------------------------------
    def _worker_range(self, worker_id: int):
        n = len(self.dataset)
        per = (n + self.num_workers - 1) // self.num_workers
        return range(worker_id * per, min(n, (worker_id + 1) * per))

    def run_map(self, worker_id: int = 0) -> None:
        """One worker's shard: compute every metric for its sample range and
        persist per-worker partial results."""
        idx_range = self._worker_range(worker_id)
        singles = {m: [] for m, t in zip(self.metric_names, self.metric_types) if t == "single_value_per_sample"}
        accums = {m: None for m, t in zip(self.metric_names, self.metric_types) if t == "accumulate_value_over_samples"}
        for i in idx_range:
            sample = self.dataset[i]
            for name, fn, mtype in zip(self.metric_names, self.metric_functions, self.metric_types):
                value = fn(sample)
                if mtype == "single_value_per_sample":
                    singles[name].append(int(value))
                else:
                    arr = np.asarray(value)
                    accums[name] = arr if accums[name] is None else accums[name] + arr
        os.makedirs(self.save_path, exist_ok=True)
        for name, values in singles.items():
            np.save(
                _metric_prefix(self.save_path, name, "sample_to_metric", worker_id) + ".npy",
                np.asarray(values, dtype=np.int64),
            )
            with open(_metric_prefix(self.save_path, name, "range", worker_id) + ".json", "w") as f:
                json.dump({"start": idx_range.start, "stop": idx_range.stop}, f)
        for name, total in accums.items():
            np.save(
                _metric_prefix(self.save_path, name, "accumulate", worker_id) + ".npy",
                np.asarray(0 if total is None else total),
            )

    # --- reduce ----------------------------------------------------------
    def run_reduce(self) -> None:
        """Merge worker partials into the final lookup tables."""
        for name, mtype in zip(self.metric_names, self.metric_types):
            if mtype == "single_value_per_sample":
                parts = []
                for w in range(self.num_workers):
                    vals = np.load(
                        _metric_prefix(self.save_path, name, "sample_to_metric", w) + ".npy"
                    )
                    with open(_metric_prefix(self.save_path, name, "range", w) + ".json") as f:
                        rng = json.load(f)
                    parts.append((rng["start"], vals))
                parts.sort()
                sample_to_metric = np.concatenate([v for _, v in parts])
                np.save(
                    _metric_prefix(self.save_path, name, "sample_to_metric") + ".npy",
                    sample_to_metric,
                )
                # metric_to_sample: one sequence of sample ids per metric value
                prefix = _metric_prefix(self.save_path, name, "metric_to_sample")
                builder = MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.int64)
                values = np.unique(sample_to_metric)
                for v in values:
                    builder.add_item(np.nonzero(sample_to_metric == v)[0].astype(np.int64))
                    builder.end_document()
                builder.finalize(prefix + ".idx")
                np.save(_metric_prefix(self.save_path, name, "metric_values") + ".npy", values)
            else:
                total = None
                for w in range(self.num_workers):
                    part = np.load(_metric_prefix(self.save_path, name, "accumulate", w) + ".npy")
                    total = part if total is None else total + part
                np.save(_metric_prefix(self.save_path, name, "accumulate") + ".npy", total)
        logger.info(f"DataAnalyzer: reduced {len(self.metric_names)} metric(s) → {self.save_path}")

    def run(self) -> None:
        """Single-process convenience: all map shards then reduce."""
        for w in range(self.num_workers):
            self.run_map(w)
        self.run_reduce()

    # --- consumption ------------------------------------------------------
    def load_sample_to_metric(self, metric_name: str) -> np.ndarray:
        return np.load(_metric_prefix(self.save_path, metric_name, "sample_to_metric") + ".npy")

    def load_metric_to_sample(self, metric_name: str) -> MMapIndexedDataset:
        return MMapIndexedDataset(_metric_prefix(self.save_path, metric_name, "metric_to_sample"))

    def load_metric_values(self, metric_name: str) -> np.ndarray:
        return np.load(_metric_prefix(self.save_path, metric_name, "metric_values") + ".npy")

    def load_accumulate(self, metric_name: str) -> np.ndarray:
        return np.load(_metric_prefix(self.save_path, metric_name, "accumulate") + ".npy")
