"""Curriculum-aware data sampling.

Counterpart of the reference's ``data_sampling/data_sampler.py``
(``DeepSpeedDataSampler``): a deterministic distributed sampler whose batch
composition can follow a difficulty metric — samples are bucketed by a
difficulty value and early training draws from the easy buckets
(curriculum), annealing to the full distribution.

The port's own copy of
``deepspeed_tpu/runtime/data_pipeline/data_sampler.py``
(the port imports nothing of the JAX package): the same names and the
same numbers.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


class DistributedSampler:
    """Deterministic per-rank sampler (torch DistributedSampler semantics —
    what ``deepspeed_io`` uses for plain DP)."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = (dataset_len + num_replicas - 1) // num_replicas
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rs = np.random.RandomState(self.seed + self.epoch)
            indices = rs.permutation(self.dataset_len).tolist()
        else:
            indices = list(range(self.dataset_len))
        if not self.drop_last:
            pad = self.total_size - len(indices)
            indices += indices[:pad]
        else:
            indices = indices[: self.total_size]
        return iter(indices[self.rank : self.total_size : self.num_replicas])

    def __len__(self) -> int:
        return self.num_samples


class DeepSpeedDataSampler:
    """Curriculum sampler (reference ``DeepSpeedDataSampler``): given a
    per-sample difficulty array and a ``CurriculumScheduler``, each epoch
    draws only samples whose difficulty ≤ the current threshold."""

    def __init__(
        self,
        difficulties: Sequence[float],
        curriculum_scheduler,
        num_replicas: int = 1,
        rank: int = 0,
        seed: int = 0,
        global_batch_size: int = 1,
    ):
        self.difficulties = np.asarray(difficulties)
        self.scheduler = curriculum_scheduler
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.global_batch_size = global_batch_size
        self.consumed_samples = 0

    def eligible_indices(self) -> np.ndarray:
        threshold = self.scheduler.get_current_difficulty()
        idx = np.nonzero(self.difficulties <= threshold)[0]
        if idx.size == 0:
            idx = np.argsort(self.difficulties)[: self.global_batch_size]
        return idx

    def __iter__(self) -> Iterator[int]:
        step = 0
        while True:
            self.scheduler.update_difficulty(step)
            pool = self.eligible_indices()
            rs = np.random.RandomState(self.seed + step)
            batch = rs.choice(pool, size=self.global_batch_size, replace=pool.size < self.global_batch_size)
            for i in batch[self.rank :: self.num_replicas]:
                yield int(i)
            self.consumed_samples += self.global_batch_size
            step += 1

    def state_dict(self):
        return {"consumed_samples": self.consumed_samples}

    def load_state_dict(self, sd):
        self.consumed_samples = sd["consumed_samples"]


def sampler_from_analysis(
    save_path: str,
    metric_name: str,
    curriculum_scheduler,
    num_replicas: int = 1,
    rank: int = 0,
    seed: int = 0,
    global_batch_size: int = 1,
) -> DeepSpeedDataSampler:
    """Build the curriculum sampler from a ``DataAnalyzer`` run's
    ``sample_to_metric`` table — the map-reduce → sampler hookup the
    reference wires through its index files."""
    from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.data_analyzer import (
        DataAnalyzer,
    )

    analyzer = DataAnalyzer([], metric_names=[], metric_functions=[], metric_types=[], save_path=save_path)
    difficulties = analyzer.load_sample_to_metric(metric_name)
    return DeepSpeedDataSampler(
        difficulties,
        curriculum_scheduler,
        num_replicas=num_replicas,
        rank=rank,
        seed=seed,
        global_batch_size=global_batch_size,
    )
