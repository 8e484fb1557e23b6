"""Data-efficiency sampling (counterpart of
``deepspeed_tpu/runtime/data_pipeline/data_sampling/``)."""

from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.data_analyzer import DataAnalyzer
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.indexed_dataset import (
    MMapIndexedDataset,
    MMapIndexedDatasetBuilder,
    make_builder,
    make_dataset,
)
