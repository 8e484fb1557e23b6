"""Data-efficiency pipeline (counterpart of
``deepspeed_tpu/runtime/data_pipeline/``): the curriculum scheduler, the
samplers and random layerwise token dropping."""

from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.runtime.data_pipeline.data_routing import RandomLayerTokenDrop, RandomLTDScheduler
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampler import DeepSpeedDataSampler, DistributedSampler
