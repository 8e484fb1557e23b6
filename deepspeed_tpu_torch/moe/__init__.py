"""Mixture of Experts on one rank (counterpart of ``deepspeed_tpu/moe/``):
top-1/top-2 gating with capacity and the load-balance loss, index-based
dispatch and combine, stacked expert FFNs, the PR-MoE residual. Expert
parallelism (the all-to-alls over an ``expert`` mesh axis) raises."""

from deepspeed_tpu_torch.moe.experts import (
    apply_dense_ffn,
    apply_expert_ffn,
    expert_partition_rules,
    init_expert_ffn,
)
from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.moe.sharded_moe import (
    combine,
    dispatch,
    multiplicative_jitter,
    top1gating,
    top2gating,
    topkgating,
)

__all__ = [
    "MoE",
    "top1gating",
    "top2gating",
    "topkgating",
    "dispatch",
    "combine",
    "multiplicative_jitter",
    "init_expert_ffn",
    "apply_expert_ffn",
    "apply_dense_ffn",
    "expert_partition_rules",
]
