"""Mixture of Experts (counterpart of ``deepspeed_tpu/moe/``): top-1/top-2
gating with capacity and the load-balance loss, index-based dispatch and
combine, stacked expert FFNs, the PR-MoE residual, and expert parallelism
across ranks (``a2a``: the dispatch and combine all-to-alls over the
``expert`` axis and their int8 wire; ``mappings``: the tensor-parallel
token drop and gather)."""

from deepspeed_tpu_torch.moe.experts import (
    apply_dense_ffn,
    apply_expert_ffn,
    expert_partition_rules,
    init_expert_ffn,
)
from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.moe.mappings import drop_tokens, gather_tokens
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
    "gather_tokens",
    "drop_tokens",
]
