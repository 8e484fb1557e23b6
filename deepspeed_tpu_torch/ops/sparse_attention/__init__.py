"""Block-sparse attention (reference: ``deepspeed/ops/sparse_attention/``);
the port of ``deepspeed_tpu/ops/sparse_attention/``."""

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    LocalSlidingWindowSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    BertSparseSelfAttention,
    SparseSelfAttention,
    block_sparse_attention,
)
