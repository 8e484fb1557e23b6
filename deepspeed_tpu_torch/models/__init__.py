"""The decoder family: configs and the parameter-holding ``TransformerLM``."""

from deepspeed_tpu_torch.models.config import (  # noqa: F401
    TransformerConfig,
    bert_config,
    gpt2_config,
    llama_config,
    qwen2_config,
)
from deepspeed_tpu_torch.models.transformer import TransformerLM  # noqa: F401
