"""The decoder family: configs and the parameter-holding ``TransformerLM``."""

from deepspeed_tpu_torch.models.config import TransformerConfig, gpt2_config, llama_config, qwen2_config  # noqa: F401
from deepspeed_tpu_torch.models.transformer import TransformerLM  # noqa: F401
