"""Kernels and their plain PyTorch versions, and the optimizers.

``DeepSpeedCPUAdam`` is ``FusedAdam``, as in the JAX package: the host
variant shares its math and is chosen by the ZeRO offload config.
"""

from deepspeed_tpu_torch.ops.adagrad.cpu_adagrad import DeepSpeedCPUAdagrad
from deepspeed_tpu_torch.ops.adam.fused_adam import Adam, AdamW, FusedAdam

DeepSpeedCPUAdam = FusedAdam
