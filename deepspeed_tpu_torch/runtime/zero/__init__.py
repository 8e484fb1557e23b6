"""ZeRO configuration: the JSON schema of ``deepspeed_tpu/runtime/zero``."""
