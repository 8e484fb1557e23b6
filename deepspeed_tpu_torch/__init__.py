"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` stays the reference; this package grows
beside it slice by slice and mirrors its module paths. It imports neither
``jax`` nor ``deepspeed_tpu``. Today it covers the paged ragged serving path
(``init_inference(...).serve(...)``), whose attention runs through the
hand-written CUDA kernel ``csrc/ragged_paged_attention.cu``.
"""

from __future__ import annotations

__version__ = "0.1.0"


def init_inference(model, config=None, device=None, **kwargs):
    """Build an inference engine. ``config`` is a dict (or a
    ``DeepSpeedInferenceConfig``) in the JAX package's JSON schema;
    ``kwargs`` update it. The engine runs on ``cuda`` unless ``device``
    names another device, and raises when no card is present."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    if isinstance(config, DeepSpeedInferenceConfig):
        if kwargs:
            raise ValueError("pass either a DeepSpeedInferenceConfig or keyword overrides, not both")
        ds_config = config
    else:
        config_dict = dict(config or {})
        config_dict.update(kwargs)
        ds_config = DeepSpeedInferenceConfig(**config_dict)
    return InferenceEngine(model, config=ds_config, device=device)
