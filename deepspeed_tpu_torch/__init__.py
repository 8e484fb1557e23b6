"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` stays the reference; this package grows
beside it slice by slice and mirrors its module paths. It imports neither
``jax`` nor ``deepspeed_tpu``. Today it covers:

* the paged ragged serving path (``init_inference(...).serve(...)``), whose
  attention runs through the CUDA kernel ``csrc/ragged_paged_attention.cu``,
  and its bucketed oracle (``paged_kv={"ragged": False}``), whose decode
  rounds attend through the paged decode kernel of
  ``csrc/decode_attention.cu``;
* the dense KV-cached ``engine.generate`` (greedy, sampling, beam search),
  whose single-token steps attend through the dense decode kernel of
  ``csrc/decode_attention.cu``;
* the single-card training path (``initialize(...)`` then ``engine(batch)``,
  ``backward``, ``step``), whose attention runs through the CUDA flash
  kernels ``csrc/flash_attention.cu`` (forward, dQ, dK/dV);
* block-sparse self-attention (``ops.sparse_attention``: the
  ``SparsityConfig`` layouts, ``SparseSelfAttention``,
  ``BertSparseSelfAttention``), differentiable, whose fused path runs the
  CUDA kernels ``csrc/block_sparse_attention.cu`` (forward, dQ, dK/dV over
  the layout's live blocks). As in JAX, a call with a ``key_padding_mask``
  or a block that is not a multiple of 8 takes the dense-gather emulation
  instead, chosen from the arguments before any launch;
* tensor parallelism over ``torch.distributed`` (``comm``, one process a
  rank): sharded paged serving (``paged_kv.sharded.tp_degree``), the
  sharded forward and ``generate`` (``tensor_parallel.tp_size``), and the
  pre-sharded inference checkpoint (``save_mp_checkpoint``,
  ``checkpoint=``).
"""

from __future__ import annotations

from deepspeed_tpu_torch import comm as comm
from deepspeed_tpu_torch.comm.comm import init_distributed

__version__ = "0.1.0"
dist = comm


def initialize(args=None, model=None, optimizer=None, model_parameters=None, training_data=None,
               lr_scheduler=None, mpu=None, dist_init_required=None, collate_fn=None, config=None,
               config_params=None, loss_fn=None, device=None, attn_impl=None):
    """Build the training engine (JAX ``initialize``, ``__init__.py:32``).
    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``.

    ``model`` is the port's ``TransformerLM``; ``model_parameters`` the JAX
    tree as numpy (nested or flat paths), the one way weights enter the
    port (``models.transformer.init_params`` draws a tree with the JAX
    init's distributions). ``config`` is a
    dict (or a JSON path) in the JAX package's schema. The engine runs on
    ``cuda`` unless ``device`` names another device, and raises when no
    card is present. ``attn_impl="plain"`` runs the plain attention on the
    card (the comparison arm); the default launches the kernels."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    if model is None:
        raise AssertionError("deepspeed.initialize requires a model")
    if training_data is not None or collate_fn is not None:
        raise NotImplementedError("training_data / collate_fn (the engine dataloader) are not ported yet "
                                  "(ROADMAP T5)")
    if mpu is not None or loss_fn is not None:
        raise NotImplementedError("mpu / loss_fn are not ported yet (ROADMAP P1, X1)")
    if config is None:
        config = config_params
    if config is None and args is not None and getattr(args, "deepspeed_config", None) is not None:
        config = args.deepspeed_config
    engine = DeepSpeedEngine(model, config=DeepSpeedConfig(config if config is not None else {}),
                             model_parameters=model_parameters, optimizer=optimizer,
                             lr_scheduler=lr_scheduler, device=device, attn_impl=attn_impl)
    return engine, engine.optimizer, None, engine.lr_scheduler


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
