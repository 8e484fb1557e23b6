"""Inference: engine, paged KV pool, ragged serving step and scheduler.

Submodules are imported by path (``deepspeed_tpu_torch.inference.engine``
and so on); this package module imports nothing, so the config and the
kernels can be imported without pulling in the scheduler.
"""
