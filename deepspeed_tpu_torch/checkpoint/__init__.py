"""Checkpoint formats (reference ``deepspeed/checkpoint/``; the port's
counterpart of ``deepspeed_tpu/checkpoint/``): weight loading from the JAX
tree (``jax_params``), the reference-layout export and readers, the
universal format and the path helpers. ``reshape_3d`` and the ingestion of
reference checkpoints onto a model wait for the module_inject containers
(ROADMAP P1)."""

from deepspeed_tpu_torch.checkpoint import constants
from deepspeed_tpu_torch.checkpoint.constants import *  # noqa: F401,F403 - reference surface
from deepspeed_tpu_torch.checkpoint.deepspeed_checkpoint import (
    DeepSpeedCheckpoint,
    convert_to_universal,
    load_hp_checkpoint_state,
    universal_param_names,
)
from deepspeed_tpu_torch.checkpoint.reference_export import export_reference_checkpoint
from deepspeed_tpu_torch.checkpoint.reference_ingest import (
    ingest_reference_checkpoint,
    ingest_universal_checkpoint,
    merge_reference_model_states,
    merge_reference_zero_fp32,
    read_universal_dir,
    tp_merge_axis,
)
from deepspeed_tpu_torch.checkpoint.reshape_utils import (
    ReshapeMeg2D,
    merge_tp_slices,
    reshape_tp_degree,
    split_tp_slices,
)
from deepspeed_tpu_torch.checkpoint.utils import (
    clone_tensors_for_torch_save,
    get_layer_ckpt_name_for_rank,
    get_model_ckpt_name_for_rank,
    get_zero_ckpt_name_for_rank,
)
