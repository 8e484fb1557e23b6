"""AutoTP: tensor-parallel shard dims from a walk over the parameter tree.

Counterpart of ``deepspeed_tpu/module_inject/auto_tp.py:29-121`` (the
reference's ``AutoTP``, ``deepspeed/module_inject/auto_tp.py:170``), the
rule the inference engine falls back on when a module has no
``tp_partition_rules``. JAX emits ``PartitionSpec``s over the ``model``
mesh axis; the port emits the dim each leaf splits along (None:
replicated), which is what a rank slices and what the pre-sharded
checkpoint records (``inference/mp_checkpoint.py``).

Classification by the last path component (the reference's policy,
``module_inject/layers.py:15,32``):

* column-parallel (the output features, the last dim): q/k/v/gate/up/fc-in
  projections; a 1-D bias of one splits its only dim;
* row-parallel (the input features, dim -2): attention-out and fc-out
  projections; their 1-D biases replicate (added after the all-reduce);
* vocab: ``lm_head`` splits its output vocabulary (the last dim), a token
  embedding its input vocabulary (dim 0);
* everything else (norms, other biases) replicates.

Stacked ``[L, in, out]`` layer weights keep the layer dim whole.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# name-pattern tables (matched against the last path component, lowercase)
COLUMN_PATTERNS = [
    r"w?q(_proj|_lin)?$", r"w?k(_proj|_lin)?$", r"w?v(_proj|_lin)?$",
    r"(w_)?qkv(_proj)?$", r"query(_key_value)?$", r"key$", r"value$",
    r"(w_)?gate(_proj)?$", r"(w_)?up(_proj)?$", r"w_in$", r"fc1$", r"c_fc$",
    r"wi(_\d+)?$", r"dense_h_to_4h$", r"intermediate$",
]
ROW_PATTERNS = [
    r"w?o(_proj|ut_proj)?$", r"out(_proj)?$", r"w_out$", r"fc2$", r"c_proj$",
    r"wo$", r"dense_4h_to_h$", r"attn_out$", r"dense$", r"o_proj$", r"down_proj$",
]
VOCAB_PATTERNS = [r"tokens$", r"wte$", r"embed_tokens$", r"word_embeddings$", r"lm_head$"]
NORM_PATTERNS = [r".*norm.*", r"ln_\w+$", r".*layernorm.*"]


def _matches(name: str, patterns: List[str]) -> bool:
    return any(re.fullmatch(p, name) for p in patterns)


class Classification:
    COLUMN = "column"
    ROW = "row"
    VOCAB = "vocab"
    REPLICATE = "replicate"


def classify_param(path: str) -> str:
    """Classify one parameter by its tree path."""
    name = path.split("/")[-1].lower()
    if _matches(name, NORM_PATTERNS):
        return Classification.REPLICATE
    if _matches(name, COLUMN_PATTERNS):
        return Classification.COLUMN
    if _matches(name, ROW_PATTERNS):
        return Classification.ROW
    if _matches(name, VOCAB_PATTERNS):
        return Classification.VOCAB
    return Classification.REPLICATE


def shard_dim_for_param(path: str, shape: Tuple[int, ...]) -> Optional[int]:
    """The dim one leaf splits along, or None (JAX ``spec_for_param``)."""
    kind = classify_param(path)
    nd = len(shape)
    if nd == 0 or kind == Classification.REPLICATE:
        return None
    if kind == Classification.COLUMN:
        return nd - 1
    if kind == Classification.ROW:
        return None if nd == 1 else nd - 2
    # vocab
    if nd == 1:
        return None
    return nd - 1 if path.split("/")[-1].lower() == "lm_head" else 0


class AutoTP:
    """A shard-dim tree for an arbitrary parameter tree (the reference
    ``AutoTP``); ``overrides`` maps a full-path regex to a dim."""

    def __init__(self, overrides: Optional[Dict[str, Optional[int]]] = None):
        self.overrides = overrides or {}

    def partition_specs(self, params_shapes: Any) -> Any:
        def walk(prefix: str, tree):
            if isinstance(tree, dict):
                return {k: walk(f"{prefix}/{k}", v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(walk(f"{prefix}/{i}", v) for i, v in enumerate(tree))
            shape = tuple(getattr(tree, "shape", np.shape(tree)))
            for pat, dim in self.overrides.items():
                if re.fullmatch(pat, prefix):
                    return dim
            return shard_dim_for_param(prefix, shape)

        return walk("", params_shapes)
