"""Path-keyed views of the engine's parameters and optimizer state.

Counterpart of ``deepspeed_tpu/utils/tensor_fragment.py`` (the reference's
``safe_get_full_*`` debugging surface). ``_flatten_with_paths`` is the
port's copy of JAX's (``:23``): ``a/b/c`` paths in the order
``jax.tree_util.tree_flatten`` visits a tree (dict keys sorted), so a file
written by either package lists its leaves in the same order. The getters
return whole fp32 numpy arrays on every rank and the setters take whole
arrays, whatever the ZeRO stage, the data-parallel degree and the offload
engine (streamed, host Adam, layer stream) hold; the engine does the
slicing and gathering (``DeepSpeedEngine._leaf_state`` and
``_set_leaf_state``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


def _flatten_with_paths(tree) -> Dict[str, Any]:
    """Path -> leaf, dict keys sorted; a None subtree is dropped."""
    out: Dict[str, Any] = {}

    def walk(prefix, t):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t.keys()):
                walk(f"{prefix}/{k}" if prefix else str(k), t[k])
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(f"{prefix}/{i}" if prefix else str(i), v)
        else:
            out[prefix] = t

    walk("", tree)
    return out


def _flat_names(engine) -> List[str]:
    """The engine's leaf paths in the tree order above."""
    from deepspeed_tpu_torch.checkpoint.jax_params import unflatten_tree

    return list(_flatten_with_paths(unflatten_tree({k: 0 for k in engine._shapes})))


def parameter_names(engine) -> List[str]:
    """All parameter paths (JAX ``tensor_fragment.py:60``)."""
    return _flat_names(engine)


def safe_get_full_fp32_param(engine, name: str) -> Optional[np.ndarray]:
    """The whole fp32 master of ``name`` (JAX ``:65``), on every rank; the
    host's master on the offload paths. None for an unknown path."""
    return engine._leaf_state(name, "master")


def safe_set_full_fp32_param(engine, name: str, value) -> bool:
    """Overwrite the fp32 master of ``name`` and refresh its compute-dtype
    copy (JAX ``:76``). Every rank passes the whole value; the write lands
    in the engine's own tensors, so a captured step program's next replay
    reads it. False for an unknown path."""
    return engine._set_leaf_state(name, "master", value)


def safe_get_full_grad(engine, name: str) -> Optional[np.ndarray]:
    """The gradient of ``name`` as ``engine.get_last_grads()`` gives it
    (JAX ``:117``): the live accumulator (scaled by loss scale × gas until
    the step consumes it), or, where the step ran as one program, the last
    microbatch's gradient recomputed at the current parameters."""
    grads = engine.get_last_grads()
    if grads is None:
        return None
    flat = _flatten_with_paths(grads)
    if name not in flat:
        return None
    return np.asarray(flat[name], dtype=np.float32)


_STATE_ALIASES = {
    "exp_avg": ("exp_avg", "m", "mu"),
    "exp_avg_sq": ("exp_avg_sq", "v", "nu"),
}


def _state_field(engine, state_key: str) -> Optional[str]:
    """The engine's state name for ``state_key``, as JAX resolves it: on
    the offload paths the torch-style aliases (``m``/``mu``, ``v``/``nu``)
    name the Adam moments and any other key names nothing; on the card the
    key (or one of its aliases) must be a field of the optimizer state
    (``exp_avg``, ``exp_avg_sq``, Adagrad's ``sum_sq``)."""
    if engine._host_offload is not None or engine._param_stream is not None:
        for canonical, aliases in _STATE_ALIASES.items():
            if state_key in aliases:
                return canonical
        return None
    aliases = _STATE_ALIASES.get(state_key, (state_key,))
    for field in getattr(engine._opt_state, "_fields", ()):
        if isinstance(getattr(engine._opt_state, field), dict) and (field in aliases or field == state_key):
            return field
    return None


def safe_get_full_optimizer_state(engine, name: str, state_key: str) -> Optional[np.ndarray]:
    """The whole optimizer state ``state_key`` of ``name`` (JAX ``:150``),
    wherever it lives. None for an unknown path or key."""
    field = _state_field(engine, state_key)
    return None if field is None else engine._leaf_state(name, field)


def safe_set_full_optimizer_state(engine, name: str, state_key: str, value) -> bool:
    """Overwrite the whole optimizer state ``state_key`` of ``name`` (JAX
    ``:184``), in place, on every rank's slice."""
    field = _state_field(engine, state_key)
    return field is not None and engine._set_leaf_state(name, field, value)
