"""Path-keyed views of nested parameter trees.

The port's copy of ``_flatten_with_paths`` (``deepspeed_tpu/utils/
tensor_fragment.py:23``), which has no JAX in it: ``a/b/c`` paths in the
order ``jax.tree_util.tree_flatten`` visits a tree (dict keys sorted), so a
file written by either package lists its leaves in the same order.
"""

from __future__ import annotations

from typing import Any, Dict


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
