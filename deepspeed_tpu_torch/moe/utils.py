"""MoE parameter utilities (counterpart of ``deepspeed_tpu/moe/utils.py``).

Expert-ness is a property of a leaf's path in the JAX tree: the expert
weights live under an ``experts`` subtree (or a name starting with
``expert_``); the gate, the PR-MoE residual MLP and the coefficient are
shared. Splitting returns two trees of the input's structure with ``None``
holes, for grad trees as for param trees.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

_EXPERT_PATH_MARKERS = ("experts",)


def is_moe_param_path(path_names: Union[str, List[str]]) -> bool:
    """True when a tree path (``"a/b/c"`` or a list of names) addresses an
    expert weight."""
    if isinstance(path_names, str):
        path_names = path_names.split("/")
    if not all(isinstance(n, str) for n in path_names):
        raise TypeError("is_moe_param_path takes a 'a/b/c' string or a list of path names: expert-ness is a "
                        "property of a leaf's tree path, not of the array")
    return any(name in _EXPERT_PATH_MARKERS or name.startswith("expert_") for name in path_names)


is_moe_param = is_moe_param_path


def _walk(tree: Any, prefix: Tuple[str, ...], visit):
    if isinstance(tree, dict):
        return {k: _walk(v, prefix + (str(k),), visit) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, prefix + (str(i),), visit) for i, v in enumerate(tree))
    return visit(list(prefix), tree)


def _leaves(tree: Any):
    out = []
    _walk(tree, (), lambda path, leaf: out.append((path, leaf)))
    return out


def has_moe_layers(model_or_params: Any) -> Tuple[bool, int]:
    """``(has_moe, num_experts)``: a model whose config has ``num_experts``,
    or a param tree with an expert leaf (``num_experts`` 0: unknown from the
    structure alone)."""
    cfg = getattr(model_or_params, "config", None)
    if cfg is not None and hasattr(cfg, "num_experts"):
        return True, int(getattr(cfg, "num_experts", 0))
    tree = model_or_params
    if hasattr(model_or_params, "param_tree"):
        tree = model_or_params.param_tree()
    if not isinstance(tree, dict):
        return False, 0
    return any(is_moe_param_path(p) for p, leaf in _leaves(tree) if leaf is not None), 0


def split_params_into_shared_and_expert_params(params: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """``(shared, expert)``: two trees of ``params``' structure with
    ``None`` where the other holds the leaf."""
    def pick(want_expert):
        return _walk(params, (), lambda path, leaf: leaf if is_moe_param_path(path) == want_expert else None)

    return pick(False), pick(True)


split_params_grads_into_shared_and_expert_params = split_params_into_shared_and_expert_params


def split_params_into_different_moe_groups_for_optimizer(param_groups) -> List[Dict]:
    """Each optimizer param group split in two: its shared leaves
    (``moe=False``) and, when it has any, its expert leaves in a group named
    ``<name>_moe`` with the same hyperparameters (``moe=True``)."""
    groups = [param_groups] if isinstance(param_groups, dict) else list(param_groups)
    out: List[Dict] = []
    for group in groups:
        if "params" not in group:
            raise ValueError("param group is missing a 'params' entry")
        shared, expert = split_params_into_shared_and_expert_params(group["params"])
        base = {k: v for k, v in group.items() if k != "params"}
        out.append(dict(base, params=shared, moe=False))
        if any(leaf is not None for _, leaf in _leaves(expert)):
            out.append(dict(base, params=expert, moe=True, name=f"{group.get('name', 'group')}_moe"))
    return out
