"""The MoE decoder family.

Counterpart of ``deepspeed_tpu/models/moe_transformer.py``: a
``TransformerLM`` whose MLP blocks are ``moe.layer.MoE`` layers, which run
across ranks by the live topology (``moe/layer.py``; the expert leaves
over the ``expert`` axis, ``expert_partition_rules``).

The tree is JAX's: with every layer MoE (``moe_layer_freq == 1``) the
dense FFN leaves leave ``layers`` and each MoE leaf stacks ``[L, ...]``
under ``layers/moe`` (``gate/wg``, ``experts/...`` each ``[L, E, ...]``,
and with PR-MoE ``mlp/...`` and ``coefficient/{w,b}``); with interleaved
layers (every ``moe_layer_freq``-th layer MoE) the dense FFN leaves
restack over the dense layers under ``dense_mlp`` and the MoE leaves over
the MoE layers under ``moe_layers``. The load-balance loss of each MoE
layer, times ``moe_aux_loss_coef``, is summed into the training loss
(``TransformerLM.apply``). The router weight ``wg`` stays fp32 under mixed
precision (``keep_fp32_params``), as JAX's engine keeps it.

Under tensor parallelism (the inference engine's forward) each layer's
attention runs sharded and the MoE block runs on the replicated
activation with the experts replicated over ``model``, as JAX's rules
place them (``tp_partition_rules``); tensor-parallel training is ROADMAP
P1.

The MoE layers draw their training noise (top-2's second-expert Gumbel
sample, top-1's Random Token Selection, ``noisy_gate_policy``) from the
layer's seed, a device scalar (``transformer._uniform``), so a captured
CUDA graph replays it from its seed buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.models.config import TransformerConfig
from deepspeed_tpu_torch.models.transformer import TransformerLM, _FFN_LEAVES, _flat, _nest, dense_param_shapes
from deepspeed_tpu_torch.moe.layer import MoE


@dataclasses.dataclass
class MoETransformerConfig(TransformerConfig):
    num_experts: int = 8
    moe_layer_freq: int = 1  # every k-th layer is MoE
    moe_top_k: int = 1
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    use_residual: bool = False  # PR-MoE
    noisy_gate_policy: Optional[str] = None  # None | 'RSample' | 'Jitter'
    moe_drop_tokens: bool = True
    moe_use_rts: bool = True
    moe_aux_loss_coef: float = 0.01
    expert_intermediate_size: Optional[int] = None
    moe_quantized_a2a: bool = False  # the int8 expert all-to-all (expert parallelism)

    def __post_init__(self):
        super().__post_init__()
        if self.expert_intermediate_size is None:
            self.expert_intermediate_size = self.intermediate_size
        if self.moe_layer_freq > 1:
            self.scan_layers = False


def moe_layer_of(cfg: MoETransformerConfig) -> MoE:
    """The model's MoE layer (JAX ``MoETransformerLM.__init__``'s
    arguments)."""
    return MoE(
        hidden_size=cfg.hidden_size,
        num_experts=cfg.num_experts,
        k=cfg.moe_top_k,
        capacity_factor=cfg.capacity_factor,
        eval_capacity_factor=cfg.eval_capacity_factor,
        min_capacity=cfg.min_capacity,
        use_residual=cfg.use_residual,
        noisy_gate_policy=cfg.noisy_gate_policy,
        drop_tokens=cfg.moe_drop_tokens,
        use_rts=cfg.moe_use_rts,
        intermediate_size=cfg.expert_intermediate_size,
        activation=cfg.activation if cfg.activation in ("gelu", "relu", "swiglu", "geglu") else "gelu",
        use_bias=cfg.use_bias,
        out_std=0.02 / np.sqrt(2 * cfg.num_layers),
        quantized_a2a=cfg.moe_quantized_a2a,
    )


def _is_moe_layer(cfg, i: int) -> bool:
    return (i + 1) % cfg.moe_layer_freq == 0


def moe_param_shapes(cfg: MoETransformerConfig) -> Dict[str, tuple]:
    """Flat ``path -> shape`` of JAX ``MoETransformerLM.init``'s tree."""
    base = dense_param_shapes(cfg)
    moe = moe_layer_of(cfg)
    L = cfg.num_layers
    dense = {p: s for p, s in base.items() if p.startswith("layers/") and p.split("/", 1)[1] in _FFN_LEAVES}
    out = {p: s for p, s in base.items() if p not in dense}
    n_moe = sum(_is_moe_layer(cfg, i) for i in range(L))
    if cfg.moe_layer_freq == 1:
        out.update({f"layers/moe/{k}": v for k, v in moe.param_shapes((L,)).items()})
    else:
        out.update({"dense_mlp/" + p.split("/", 1)[1]: (L - n_moe,) + s[1:] for p, s in dense.items()})
        out.update({f"moe_layers/{k}": v for k, v in moe.param_shapes((n_moe,)).items()})
    return out


class MoETransformerLM(TransformerLM):
    """The decoder with MoE MLP blocks (see the module docstring)."""

    _moe = True

    def __init__(self, config: MoETransformerConfig):
        super().__init__(config)
        self.moe = moe_layer_of(config)
        L = config.num_layers
        self._moe_index = {i: j for j, i in enumerate(i for i in range(L) if _is_moe_layer(config, i))}
        self._dense_index = {i: j for j, i in enumerate(i for i in range(L) if not _is_moe_layer(config, i))}

    def stream_fns(self):
        raise NotImplementedError(
            "offload_param layer streaming does not support MoE families: the expert params live outside the "
            "stacked layer tree and the load-balance aux loss cannot ride the per-layer stream programs")

    def keep_fp32_params(self, params_shapes=None) -> Any:
        """The router weights stay fp32 under mixed precision (JAX
        ``keep_fp32_params``): a tree of ``params_shapes``' structure, True
        at the leaves ending in ``gate/wg``; None without shapes."""
        if params_shapes is None:
            return None

        def walk(prefix, tree):
            if isinstance(tree, dict):
                return {k: walk(f"{prefix}/{k}", v) for k, v in tree.items()}
            return prefix.endswith("/gate/wg")

        return walk("", params_shapes)

    def _per_layer(self, params) -> List[Dict]:
        if self.config.moe_layer_freq == 1:
            return super()._per_layer(params)
        L = self.config.num_layers
        stacked = {k: v.unbind(0) for k, v in _flat(params["layers"]).items()}
        dense = {k: v.unbind(0) for k, v in _flat(params["dense_mlp"]).items()}
        moe = {k: v.unbind(0) for k, v in _flat(params["moe_layers"]).items()}
        out = []
        for i in range(L):
            per = {k: u[i] for k, u in stacked.items()}
            if i in self._moe_index:
                per.update({f"moe/{k}": u[self._moe_index[i]] for k, u in moe.items()})
            else:
                per.update({k: u[self._dense_index[i]] for k, u in dense.items()})
            out.append(_nest(per))
        return out

    def _mlp(self, p, h, seed, train, tp=None, replicated=False):
        if "moe" not in p:
            return super()._mlp(p, h, seed, train, tp)
        if tp is not None and train:
            raise NotImplementedError("tensor-parallel MoE training needs tensor-parallel training, which is not "
                                      "ported yet (ROADMAP P1)")
        out, l_aux, _counts = self.moe.apply(p["moe"], h, train=train, seed=seed, replicated=replicated)
        return out, l_aux * self.config.moe_aux_loss_coef

    def tp_partition_rules(self, params_shapes=None) -> Any:
        """JAX's rules (``moe_transformer.py:133-158``) in the port's form,
        the dim each leaf splits over ``model``: the dense leaves by the
        name-driven walk (an interleaved stack's ``dense_mlp`` too), every
        MoE leaf None (JAX places the experts on the ``expert`` axis,
        ``expert_partition_rules``, and the gate and the residual
        replicated)."""
        if params_shapes is None:
            return None
        base = super().tp_partition_rules(params_shapes)

        def replicated(tree):
            return {k: replicated(v) for k, v in tree.items()} if isinstance(tree, dict) else None

        if "moe" in params_shapes.get("layers", {}):
            base["layers"]["moe"] = replicated(params_shapes["layers"]["moe"])
        if "moe_layers" in params_shapes:
            base["moe_layers"] = replicated(params_shapes["moe_layers"])
        return base


def moe_llama_config(size: str = "tiny", **overrides) -> MoETransformerConfig:
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8, vocab_size=32000, max_seq_len=512),
        "1b-8e": dict(hidden_size=2048, num_layers=22, num_heads=32, num_kv_heads=4, vocab_size=32000),
    }
    base = dict(norm="rmsnorm", position="rope", activation="swiglu", use_bias=False, tie_embeddings=False)
    base.update(presets[size])
    base.update(overrides)
    return MoETransformerConfig(**base)


def mixtral_config(size: str = "8x7b", **overrides) -> MoETransformerConfig:
    """Mixtral presets: GQA llama body, 8 experts, top-2 routing, every
    layer MoE."""
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8, num_kv_heads=2, vocab_size=32000,
                     max_seq_len=512),
        "8x7b": dict(hidden_size=4096, num_layers=32, num_heads=32, num_kv_heads=8, intermediate_size=14336,
                     vocab_size=32000, max_seq_len=32768),
    }
    base = dict(norm="rmsnorm", position="rope", rope_theta=1e6, activation="swiglu", use_bias=False,
                tie_embeddings=False, num_experts=8, moe_top_k=2, moe_layer_freq=1)
    base.update(presets[size])
    base.update(overrides)
    return MoETransformerConfig(**base)
