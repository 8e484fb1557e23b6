"""The MoE layer: gate, stacked experts and the PR-MoE residual.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (``MoE``) on one rank: the
branch of ``apply`` that runs when ``a2a.ep_fast_path`` is false
(``layer.py:193-214``), which is every call without an ``expert`` mesh
axis. The router reads ``tokens.float() @ wg`` (``wg`` is kept in fp32 by
the training engine, ``MoETransformerLM.keep_fp32_params``), the gate
routes (``sharded_moe``), ``dispatch`` copies each kept token into its
expert's slot, ``apply_expert_ffn`` runs the experts as one batched
product, and ``combine`` mixes each token's expert rows back. With
``use_residual`` a dense MLP runs beside the experts and a learned 2-way
softmax mixes the two (PR-MoE).

Expert parallelism (``ep_size > 1``, ``quantized_a2a``, an ``expert`` mesh
axis) is the second half of ROADMAP M1 and raises.

Noise: in training JAX draws the jitter, the top-1 Gumbel sample, the
Random Token Selection permutation and the top-2 second-expert Gumbel
sample from the layer's rng. Here each comes from ``noise`` (a dict the
tests fill with JAX's own draws) or, when ``seed`` (an int64 device
scalar) is given, from a counter-based hash of the seed
(``models.transformer._uniform``), which a captured CUDA graph replays from
the seed it is given. Without either (eval, or JAX's ``rng=None``) no noise
is drawn, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.moe import sharded_moe
from deepspeed_tpu_torch.moe.experts import (
    apply_dense_ffn,
    apply_expert_ffn,
    dense_ffn_shapes,
    expert_ffn_shapes,
    expert_partition_rules,
    init_dense_ffn,
    init_expert_ffn,
)

_JITTER_EPS = 1e-2  # JAX multiplicative_jitter's epsilon
_SALT_JITTER, _SALT_GUMBEL, _SALT_RTS = 0x3C6EF372, 0xA54FF53A, 0x510E527F


def ep_refusal(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: expert parallelism is not ported yet (ROADMAP M1 (second half))")


class MoE:
    """Mixture of Experts layer (functional): ``init`` draws the param
    tree, ``apply(params, x, ...)`` returns ``(output, l_aux, exp_counts)``
    as JAX's ``MoE.apply``."""

    def __init__(self, hidden_size: int, num_experts: int = 1, ep_size: int = 1, k: int = 1,
                 capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 use_residual: bool = False, noisy_gate_policy: Optional[str] = None, drop_tokens: bool = True,
                 use_rts: bool = True, intermediate_size: Optional[int] = None, activation: str = "gelu",
                 use_bias: bool = True, out_std: Optional[float] = None, quantized_a2a: bool = False):
        if ep_size > 1:
            raise ep_refusal(f"MoE(ep_size={ep_size})")
        if quantized_a2a:
            raise ep_refusal("moe_quantized_a2a (the int8 expert all-to-all)")
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.ep_size = ep_size
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.use_residual = use_residual
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens
        self.use_rts = use_rts
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.activation = activation
        self.use_bias = use_bias
        self.out_std = out_std
        self.quantized_a2a = quantized_a2a

    # --- params ---------------------------------------------------------
    def param_shapes(self, lead: tuple = ()) -> Dict[str, tuple]:
        """Flat ``path -> shape`` of the layer's tree (``gate/wg``,
        ``experts/...``, and with the residual ``mlp/...`` and
        ``coefficient/{w,b}``), each shape led by ``lead`` (the stacked
        layer dim of a model)."""
        H, E, I = self.hidden_size, self.num_experts, self.intermediate_size
        s = {"gate/wg": lead + (H, E)}
        s.update({f"experts/{k}": lead + v
                  for k, v in expert_ffn_shapes(E, H, I, self.activation, self.use_bias).items()})
        if self.use_residual:
            s.update({f"mlp/{k}": lead + v for k, v in dense_ffn_shapes(H, I, self.activation, self.use_bias).items()})
            s["coefficient/w"] = lead + (H, 2)
            s["coefficient/b"] = lead + (2,)
        return s

    def init(self, rng: np.random.Generator) -> Dict[str, Any]:
        """The layer's tree as numpy, with JAX ``MoE.init``'s distributions:
        the gate normal(0.02) in fp32, the experts (and the residual MLP)
        as ``init_expert_ffn``, the coefficient normal(0.02) with a zero
        bias."""
        H = self.hidden_size
        params: Dict[str, Any] = {
            "gate": {"wg": rng.standard_normal((H, self.num_experts), dtype=np.float32) * np.float32(0.02)},
            "experts": init_expert_ffn(rng, self.num_experts, H, self.intermediate_size, self.activation,
                                       self.use_bias, out_std=self.out_std),
        }
        if self.use_residual:
            params["mlp"] = init_dense_ffn(rng, H, self.intermediate_size, self.activation, self.use_bias,
                                           out_std=self.out_std)
            params["coefficient"] = {"w": rng.standard_normal((H, 2), dtype=np.float32) * np.float32(0.02),
                                     "b": np.zeros((2,), np.float32)}
        return params

    def partition_rules(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The expert leaves over the ``expert`` axis; the gate and the
        residual replicated (tuples of spec entries)."""
        rules = {k: (_replicated(v) if k != "experts" else expert_partition_rules(v)) for k, v in params.items()}
        return rules

    # --- forward --------------------------------------------------------
    def _noise(self, S: int, device, seed: Optional[torch.Tensor], noise: Optional[Dict[str, torch.Tensor]],
               train: bool) -> Dict[str, torch.Tensor]:
        """The draws JAX would make in training (``noise`` given, or hashed
        from ``seed``); none in eval."""
        if not train:
            return {}
        if noise is not None:
            return noise
        if seed is None:
            return {}
        from deepspeed_tpu_torch.models.transformer import _uniform

        out = {}
        H, E = self.hidden_size, self.num_experts
        if self.noisy_gate_policy == "Jitter":
            out["jitter"] = 1.0 - _JITTER_EPS + 2.0 * _JITTER_EPS * _uniform((S, H), seed, _SALT_JITTER, device)
        if (self.k == 1 and self.noisy_gate_policy == "RSample") or self.k == 2:
            out["gumbel"] = sharded_moe.gumbel_from_uniform(_uniform((S, E), seed, _SALT_GUMBEL, device))
        if self.k == 1 and self.use_rts and self.drop_tokens:
            out["rts_perm"] = torch.argsort(_uniform((S,), seed, _SALT_RTS, device))
        return out

    def route(self, params: Dict[str, Any], tokens: torch.Tensor, *, train: bool = True,
              seed: Optional[torch.Tensor] = None, noise: Optional[Dict[str, torch.Tensor]] = None,
              used_token_mask: Optional[torch.Tensor] = None) -> sharded_moe.Routing:
        """The gate on ``[S, H]`` tokens: the router logits in fp32 and the
        k-specific routing (eval capacity and no noise when not ``train``)."""
        draws = self._noise(tokens.shape[0], tokens.device, seed, noise, train)
        gate_in = sharded_moe.multiplicative_jitter(tokens, draws.get("jitter"))
        logits = gate_in.float() @ params["gate"]["wg"].float()
        cf = self.capacity_factor if train else self.eval_capacity_factor
        return sharded_moe.topk_routing(logits, self.k, cf, self.min_capacity, drop_tokens=self.drop_tokens,
                                        noisy_gate_policy=self.noisy_gate_policy if train else None,
                                        use_rts=self.use_rts, used_token_mask=used_token_mask,
                                        gumbel=draws.get("gumbel"), rts_perm=draws.get("rts_perm"))

    def apply(self, params: Dict[str, Any], x: torch.Tensor, *, train: bool = True,
              seed: Optional[torch.Tensor] = None, noise: Optional[Dict[str, torch.Tensor]] = None,
              used_token_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        orig_shape = x.shape
        tokens = x.reshape(-1, orig_shape[-1])
        r = self.route(params, tokens, train=train, seed=seed, noise=noise, used_token_mask=used_token_mask)
        expert_out = apply_expert_ffn(params["experts"], sharded_moe.dispatch(tokens, r), self.activation)
        out = sharded_moe.combine(expert_out, r)
        if self.use_residual:
            mlp_out = apply_dense_ffn(params["mlp"], tokens, self.activation)
            coef = tokens.float() @ params["coefficient"]["w"].float() + params["coefficient"]["b"].float()
            coef = torch.softmax(coef, dim=-1).to(out.dtype)
            out = out * coef[..., 0:1] + mlp_out * coef[..., 1:2]
        return out.reshape(orig_shape), r.l_aux, r.exp_counts


def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    return (None,) * len(tree.shape)
