"""The MoE layer: gate, stacked experts and the PR-MoE residual.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (``MoE``). The router reads
``tokens.float() @ wg`` (``wg`` is kept in fp32 by the training engine,
``MoETransformerLM.keep_fp32_params``), the gate routes (``sharded_moe``),
``dispatch`` copies each kept token into its expert's slot,
``apply_expert_ffn`` runs the experts as one batched product, and
``combine`` mixes each token's expert rows back. With ``use_residual`` a
dense MLP runs beside the experts and a learned 2-way softmax mixes the
two (PR-MoE).

Across ranks the layer reads the live topology (``parallel/mesh.py``), as
JAX's reads ``_TOPOLOGY``:

* where ``a2a.ep_fast_path`` holds (an ``expert`` axis), the fast path of
  JAX ``layer.py:157-195``: each rank gates its token shard at the local
  capacity, the dispatch all-to-all, the rank's own experts, the combine
  all-to-all; ``l_aux`` is the mean of the shards' losses and
  ``exp_counts`` their sum. The wire format is the active plan's
  ``a2a_quantized`` (``runtime/zero/overlap.py``), else the layer's
  ``quantized_a2a``;
* with the tokens spread over ranks and no expert axis (data parallel
  training), the global gating of JAX's GSPMD program (``layer.py:196-214``):
  the router logits are all-gathered, every rank gates the global batch
  identically and runs only its own tokens' rows through the experts (the
  FFN is row-wise);
* with the whole batch on every rank (``apply(..., replicated=True)``,
  the inference forward) the fast path takes the rank's shard and all-gathers
  the outputs; otherwise ``apply_global`` gates the whole slab and runs
  the rank's own experts, the partial combines summed over the expert
  group (the serving programs' ``decode._moe_ffn`` too).

``ep_size`` is accepted and ignored, as in JAX (``layer.py:65-67``):
placement comes from the topology. Each rank holds experts ``[r·E/e,
(r+1)·E/e)`` of the expert leaves; given the whole stack, the layer takes
that slice itself.

Noise: in training JAX draws the jitter, the top-1 Gumbel sample, the
Random Token Selection permutation and the top-2 second-expert Gumbel
sample from the layer's rng (folded with the token-shard index on the fast
path, ``a2a.py:187-191``). Here each comes from ``noise`` (a dict the
tests fill with JAX's own draws) or, when ``seed`` (an int64 device
scalar) is given, from a counter-based hash of the seed
(``models.transformer._uniform``) whose counter holds the token's global
row (and the shard index for the permutation), which a captured CUDA graph
replays from the seed it is given. Without either (eval, or JAX's
``rng=None``) no noise is drawn, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.compression.int8 import QuantizedTensor
from deepspeed_tpu_torch.moe import a2a, sharded_moe
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


class MoE:
    """Mixture of Experts layer (functional): ``init`` draws the param
    tree, ``apply(params, x, ...)`` returns ``(output, l_aux, exp_counts)``
    as JAX's ``MoE.apply``."""

    def __init__(self, hidden_size: int, num_experts: int = 1, ep_size: int = 1, k: int = 1,
                 capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 use_residual: bool = False, noisy_gate_policy: Optional[str] = None, drop_tokens: bool = True,
                 use_rts: bool = True, intermediate_size: Optional[int] = None, activation: str = "gelu",
                 use_bias: bool = True, out_std: Optional[float] = None, quantized_a2a: bool = False):
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        # accepted for reference-API parity (layer.py:16); placement is the topology's expert axis
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
        # the int8 dispatch/combine wire; an active plan's a2a stage overrides it
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
               train: bool, row0: int = 0, shard: int = 0) -> Dict[str, torch.Tensor]:
        """The draws JAX would make in training (``noise`` given, or hashed
        from ``seed``); none in eval. ``row0`` is the global row of the
        first of the ``S`` tokens and ``shard`` keys the RTS permutation
        (an expert-parallel token shard's)."""
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
            out["jitter"] = 1.0 - _JITTER_EPS + 2.0 * _JITTER_EPS * _uniform((S, H), seed, _SALT_JITTER, device,
                                                                            row0)
        if (self.k == 1 and self.noisy_gate_policy == "RSample") or self.k == 2:
            out["gumbel"] = sharded_moe.gumbel_from_uniform(_uniform((S, E), seed, _SALT_GUMBEL, device, row0))
        if self.k == 1 and self.use_rts and self.drop_tokens:
            out["rts_perm"] = torch.argsort(_uniform((S,), seed, _SALT_RTS, device, shard))
        return out

    def _logits(self, params, tokens: torch.Tensor, draws) -> torch.Tensor:
        gate_in = sharded_moe.multiplicative_jitter(tokens, draws.get("jitter"))
        return gate_in.float() @ params["gate"]["wg"].float()

    def _gate(self, logits: torch.Tensor, train: bool, draws, used_token_mask) -> sharded_moe.Routing:
        cf = self.capacity_factor if train else self.eval_capacity_factor
        return sharded_moe.topk_routing(logits, self.k, cf, self.min_capacity, drop_tokens=self.drop_tokens,
                                        noisy_gate_policy=self.noisy_gate_policy if train else None,
                                        use_rts=self.use_rts, used_token_mask=used_token_mask,
                                        gumbel=draws.get("gumbel"), rts_perm=draws.get("rts_perm"))

    def route(self, params: Dict[str, Any], tokens: torch.Tensor, *, train: bool = True,
              seed: Optional[torch.Tensor] = None, noise: Optional[Dict[str, torch.Tensor]] = None,
              used_token_mask: Optional[torch.Tensor] = None) -> sharded_moe.Routing:
        """The gate on ``[S, H]`` tokens: the router logits in fp32 and the
        k-specific routing (eval capacity and no noise when not ``train``)."""
        draws = self._noise(tokens.shape[0], tokens.device, seed, noise, train)
        return self._gate(self._logits(params, tokens, draws), train, draws, used_token_mask)

    def _local_experts(self, experts: Dict[str, Any], topo) -> Dict[str, Any]:
        """This rank's experts ``[r·E/e, (r+1)·E/e)``: the leaves as given
        when they hold that slice, else sliced from the whole stack."""
        e = topo.axis_size("expert") if topo is not None else 1
        E = self.num_experts
        if e == 1:
            return experts
        if E % e:
            raise ValueError(f"num_experts={E} is not divisible by the expert axis ({e})")
        n = E // e

        def cut(w):
            if isinstance(w, dict):
                return {k: cut(v) for k, v in w.items()}
            lead = w.shape[0]
            if lead == n:
                return w
            if lead != E:
                raise ValueError(f"an expert leaf of {lead} experts on an expert axis of {e} over {E} experts")
            if isinstance(w, QuantizedTensor):  # int8 serving weights: the [E, 1, I] scales slice alike
                return QuantizedTensor(q=cut(w.q), scale=cut(w.scale))
            return w.narrow(0, topo.expert_rank * n, n)
        return cut(experts)

    def _quantized(self) -> bool:
        from deepspeed_tpu_torch.runtime.zero.overlap import active_plan

        plan = active_plan()
        if plan is not None and plan.a2a_quantized is not None:
            return bool(plan.a2a_quantized)
        return self.quantized_a2a

    def apply(self, params: Dict[str, Any], x: torch.Tensor, *, train: bool = True,
              seed: Optional[torch.Tensor] = None, noise: Optional[Dict[str, torch.Tensor]] = None,
              used_token_mask: Optional[torch.Tensor] = None, replicated: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(output, l_aux, exp_counts)`` of JAX ``MoE.apply`` (see the
        module docstring for the paths across ranks). ``x`` is this rank's
        token shard, or with ``replicated`` the whole batch, which every
        rank holds."""
        from deepspeed_tpu_torch.parallel.mesh import live_topology

        orig_shape = x.shape
        tokens = x.reshape(-1, orig_shape[-1])
        topo = live_topology()
        n = a2a.num_token_shards(topo) if topo is not None else 1
        if n == 1:
            out, l_aux, counts = self._apply_local(params, tokens, train, seed, noise, used_token_mask)
        else:
            S = tokens.shape[0] * (1 if replicated else n)
            if a2a.ep_fast_path(topo, self.num_experts, S):
                out, l_aux, counts = self._apply_ep(params, tokens, topo, replicated, train, seed, noise,
                                                    used_token_mask)
            elif replicated:
                out, l_aux, counts = self._apply_global(params, tokens, topo, train, seed, noise, used_token_mask)
            else:
                out, l_aux, counts = self._apply_gathered(params, tokens, topo, train, seed, noise,
                                                          used_token_mask)
        return self._residual(params, tokens, out).reshape(orig_shape), l_aux, counts

    def apply_global(self, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        """Eval-mode global gating of a whole ``[..., H]`` slab held by
        every rank (the serving programs, JAX ``decode.py:78-112``): under
        an expert axis each rank runs its own experts' capacity rows and
        the partial combines are summed over the expert group."""
        from deepspeed_tpu_torch.parallel.mesh import live_topology

        orig_shape = x.shape
        tokens = x.reshape(-1, orig_shape[-1])
        out = self._apply_global(params, tokens, live_topology(), False, None, None, None)[0]
        return self._residual(params, tokens, out).reshape(orig_shape)

    def _residual(self, params, tokens: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """PR-MoE: the dense MLP beside the experts, mixed by the learned
        2-way softmax (``out`` itself without ``use_residual``)."""
        if not self.use_residual:
            return out
        mlp_out = apply_dense_ffn(params["mlp"], tokens, self.activation)
        coef = tokens.float() @ params["coefficient"]["w"].float() + params["coefficient"]["b"].float()
        coef = torch.softmax(coef, dim=-1).to(out.dtype)
        return out * coef[..., 0:1] + mlp_out * coef[..., 1:2]

    def _apply_local(self, params, tokens, train, seed, noise, used_token_mask):
        """One rank's whole batch (JAX ``layer.py:196-214`` on one device)."""
        r = self.route(params, tokens, train=train, seed=seed, noise=noise, used_token_mask=used_token_mask)
        expert_out = apply_expert_ffn(params["experts"], sharded_moe.dispatch(tokens, r), self.activation)
        return sharded_moe.combine(expert_out, r), r.l_aux, r.exp_counts

    def _apply_ep(self, params, tokens, topo, replicated, train, seed, noise, used_token_mask):
        """The fast path (JAX ``layer.py:157-195``) on this rank's token
        shard; with replicated tokens the rank takes its shard and the
        outputs are all-gathered."""
        if replicated:
            tokens = a2a.token_shard(tokens, topo)
            if used_token_mask is not None:
                used_token_mask = a2a.token_shard(used_token_mask, topo)
        S_l = tokens.shape[0]
        draws = self._noise(S_l, tokens.device, seed, noise, train, row0=topo.rank * S_l, shard=topo.rank)
        quantized = self._quantized()
        cf = self.capacity_factor if train else self.eval_capacity_factor
        dispatched, r, l_aux, counts = a2a.ep_gate_dispatch(
            tokens, self._logits(params, tokens, draws), topo, k=self.k, capacity_factor=cf,
            min_capacity=self.min_capacity, drop_tokens=self.drop_tokens, use_rts=self.use_rts,
            noisy_gate_policy=self.noisy_gate_policy if train else None, gumbel=draws.get("gumbel"),
            rts_perm=draws.get("rts_perm"), used_token_mask=used_token_mask, quantized=quantized)
        expert_out = apply_expert_ffn(self._local_experts(params["experts"], topo), dispatched, self.activation)
        out = a2a.ep_combine(expert_out, r, topo, quantized=quantized)
        l_aux = torch.mean(a2a.gather_rows(l_aux.reshape(1)))  # the shards' mean; its gradient reaches this shard
        counts = comm.all_reduce(counts.clone())
        if replicated:
            out = a2a.gather_rows(out)
        return out, l_aux, counts

    def _apply_gathered(self, params, tokens, topo, train, seed, noise, used_token_mask):
        """Data-parallel training without an expert axis: JAX gates the
        global batch (capacity from the global S, drops in global token
        order). The router logits are all-gathered (each rank's gradient
        comes back to its own rows), every rank gates identically, and this
        rank's tokens run through the (whole) expert stack at slots
        renumbered among its own assignments."""
        S_l = tokens.shape[0]
        rows = slice(topo.rank * S_l, (topo.rank + 1) * S_l)
        draws = self._noise(S_l * a2a.num_token_shards(topo), tokens.device, seed, noise, train)  # global draws
        jitter = draws.get("jitter")
        logits = a2a.gather_rows(self._logits(params, tokens, {"jitter": None if jitter is None else jitter[rows]}))
        if used_token_mask is not None:
            used_token_mask = a2a.gather_rows(used_token_mask.detach().float())
        r = self._gate(logits, train, draws, used_token_mask)
        mine = _own_rows(r, rows, S_l)
        expert_out = apply_expert_ffn(params["experts"], sharded_moe.dispatch(tokens, mine), self.activation)
        return sharded_moe.combine(expert_out, mine), r.l_aux, r.exp_counts

    def _apply_global(self, params, tokens, topo, train, seed, noise, used_token_mask):
        """Global gating of replicated tokens; under an expert axis this
        rank's experts only, the fp32 partial combines all-reduced over the
        expert group and cast once (bit for bit the one-rank sum at k <= 2:
        the missing terms are exact zeros)."""
        r = self.route(params, tokens, train=train, seed=seed, noise=noise, used_token_mask=used_token_mask)
        e = topo.axis_size("expert") if topo is not None else 1
        if e == 1:
            expert_out = apply_expert_ffn(params["experts"], sharded_moe.dispatch(tokens, r), self.activation)
            return sharded_moe.combine(expert_out, r), r.l_aux, r.exp_counts
        experts = self._local_experts(params["experts"], topo)
        n = self.num_experts // e
        lo = topo.expert_rank * n
        local = r._replace(expert=r.expert - lo, kept=r.kept & (r.expert >= lo) & (r.expert < lo + n),
                           num_experts=n)
        expert_out = apply_expert_ffn(experts, sharded_moe.dispatch(tokens, local), self.activation)
        part = sharded_moe.combine(expert_out, local, cast=False)
        out = comm.all_reduce(part, group=topo.expert_group).to(expert_out.dtype)
        return out, r.l_aux, r.exp_counts


def _own_rows(r: sharded_moe.Routing, rows: slice, S_l: int) -> sharded_moe.Routing:
    """The assignments of the tokens ``rows`` of a global routing, their
    slots renumbered among this rank's kept assignments of each expert (in
    token, then choice order) within a capacity of ``min(C, S_l)`` (a token
    takes an expert at most once)."""
    expert, kept = r.expert[rows], r.kept[rows]
    onehot = (expert.reshape(-1)[:, None] == torch.arange(r.num_experts, device=expert.device)) \
        & kept.reshape(-1)[:, None]
    onehot = onehot.to(torch.int64)
    slot = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=1).reshape(expert.shape)
    return r._replace(expert=expert, slot=slot, weight=r.weight[rows], kept=kept, capacity=min(r.capacity, S_l))


def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    return (None,) * len(tree.shape)
