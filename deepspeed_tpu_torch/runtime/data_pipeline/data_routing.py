"""Random layerwise token dropping (random-LTD).

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/data_routing.py``:
during training the middle layers each run on a random, sorted subset of
the tokens; the others ride the residual stream past the layer and are
scattered back, and the scheduler grows the kept count to the full length.

The index draw takes a ``torch.Generator`` on the caller's device (JAX's
``jax.random`` bits cannot be matched, so tests hand JAX's own indices to
the port's functions). Gather and scatter are ``torch.gather`` and a
scatter into a copy, as JAX computes them outside any kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


class RandomLTDScheduler:
    """Kept-token schedule (JAX ``RandomLTDScheduler``): linear from
    ``start_token_num`` to ``max_token_num`` over ``total_steps``, in steps
    of ``step_size``, snapped to the full length at the end."""

    def __init__(self, start_token_num: int, max_token_num: int, total_steps: int, step_size: int = 16):
        self.start = start_token_num
        self.max = max_token_num
        self.total = max(total_steps, 1)
        self.step_size = step_size
        self.current = start_token_num

    def update(self, global_step: int) -> int:
        frac = min(1.0, global_step / self.total)
        if frac >= 1.0:
            self.current = self.max
            return self.current
        n = self.start + (self.max - self.start) * frac
        n = int(n // self.step_size) * self.step_size
        self.current = max(self.start, min(self.max, n))
        return self.current

    def state_dict(self) -> Dict[str, Any]:
        return {"current": self.current}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.current = sd["current"]


def sample_layer_token_indices(generator: Optional[torch.Generator], n_layers: int, batch: int, seq_len: int,
                               kept: int, device=None) -> torch.Tensor:
    """``[n_layers, B, kept]`` sorted random token indices (int64), each
    layer its own subset, drawn in one call: uniform scores, the ``kept``
    smallest, sorted so that position order (and causality) holds."""
    device = generator.device if generator is not None else device
    scores = torch.rand((n_layers, batch, seq_len), generator=generator, device=device)
    idx = torch.topk(-scores, kept, dim=-1).indices
    return torch.sort(idx, dim=-1).values


def random_token_select(generator: Optional[torch.Generator], seq_len: int, kept: int, batch: int,
                        device=None) -> torch.Tensor:
    """``[B, kept]``: the one-layer form of ``sample_layer_token_indices``."""
    return sample_layer_token_indices(generator, 1, batch, seq_len, kept, device=device)[0]


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[B, T, H]`` × ``[B, kept]`` → ``[B, kept, H]``."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def scatter_tokens(full: torch.Tensor, processed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``full`` with the processed rows written back at ``idx``; the other
    rows keep the bypass value (out of place, differentiable in both)."""
    return full.scatter(1, idx.long()[..., None].expand(-1, -1, full.shape[-1]), processed.to(full.dtype))


class RandomLayerTokenDrop:
    """Wrap a layer function so that it runs on a random token subset in
    training (JAX ``RandomLayerTokenDrop``)."""

    def __init__(self, layer_fn, scheduler: RandomLTDScheduler):
        self.layer_fn = layer_fn
        self.scheduler = scheduler

    def __call__(self, params, x: torch.Tensor, generator: Optional[torch.Generator] = None, train: bool = True,
                 idx: Optional[torch.Tensor] = None, **kwargs):
        kept = self.scheduler.current
        T = x.shape[1]
        if not train or kept >= T:
            return self.layer_fn(params, x, **kwargs)
        if idx is None:
            idx = random_token_select(generator, T, kept, x.shape[0], device=x.device)
        out = self.layer_fn(params, gather_tokens(x, idx), **kwargs)
        return scatter_tokens(x, out, idx)
