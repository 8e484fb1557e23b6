"""Token sampling: greedy, temperature, top-k, top-p.

Counterpart of ``deepspeed_tpu/inference/sampling.py``. The filters are
tensor transforms with the JAX functions' semantics (one descending sort
serves both filters; HF order, top-k first and top-p over the k-filtered
distribution). The draw is Gumbel-max, the argmax of the filtered logits
plus Gumbel noise, which is what ``jax.random.categorical`` computes; the
noise comes from an explicit ``torch.Generator`` (there is no global RNG),
so it cannot reproduce ``jax.random``'s bits, only its distribution.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _nucleus_cutoff(sorted_desc: torch.Tensor, p: float) -> torch.Tensor:
    """Smallest logit inside the nucleus of a descending-sorted row."""
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # shifting the comparison by one slot keeps the boundary token
    keep = (cum - probs) < p
    keep[..., 0] = True  # the top token always survives
    kept_logits = sorted_desc.masked_fill(~keep, float("inf"))
    return kept_logits.min(dim=-1, keepdim=True).values


def apply_filters(logits: torch.Tensor, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Mask logits outside the top-k / nucleus with ``NEG_INF`` (HF order:
    top-k first, then top-p over the k-filtered distribution)."""
    if top_k <= 0 and top_p >= 1.0:
        return logits
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    if top_k > 0:
        k = min(top_k, logits.shape[-1])
        cutoff = sorted_desc[..., k - 1 : k]
        sorted_desc = sorted_desc.masked_fill(sorted_desc < cutoff, NEG_INF)
    if top_p < 1.0:
        # the nucleus cutoff is >= the kth value, so it subsumes top-k's
        cutoff = _nucleus_cutoff(sorted_desc, top_p)
    return logits.masked_fill(logits < cutoff, NEG_INF)


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit (per row)."""
    return apply_filters(logits, top_k=k)


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the sorted distribution
    whose cumulative probability reaches ``p`` (the top token always
    survives, even when ``p`` is 0 or its probability alone exceeds it)."""
    return apply_filters(logits, top_p=p)


def _gumbel_argmax(filtered: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The categorical draw given its Gumbel noise: ``argmax(filtered +
    noise)`` over the last axis (the first maximum on ties)."""
    return torch.argmax(filtered + noise.to(filtered.dtype), dim=-1)


def _gumbel(shape, dtype, device, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in
    ``[tiny, 1)`` of ``dtype``, as ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def sample_logits(
    logits: torch.Tensor,  # [B, V]
    generator: Optional[torch.Generator],
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Next-token ids ``[B]``. ``temperature <= 0`` (or no generator) is
    greedy; otherwise filter through ``apply_filters`` and draw with
    Gumbel-max from ``generator``, which advances."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)
    filtered = apply_filters(logits / temperature, top_k, top_p)
    return _gumbel_argmax(filtered, _gumbel(filtered.shape, filtered.dtype, filtered.device, generator))
