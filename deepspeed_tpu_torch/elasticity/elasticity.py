"""The elastic batch math the serving fleet's resize policy needs.

The port's copy of ``get_valid_gpus`` from
``deepspeed_tpu/elasticity/elasticity.py`` (reference elasticity.py:64);
the rest of the elastic training config is not ported yet.
"""

from __future__ import annotations

from typing import List


def _all_divisors(n: int) -> List[int]:
    out = []
    i = 1
    while i * i <= n:
        if n % i == 0:
            out.append(i)
            if i != n // i:
                out.append(n // i)
        i += 1
    return sorted(out)


def get_valid_gpus(batch_size: int, micro_batches: List[int], min_valid_gpus: int, max_valid_gpus: int) -> List[int]:
    """Chip counts g such that ``batch_size % (micro * g) == 0`` for some
    micro batch, within ``[min_valid_gpus, max_valid_gpus]``."""
    valid_gpus = set()
    for micro_batch in micro_batches:
        if batch_size % micro_batch != 0:
            continue
        max_gpus = batch_size // micro_batch
        for div in _all_divisors(max_gpus):
            if min_valid_gpus <= div <= max_valid_gpus:
                valid_gpus.add(div)
    return sorted(valid_gpus)
