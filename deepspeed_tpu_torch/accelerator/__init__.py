"""Device selection for the port.

The port runs on a CUDA card. ``resolve_device(None)`` returns ``cuda:0``
and raises when no card is visible: there is no silent CPU fallback. A
caller that wants the CPU (the tests, which hold the port against the
JAX package there) asks for it by name.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda:0`` (raises without a card); ``"cuda"`` ->
    ``cuda:0``; any explicit device string or ``torch.device`` is
    honoured as given, a CUDA one only when a card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepspeed_tpu_torch needs a CUDA device and torch.cuda.is_available() "
                "is False; pass device='cpu' explicitly to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev


__all__ = ["resolve_device"]
