"""Device choice for the port (the role ``repro/compat.py`` plays for JAX).

Entry points take ``device=None`` to mean the CUDA card. Without a card
that raises: the port never carries on quietly on the CPU. The CPU is used
only when the caller asks for it (``device="cpu"``), as the tests do; there
every kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; any CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
