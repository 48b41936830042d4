"""Plain PyTorch versions of the flat_l2 kernels (dense and gathered)."""
from __future__ import annotations

import torch


def flat_l2_ref(q: torch.Tensor, x: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """q (B, D), x (N, D) f32/bf16 -> (B, N) f32: l2 = |q|^2 + |x|^2 - 2 q.x
    clamped at 0, ip = -q.x (the norm expansion of pairwise_distance)."""
    q = q.float()
    x = x.float()
    if metric == "l2":
        d = (q * q).sum(-1, keepdim=True) - 2.0 * (q @ x.T) + (x * x).sum(-1)[None, :]
        return d.clamp_min(0.0)
    return -(q @ x.T)


def flat_l2_gathered_ref(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor,
                         metric: str = "l2") -> torch.Tensor:
    """q (B, D), x (N, D), ids (B, C) -> (B, C) in the difference form of
    exact_distance: sum (q - x)^2 (ip: -q.x). Rows with id < 0 use row 0."""
    rows = x[ids.long().clamp(min=0)]  # (B, C, D)
    if metric == "l2":
        diff = q[:, None, :] - rows
        return (diff * diff).sum(-1)
    return -(q[:, None, :] * rows).sum(-1)
