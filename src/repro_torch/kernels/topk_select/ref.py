"""Plain PyTorch version of the topk_select kernel."""
from __future__ import annotations

import torch


def topk_select_ref(dists: torch.Tensor, L: int, mark_nonfinite: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N) f32 -> (vals (B, L) f32, idx (B, L) i32): the L smallest per row,
    ascending, ties to the lower position (a stable sort; torch.topk promises
    no tie order). With ``mark_nonfinite`` non-finite values get idx -1."""
    d = torch.where(dists == 0, torch.zeros_like(dists), dists)  # -0.0 ties +0.0
    _, order = torch.sort(d, dim=1, stable=True)
    idx = order[:, :L]
    vals = dists.gather(1, idx)
    idx = idx.to(torch.int32)
    if mark_nonfinite:
        idx = torch.where(torch.isfinite(vals), idx, torch.full_like(idx, -1))
    return vals, idx
