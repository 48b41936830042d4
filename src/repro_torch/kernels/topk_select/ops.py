"""Wrapper of the topk_select kernel: plain version for CPU tensors, the CUDA kernel otherwise."""
from __future__ import annotations

import torch

from .. import _build
from .ref import topk_select_ref

RANK_MAX_N = 1024  # kRankMaxN in kernel.cu: longer rows take the iterating kernel


def topk_select(dists: torch.Tensor, L: int, mark_nonfinite: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The L smallest of each row of (B, N) f32: (vals (B, L), idx (B, L) i32),
    ascending, ties to the lower position, +inf entries included. Raw
    positions by default (the beam merge and frontier pick gather by them);
    ``mark_nonfinite`` writes -1 for non-finite values (brute force, Q-Flat,
    rerank)."""
    if dists.dim() != 2 or dists.dtype != torch.float32:
        raise ValueError("topk_select: dists must be (B, N) float32")
    B, N = dists.shape
    if not 0 < L <= N:
        raise ValueError(f"topk_select: need 0 < L={L} <= N={N}")
    if dists.device.type == "cpu":
        return topk_select_ref(dists, L, mark_nonfinite)
    _build.check_cuda("topk_select", dists)
    vals = torch.empty((B, L), dtype=torch.float32, device=dists.device)
    idx = torch.empty((B, L), dtype=torch.int32, device=dists.device)
    if B == 0:
        return vals, idx
    _build.launch("repro_topk_select", dists.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                  B, N, L, int(mark_nonfinite))
    if N <= RANK_MAX_N:
        topk_select.rank_launches += 1
    else:
        topk_select.iter_launches += 1
    return vals, idx


topk_select.rank_launches = 0
topk_select.iter_launches = 0
