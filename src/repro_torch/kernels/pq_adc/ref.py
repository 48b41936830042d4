"""Plain PyTorch version of the pq_adc kernel (the CPU path and the card's yardstick)."""
from __future__ import annotations

from typing import Optional

import torch


def pq_adc_ref(luts: torch.Tensor, codes: torch.Tensor, versions: torch.Tensor,
               ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """luts (B, V, M, K) f32, codes (N, M) u8, versions (N,) u8, ids (B, C) i32
    or None (dense: every row) -> (B, C) f32. Rows with id < 0 are computed
    from row 0; the caller masks them."""
    B, V, M, K = luts.shape
    if ids is None:
        # dense: one (B, N) gather per subspace keeps memory at O(B*N)
        base = versions.long().clamp(max=V - 1) * K
        out = torch.zeros((B, codes.shape[0]), dtype=torch.float32, device=luts.device)
        for m in range(M):
            out += luts[:, :, m, :].reshape(B, V * K)[:, base + codes[:, m].long()]
        return out
    rows = ids.long().clamp(min=0)
    c = codes[rows].long()  # (B, C, M)
    v = versions[rows].long().clamp(max=V - 1)  # (B, C)
    index = v[..., None] * (M * K) + torch.arange(M, device=luts.device) * K + c
    flat = luts.reshape(B, V * M * K)
    return flat.gather(1, index.reshape(B, -1)).reshape(c.shape).sum(-1)
