"""Plain PyTorch version of the pq_encode kernel (the arithmetic of repro.core.pq.encode)."""
from __future__ import annotations

import torch


def pq_encode_ref(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """x (N, D) f32, codebooks (M, K, dsub) f32 -> codes (N, M) u8:
    argmin_k |x_m|^2 - 2 x_m.c_mk + |c_mk|^2, ties to the first index."""
    N = x.shape[0]
    M, K, dsub = codebooks.shape
    sub = x.reshape(N, M, dsub)
    d = ((sub * sub).sum(-1, keepdim=True)
         - 2.0 * torch.einsum("nmd,mkd->nmk", sub, codebooks)
         + (codebooks * codebooks).sum(-1)[None])
    return d.argmin(-1).to(torch.uint8)
