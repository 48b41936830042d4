"""RobustPrune (Algorithm 3), the α-RNG rule: the port of ``repro.core.prune``.

Scanning candidates q in ascending d(p, q), a kept neighbor r dominates q (q
is dropped) iff α · d(r, q) <= d(p, q). Distances are squared L2 (or negated
IP), so for L2 the α on the metric is α² on the squared values. Pruning runs
in quantized space: the candidates' coordinates are PQ-decoded vectors.

The reference prunes one node per call (vmapped over a batch). Here every
function takes a leading batch axis; the scan over candidates is one
sequential loop over columns for the whole batch.
"""
from __future__ import annotations

import torch

from ..kernels.topk_select.ops import topk_select
from .search import mask_duplicates

INF = float("inf")


def robust_prune(cand_ids: torch.Tensor, dists_to_p: torch.Tensor, pairwise: torch.Tensor, *,
                 alpha: float, R: int, metric: str = "l2") -> torch.Tensor:
    """cand_ids (B, C) int, -1 invalid; dists_to_p (B, C); pairwise (B, C, C).
    Returns (B, R) int32 kept ids, -1 padded, in ascending-distance order."""
    B, C = cand_ids.shape
    a = torch.tensor(alpha * alpha if metric == "l2" else alpha, dtype=torch.float32)
    d = torch.where(cand_ids >= 0, dists_to_p, torch.full_like(dists_to_p, INF))
    order = torch.argsort(d, dim=1, stable=True)  # ascending; invalid sink to the end
    ds = d.gather(1, order)  # (B, C) sorted distances
    ps = pairwise.gather(1, order[:, :, None].expand(B, C, C))
    ps = ps.gather(2, order[:, None, :].expand(B, C, C))  # rows and columns sorted
    # dom[b, j, i]: kept candidate j would dominate candidate i
    dom = (a.to(ps.device) * ps) <= ds[:, None, :]
    finite = ds < INF
    kept = torch.zeros((B, C), dtype=torch.bool, device=d.device)
    count = torch.zeros((B,), dtype=torch.int32, device=d.device)
    # past the last finite candidate of every row nothing more can be kept
    n_scan = int(finite.sum(1).max()) if B else 0
    for i in range(n_scan):
        ok = finite[:, i] & ~(kept & dom[:, :, i]).any(1) & (count < R)
        kept[:, i] = ok
        count += ok.to(torch.int32)
    kept_orig = torch.zeros_like(kept).scatter(1, order, kept)

    # compact the kept ids in ascending-distance order into (B, R): the
    # smallest R of keep_d, ties to the lower original position
    keep_d = torch.where(kept_orig, d, torch.full_like(d, INF)).contiguous()
    _, take = topk_select(keep_d, min(R, C))
    take = take.long()
    out = torch.where(kept_orig.gather(1, take), cand_ids.gather(1, take).to(torch.int32),
                      torch.full(take.shape, -1, dtype=torch.int32, device=d.device))
    if out.shape[1] < R:
        out = torch.cat([out, torch.full((B, R - out.shape[1]), -1, dtype=torch.int32,
                                         device=d.device)], 1)
    return out


def prune_with_vectors(p_vec: torch.Tensor, cand_ids: torch.Tensor, cand_vecs: torch.Tensor, *,
                       alpha: float, R: int, metric: str = "l2",
                       self_id: torch.Tensor | int = -1) -> torch.Tensor:
    """RobustPrune from coordinates: p_vec (B, D), cand_ids (B, C), cand_vecs
    (B, C, D); ``self_id`` (B,) or scalar is excluded (E <- E \\ {p})."""
    valid = cand_ids >= 0
    if metric == "l2":
        diff = cand_vecs - p_vec[:, None, :]
        d_p = (diff * diff).sum(-1)
        x2 = (cand_vecs * cand_vecs).sum(-1)
        pair = x2[:, :, None] - 2.0 * torch.bmm(cand_vecs, cand_vecs.transpose(1, 2)) + x2[:, None, :]
        pair = pair.clamp_min(0.0)
    else:
        d_p = -torch.bmm(cand_vecs, p_vec[:, :, None])[..., 0]
        pair = -torch.bmm(cand_vecs, cand_vecs.transpose(1, 2))
    self_id = torch.as_tensor(self_id, device=cand_ids.device).reshape(-1, 1)
    d_p = torch.where(valid & (cand_ids != self_id), d_p, torch.full_like(d_p, INF))
    # a candidate must not duplicate an earlier one
    d_p = torch.where(mask_duplicates(cand_ids), torch.full_like(d_p, INF), d_p)
    return robust_prune(cand_ids, d_p, pair, alpha=alpha, R=R, metric=metric)
