"""Brute force, Q-Flat and full-precision rerank (§3 "System Design"): the
port of ``repro.core.flat``.

The planner escalates through brute force over documents (< ~1000 docs),
Q-Flat -- an exhaustive scan in quantized space plus rerank (< ~5000
matches) -- and graph search. ``rerank`` (Fig 5) is shared by Q-Flat and the
graph path: k' = multiplier * k candidates are re-scored with full-precision
vectors and cut to k.

Kernels: ``flat_l2`` (dense for brute force, gathered difference form for
rerank), ``pq_adc`` (dense form for Q-Flat), ``topk_select`` for every cut.
When fewer than k (k') entries pass, the rest come back as -1 / +inf.
"""
from __future__ import annotations

import torch

from ..kernels.flat_l2.ops import flat_l2, flat_l2_gathered
from ..kernels.pq_adc.ops import pq_adc
from ..kernels.topk_select.ops import topk_select
from .search import mask_duplicates

INF = float("inf")

# §3.5 defaults
QUANTIZED_LIST_MULTIPLIER = 5.0  # k' = multiplier * k candidates to re-rank
BRUTE_FORCE_MAX_DOCS = 1000
QFLAT_MAX_MATCHES = 5000


def brute_force(queries: torch.Tensor, vectors: torch.Tensor, live: torch.Tensor, *,
                k: int, metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by scanning the document store: (B, k) ids (int32), dists.

    When fewer than k entries pass ``live`` (a selective predicate mask), the
    remainder comes back as -1/inf -- never as a masked-out document."""
    d = flat_l2(queries.float().contiguous(), vectors, metric)
    d = torch.where(live[None, :], d, torch.full_like(d, INF))
    vals, idx = topk_select(d, k, mark_nonfinite=True)
    return idx, vals


def qflat_scan(luts: torch.Tensor, codes: torch.Tensor, versions: torch.Tensor,
               live: torch.Tensor, *, kprime: int, metric: str = "l2",
               filter_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive scan in quantized space: top-k' candidates per query.
    luts (B, V, M, K); ``filter_mask`` (B, N) bool optionally restricts rows.
    Fewer matches than k' pad with -1, or the rerank would re-score
    filtered-out documents and let them win."""
    del metric  # the LUTs already encode it
    d = pq_adc(luts.contiguous(), codes, versions)  # (B, N)
    d = torch.where(live[None, :], d, torch.full_like(d, INF))
    if filter_mask is not None:
        d = torch.where(filter_mask, d, torch.full_like(d, INF))
    vals, idx = topk_select(d, kprime, mark_nonfinite=True)
    return idx, vals


def rerank(queries: torch.Tensor, cand_ids: torch.Tensor, vectors: torch.Tensor, *,
           k: int, metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Fig 5: exact re-ranking of quantized-space candidates (B, C), -1 padded.
    Duplicate and -1 candidates are excluded. Returns (ids (B, k), dists)."""
    ids = cand_ids.to(torch.int32).contiguous()
    d = flat_l2_gathered(queries.float().contiguous(), vectors, ids, metric)
    keep = (ids >= 0) & ~mask_duplicates(ids)
    d = torch.where(keep, d, torch.full_like(d, INF))
    vals, pos = topk_select(d, k)
    out = ids.gather(1, pos.long())
    return torch.where(torch.isfinite(vals), out, torch.full_like(out, -1)), vals
