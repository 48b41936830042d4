"""Insert (Algorithm 2) and MiniBatchInsert (Algorithm 5): the port of
``repro.core.insert``.

  * ``insert_candidates`` / ``prune_batch``: the batched search and prune
    that the host-side orchestrator (``index.py``) uses; it applies the
    reverse edges as one consolidated append per touched node.
  * ``insert_batch_jit``: the reference's single-program mini-batch insert
    (reverse edges applied one at a time, pruning on overflow), kept under
    its name so the two packages mirror each other.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import pq as pqmod
from . import prune as prmod
from . import search as smod


class InsertStats(NamedTuple):
    hops: torch.Tensor  # (B,) search hops per inserted vector
    cmps: torch.Tensor  # (B,) quantized distance comparisons per insert


def insert_candidates(neighbors, codes, versions, live, schemas_codebooks: torch.Tensor,
                      new_vecs: torch.Tensor, medoid: int, *, L_build: int,
                      max_hops: int = 0, metric: str = "l2"):
    """Search phase of Alg 2 for a mini-batch: the candidate pool (visited ∪
    beam) per new vector, ids (B, C) and dists (B, C). ``schemas_codebooks``
    is (V, M, K, dsub), the coexisting schemas stacked."""
    schemas = [pqmod.PQSchema(codebooks=schemas_codebooks[v], version=v)
               for v in range(schemas_codebooks.shape[0])]
    luts = pqmod.multi_lut(schemas, new_vecs, metric)
    res = smod.batch_greedy_search(neighbors, codes, versions, live, luts, medoid,
                                   L=L_build, max_hops=max_hops)
    cand_ids, cand_dists = smod.search_candidates(res)
    return cand_ids, cand_dists, InsertStats(hops=res.n_hops, cmps=res.n_cmps)


def decode_rows(codes: torch.Tensor, versions: torch.Tensor, schemas_codebooks: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """Quantized-space coordinates of rows ids (...,): each row decoded with
    its own schema version -> (..., D). ids < 0 decode row 0."""
    safe = ids.long().clamp(min=0)
    c = codes[safe].long()  # (..., M)
    v = versions[safe].long()  # (...)
    M = codes.shape[1]
    picked = schemas_codebooks[v[..., None], torch.arange(M, device=codes.device), c]
    return picked.reshape(*ids.shape, -1)  # (..., M * dsub)


def prune_batch(codes, versions, schemas_codebooks, new_vecs, cand_ids, *, R: int,
                alpha: float, metric: str = "l2") -> torch.Tensor:
    """Prune phase of Alg 2 (quantized-space prune, §3.2): (B, R) ids."""
    cand_vecs = decode_rows(codes, versions, schemas_codebooks, cand_ids)
    return prmod.prune_with_vectors(new_vecs, cand_ids, cand_vecs, alpha=alpha, R=R,
                                    metric=metric)


def insert_batch_jit(neighbors, codes, versions, live, schemas_codebooks: torch.Tensor,
                     new_vecs: torch.Tensor, slots: torch.Tensor, medoid: int, *, L_build: int,
                     R: int, R_slack: int, alpha: float, metric: str = "l2", max_hops: int = 0):
    """One mini-batch insert. Phase 1: candidates and prune for every new
    node (Alg 5 lines 1-5), with the new codes registered first. Phase 2: the
    B x R reverse edges (new node p -> each chosen b), appending p to b's row
    or, when the row is full, pruning it with p to R. Returns new (neighbors,
    codes, versions, live, stats); the inputs are left as they were.

    The reference applies the edges one at a time. An edge reads and writes
    row b alone (codes and versions are fixed by then), so edges to distinct
    b are independent and only the order within one b matters: the edges
    are grouped by b, each group in its order, and the k-th edges of all
    groups are applied as one batch."""
    neighbors, codes, versions, live = (t.clone() for t in (neighbors, codes, versions, live))
    slots = slots.long()
    B = new_vecs.shape[0]
    newest = schemas_codebooks.shape[0] - 1
    codes[slots] = pqmod.encode(pqmod.PQSchema(schemas_codebooks[newest], newest), new_vecs)
    versions[slots] = newest

    cand_ids, _, stats = insert_candidates(neighbors, codes, versions, live, schemas_codebooks,
                                           new_vecs, medoid, L_build=L_build,
                                           max_hops=max_hops, metric=metric)
    nbrs = prune_batch(codes, versions, schemas_codebooks, new_vecs, cand_ids, R=R,
                       alpha=alpha, metric=metric)  # (B, R)
    pad = torch.full((B, R_slack - R), -1, dtype=torch.int32, device=nbrs.device)
    neighbors[slots] = torch.cat([nbrs, pad], 1)
    live[slots] = True

    dst = nbrs.reshape(-1).long()
    src = slots.repeat_interleave(R)
    keep = dst >= 0
    dst, src = dst[keep], src[keep]
    order = torch.argsort(dst, stable=True)
    dst, src = dst[order], src[order]
    first = torch.searchsorted(dst, dst)  # the position of each group's first edge
    rank = torch.arange(dst.shape[0], device=dst.device) - first
    cols = torch.arange(R_slack, device=dst.device)
    for k in range(int(rank.max()) + 1 if dst.numel() else 0):
        b, p = dst[rank == k], src[rank == k].to(torch.int32)
        row = neighbors[b]
        deg = (row >= 0).sum(1)
        fresh = ~(row == p[:, None]).any(1)
        append = fresh & (deg < R_slack)
        new = torch.where(append[:, None] & (cols[None, :] == deg[:, None]), p[:, None], row)
        over = fresh & (deg >= R_slack)
        if bool(over.any()):
            cand = torch.cat([row[over], p[over, None]], 1)  # (n, R_slack + 1)
            pruned = prmod.prune_with_vectors(
                decode_rows(codes, versions, schemas_codebooks, b[over]), cand,
                decode_rows(codes, versions, schemas_codebooks, cand), alpha=alpha, R=R,
                metric=metric, self_id=b[over])
            new[over] = torch.cat([pruned, torch.full_like(pruned[:, :1], -1).expand(
                -1, R_slack - R)], 1)
        neighbors[b] = new
    return neighbors, codes, versions, live, stats
