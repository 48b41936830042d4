"""Insert (Algorithm 2) and the parallel half of MiniBatchInsert (Algorithm 5):
the port of ``repro.core.insert``'s ``insert_candidates`` and ``prune_batch``.

The host-side orchestrator (``index.py``) applies the reverse edges as one
consolidated append per touched node. The reference's fully fused
``insert_batch_jit`` is not part of this port yet.
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
