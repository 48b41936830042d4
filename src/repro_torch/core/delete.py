"""In-place delete (Algorithm 6) and the background consolidation sweep: the
port of ``repro.core.delete``.

Alg 6, for a node p already marked dead:
  * B = in-neighbours of p found within p's two-hop out-neighbourhood;
  * every b in B: drop p, splice in the c closest of N_out(p) to b, prune if
    over the degree bound;
  * every b in N_out(p): link b to its closest sibling in N_out(p);
  * ``consolidate_chunk`` later erases the edges to dead nodes that remain.

The reference runs each of the two loops as a ``lax.scan``. A step reads and
writes row b alone, and ``live``, the coordinates and N_out(p) are fixed for
the call, so steps of distinct b commute. A repeated b is a no-op in the
scan: in the first loop its first step removed p, and no step puts p back (p
is dead, so it is never among the spliced ids); in the second loop its first
step left its sibling in the row or found the row full. So each loop here is
one batch over the distinct b, which gives the scan's graph. The second loop
reads the rows the first wrote.

Kernels: the distances from the batch's b to N_out(p) are one
``flat_l2_gathered`` launch per loop, over the decoded rows of N_out(p); the
c closest one ``topk_select`` launch; rows that overflow go through
``prune.prune_with_vectors`` as one batch.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels.flat_l2.ops import flat_l2_gathered
from ..kernels.topk_select.ops import topk_select
from .prune import prune_with_vectors
from .search import mask_duplicates

INF = float("inf")

# ids (any shape; -1 reads row 0) -> their coordinates (..., D)
Rows = Callable[[torch.Tensor], torch.Tensor]


def compact_left(rows: torch.Tensor) -> torch.Tensor:
    """Each row's ids >= 0 moved to its front in their order (a stable
    partition), the -1 after them."""
    order = torch.argsort((rows < 0).to(torch.int8), dim=1, stable=True)
    return rows.gather(1, order)


def _closest(vectors: Rows, b: torch.Tensor, nout_p: torch.Tensor, valid_out: torch.Tensor,
             out_vecs: torch.Tensor, c: int, metric: str) -> torch.Tensor:
    """(len(b), c) ids: the c members of N_out(p) closest to each b, live and
    other than b, ties to the lower position; -1 where fewer qualify."""
    B, R_slack = b.shape[0], nout_p.shape[0]
    cols = torch.arange(R_slack, dtype=torch.int32, device=b.device).expand(B, R_slack)
    d = flat_l2_gathered(vectors(b), out_vecs, cols.contiguous(), metric)
    d = torch.where(valid_out[None, :] & (nout_p[None, :] != b[:, None]), d,
                    torch.full_like(d, INF))
    vals, pos = topk_select(d.contiguous(), c)
    return torch.where(torch.isfinite(vals), nout_p[pos.long()], torch.full_like(pos, -1))


def _live_distinct(ids: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    b = torch.unique(ids[ids >= 0])
    return b[live[b.long()]]


def inplace_delete(neighbors: torch.Tensor, live: torch.Tensor, vectors: Rows, p: int, *,
                   R: int, R_slack: int, alpha: float, c_replace: int = 3,
                   metric: str = "l2") -> torch.Tensor:
    """Rewire the graph around the deleted node p (``live[p]`` already
    False). ``vectors`` maps ids to the coordinates the reference prunes with
    (decoded PQ rows), so only the rows the call reads are decoded. Returns
    the new neighbors (N, R_slack) as a new tensor."""
    p = int(p)
    nb = neighbors.clone()
    nout_p = neighbors[p]  # (R_slack,)
    safe_out = nout_p.long().clamp(min=0)
    valid_out = (nout_p >= 0) & live[safe_out]
    out_vecs = vectors(nout_p).contiguous()  # (R_slack, D)

    # the hood: N_out(p) and its live members' rows, p itself left out
    twohop = torch.where(valid_out[:, None], neighbors[safe_out], -1).reshape(-1)
    hood = torch.cat([nout_p, twohop])
    hood = torch.where(hood == p, -1, hood)

    # -- first loop: every live b of the hood whose row holds p -----------
    b = _live_distinct(hood, live)
    b = b[(nb[b.long()] == p).any(1)]
    if b.numel():
        bl = b.long()
        no_p = compact_left(torch.where(nb[bl] == p, -1, nb[bl]))
        merged = torch.cat([no_p, _closest(vectors, b, nout_p, valid_out, out_vecs, c_replace,
                                           metric)], 1)  # (B, R_slack + c)
        # the reference's degree: valid entries less the equal pairs among them
        n = merged.shape[1]
        pairs = ((merged[:, :, None] == merged[:, None, :]) & (merged[:, :, None] >= 0)
                 & torch.ones((n, n), dtype=torch.bool, device=nb.device).tril(-1))
        deg_merged = (merged >= 0).sum(1) - pairs.sum((1, 2))
        use_prune = deg_merged > R_slack
        # no prune: the first R_slack distinct entries of merged
        new = compact_left(torch.where(mask_duplicates(merged), -1, merged))[:, :R_slack]
        if bool(use_prune.any()):
            pb, pm = b[use_prune], merged[use_prune]
            pruned = prune_with_vectors(vectors(pb), pm, vectors(pm), alpha=alpha, R=R,
                                        metric=metric, self_id=pb)
            new[use_prune] = torch.cat([pruned, torch.full((pb.shape[0], R_slack - R), -1,
                                                           dtype=torch.int32, device=nb.device)], 1)
        nb[bl] = new.to(nb.dtype)

    # -- second loop: link each live member of N_out(p) to its closest sibling
    s = _live_distinct(nout_p, live)
    if s.numel():
        sl = s.long()
        sib = _closest(vectors, s, nout_p, valid_out, out_vecs, 1, metric)[:, 0]
        rows = nb[sl]
        deg = (rows >= 0).sum(1)
        can = ~((rows == sib[:, None]).any(1) | (sib < 0)) & (deg < R_slack)
        put = torch.arange(R_slack, device=nb.device)[None, :] == deg[:, None]
        nb[sl] = torch.where(put & can[:, None], sib[:, None].to(nb.dtype), rows)

    nb[p] = -1
    return nb


def consolidate_chunk(neighbors: torch.Tensor, live: torch.Tensor, start_row: int,
                      chunk: int = 1024) -> torch.Tensor:
    """Background sweep (§2.1): erase edges to dead nodes in rows
    [start_row, start_row + chunk), compacting left; rows past the end clip
    to the last row, as in the reference. Returns a new tensor."""
    rows = (int(start_row) + torch.arange(chunk, device=neighbors.device)).clamp(
        max=neighbors.shape[0] - 1)
    block = neighbors[rows]
    dead = ~live[block.long().clamp(min=0)] | (block < 0)
    out = neighbors.clone()
    out[rows] = compact_left(torch.where(dead, -1, block))
    return out
