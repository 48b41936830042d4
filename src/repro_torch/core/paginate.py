"""Paginated search (§3.2, Fig 3): the port of ``repro.core.paginate``.

Two queues -- ``best`` (size L, as in greedy search) and ``backup`` (bounded
at ``backup_cap``, with the candidates it drops counted) -- and a visited set
that persists across pages, so pages never repeat a result. Each page:
refill ``best`` from ``backup``, expand until every entry of ``best`` is
expanded, pop the top k as the page.

A round is the same W-way hop as the greedy search (``search.frontier_topw``
and ``search.expand_frontier``, batch of one), and the loop makes one host
sync per round, as ``batch_greedy_search`` does. Every sort of the reference
is a stable ``jnp.argsort`` whose whole output is used; its port is
``topk_select`` keeping every entry, which ties to the lower position, so it
is the same stable sort. The backup cut (``lax.top_k`` of the negated
distances) is ``topk_select`` keeping ``backup_cap``.

``PageState`` keeps the reference's fields, as device tensors with its
dtypes, except the visited bitmap: int64 tensors holding the reference's
uint32 words (``graph.bitmap_to_numpy`` / ``bitmap_from_numpy`` convert them
bit for bit).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.pq_adc.ops import pq_adc
from ..kernels.topk_select.ops import topk_select
from . import graph as g
from . import search as smod

INF = float("inf")


class PageState(NamedTuple):
    best_ids: torch.Tensor  # (L,) int32
    best_dists: torch.Tensor  # (L,) f32
    best_expanded: torch.Tensor  # (L,) bool
    backup_ids: torch.Tensor  # (Bcap,) int32, ascending distance
    backup_dists: torch.Tensor
    backup_expanded: torch.Tensor
    bitmap: torch.Tensor  # (words,) int64: the visited set, kept across pages
    hops: torch.Tensor  # () int32
    cmps: torch.Tensor  # () int32
    exp: torch.Tensor  # () int32 adjacency rows fetched (= hops·W̄; RU-relevant)
    dropped: torch.Tensor  # () int32 candidates lost to the backup capacity bound


def _sorted(d: torch.Tensor, keep: Optional[int] = None) -> torch.Tensor:
    """Positions of the ``keep`` (default all) smallest of d (n,), ascending,
    ties to the lower position: a stable argsort."""
    _, pos = topk_select(d[None].contiguous(), keep or d.shape[0])
    return pos[0].long()


def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def start_pagination(capacity: int, L: int, backup_cap: int, codes: torch.Tensor,
                     versions: torch.Tensor, luts: torch.Tensor, start: int) -> PageState:
    """The state before the first page: ``start`` alone in ``best``; luts
    (V, M, K) of the query."""
    dev = codes.device
    start_ids = torch.full((1, 1), int(start), dtype=torch.int32, device=dev)
    start_d = pq_adc(luts[None].contiguous(), codes, versions, start_ids)[0, 0]
    best_ids = torch.full((L,), -1, dtype=torch.int32, device=dev)
    best_ids[0] = int(start)
    best_dists = torch.full((L,), INF, dtype=torch.float32, device=dev)
    best_dists[0] = start_d
    best_expanded = torch.ones((L,), dtype=torch.bool, device=dev)
    best_expanded[0] = False
    return PageState(
        best_ids=best_ids, best_dists=best_dists, best_expanded=best_expanded,
        backup_ids=torch.full((backup_cap,), -1, dtype=torch.int32, device=dev),
        backup_dists=torch.full((backup_cap,), INF, dtype=torch.float32, device=dev),
        backup_expanded=torch.ones((backup_cap,), dtype=torch.bool, device=dev),
        bitmap=g.bitmap_or_new(g.bitmap_init(capacity, 1, dev), start_ids)[0],
        hops=_scalar(0, dev), cmps=_scalar(1, dev), exp=_scalar(0, dev),
        dropped=_scalar(0, dev),
    )


def _refill(st: PageState, L: int) -> PageState:
    """Sort best and backup together: the first L are the new best."""
    ids = torch.cat([st.best_ids, st.backup_ids])
    d = torch.cat([st.best_dists, st.backup_dists])
    e = torch.cat([st.best_expanded, st.backup_expanded])
    order = _sorted(d)
    ids, d, e = ids[order], d[order], e[order]
    return st._replace(
        best_ids=ids[:L], best_dists=d[:L], best_expanded=torch.where(ids[:L] >= 0, e[:L], True),
        backup_ids=ids[L:], backup_dists=d[L:], backup_expanded=e[L:])


def _round(st: PageState, neighbors, codes, versions, live, luts, filter_bits, beta: float,
           W: int) -> PageState:
    """Expand the W best unexpanded entries of best; what falls out of best
    goes to backup, which keeps its best ``backup_cap``."""
    L, Bcap = st.best_ids.shape[0], st.backup_ids.shape[0]
    ids, d = st.best_ids[None], st.best_dists[None]
    p_pos, p_valid = smod.frontier_topw(ids, d, st.best_expanded[None], W)
    p_ids = ids.gather(1, p_pos)
    expanded = st.best_expanded.scatter(0, p_pos[0], True)
    cand_ids, cand_d, bitmap, n_new = smod.expand_frontier(
        neighbors, codes, versions, live, luts, st.bitmap[None], p_ids, p_valid,
        filter_bits, beta)

    # both slices of the sort are used: the first L stay in best, the rest
    # (the vertices popped out of best) go to backup
    all_ids = torch.cat([st.best_ids, cand_ids[0]])
    all_d = torch.cat([st.best_dists, cand_d[0]])
    all_e = torch.cat([expanded, torch.zeros(cand_ids.shape[1], dtype=torch.bool,
                                             device=expanded.device)])
    order = _sorted(all_d)
    all_ids, all_d, all_e = all_ids[order], all_d[order], all_e[order]
    bk_ids = torch.cat([st.backup_ids, all_ids[L:]])
    bk_d = torch.cat([st.backup_dists, all_d[L:]])
    bk_e = torch.cat([st.backup_expanded, all_e[L:]])
    bo = _sorted(bk_d, Bcap)
    lost = torch.isfinite(bk_d).sum() - torch.isfinite(bk_d[bo]).sum()
    return st._replace(
        best_ids=all_ids[:L], best_dists=all_d[:L],
        best_expanded=torch.where(all_ids[:L] >= 0, all_e[:L], True),
        backup_ids=bk_ids[bo], backup_dists=bk_d[bo], backup_expanded=bk_e[bo],
        bitmap=bitmap[0], hops=st.hops + 1, cmps=st.cmps + n_new[0],
        exp=st.exp + p_valid.sum(dtype=torch.int32), dropped=st.dropped + lost.to(torch.int32))


def next_page(neighbors: torch.Tensor, codes: torch.Tensor, versions: torch.Tensor,
              live: torch.Tensor, luts: torch.Tensor, state: PageState, *, k: int,
              max_hops: int = 512, filter_bits: Optional[torch.Tensor] = None,
              beta: float = 1.0, beam_width: int = 1
              ) -> tuple[torch.Tensor, torch.Tensor, PageState]:
    """The next k results: (ids (k,) int32, dists (k,), state). luts (V, M, K)
    of the query; ``filter_bits`` (words,) int64, the packed filter of a
    β-biased traversal, or None."""
    L = state.best_ids.shape[0]
    W = int(beam_width)
    if not 1 <= W <= L:
        raise ValueError(f"beam_width {W} must be in [1, L={L}]")
    luts = luts[None].contiguous()
    if filter_bits is not None:
        filter_bits = filter_bits.reshape(1, -1)

    st = _refill(state, L)
    for _ in range(max_hops):  # hops rises by one a round, so this is hops < hop_limit
        if not bool(((~st.best_expanded) & (st.best_ids >= 0)).any()):
            break
        st = _round(st, neighbors, codes, versions, live, luts, filter_bits, beta, W)

    # pop the top k as the page; the rest of best stays, re-padded
    order = _sorted(st.best_dists)
    ids_sorted, d_sorted = st.best_ids[order], st.best_dists[order]
    res_d = d_sorted[:k]
    res_ids = torch.where(torch.isfinite(res_d), ids_sorted[:k], -1)
    remaining_ids, remaining_d = ids_sorted.clone(), d_sorted.clone()
    remaining_e = st.best_expanded[order]
    remaining_ids[:k] = -1
    remaining_d[:k] = INF
    remaining_e[:k] = True
    st = st._replace(best_ids=remaining_ids, best_dists=remaining_d,
                     best_expanded=remaining_e)
    return res_ids, res_d, st


def exhausted(state: PageState) -> torch.Tensor:
    """True when no further results can be produced."""
    return ~(torch.isfinite(state.best_dists).any() | torch.isfinite(state.backup_dists).any())
