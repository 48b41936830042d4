"""GreedySearch (Algorithm 1), batched W-way beam search in PQ space: the
port of ``repro.core.search``.

The reference runs one ``lax.while_loop`` per query under ``vmap``. Here the
batch is one loop over rounds with a per-lane ``active`` mask
(``any(frontier) & hops < max_hops``). A lane that is done is frozen: its
beam, visited log, bitmap and counters stay as they were, as under vmap. One
host sync per round tests whether any lane is still active.

Each round expands the W best unexpanded beam entries (``beam_width``),
gathers their W x R_slack neighbors, computes all ADC distances with one
``pq_adc`` launch (gathered, versioned form) and merges them into the L-beam
with one ``topk_select`` launch. Ties go to the lower position everywhere, as
``lax.top_k`` breaks them, so the beam stays sorted by (distance, position).

Counters: ``n_hops`` sequential rounds, ``n_exp`` frontier nodes expanded,
``n_cmps`` quantized distance comparisons (starting at 1 for the start node).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.pq_adc.ops import pq_adc
from ..kernels.topk_select.ops import topk_select
from . import graph as g

INF = float("inf")

# the launch signatures batch_greedy_search has run (jit_cache_size)
_SIGNATURES: set = set()
_UNCOUNTED = [0]


@contextlib.contextmanager
def uncounted():
    """Calls inside add no signature to ``jit_cache_size`` (nor to
    ``flat``'s counters): the stacked fan-out counts its search and rerank
    as one program of its own, as the reference's inner calls under a
    ``shard_map`` jit fill no cache of their own."""
    _UNCOUNTED[0] += 1
    try:
        yield
    finally:
        _UNCOUNTED[0] -= 1


def note_signature(signatures: set, sig: tuple) -> None:
    """Add ``sig`` to ``signatures`` unless inside ``uncounted()``."""
    if not _UNCOUNTED[0]:
        signatures.add(sig)


class SearchResult(NamedTuple):
    beam_ids: torch.Tensor  # (B, L) int32, ascending distance, -1 padded
    beam_dists: torch.Tensor  # (B, L) f32 (quantized space, β-scaled if filtered)
    visited_ids: torch.Tensor  # (B, V) int32 expanded nodes in order, -1 padded
    visited_dists: torch.Tensor  # (B, V) f32
    n_hops: torch.Tensor  # (B,) int32 sequential expansion rounds
    n_exp: torch.Tensor  # (B,) int32 nodes expanded (adjacency rows fetched)
    n_cmps: torch.Tensor  # (B,) int32 quantized distance comparisons


def mask_duplicates(ids: torch.Tensor) -> torch.Tensor:
    """True where ids[..., i] repeats an earlier (lower-index) entry of its row.

    A stable argsort groups equal ids with the earliest position first, so
    adjacent-equal in sorted order marks exactly the later occurrences.
    Negative ids (padding) are never marked."""
    order = torch.argsort(ids, dim=-1, stable=True)
    s = ids.gather(-1, order)
    dup_sorted = torch.zeros_like(ids, dtype=torch.bool)
    dup_sorted[..., 1:] = s[..., 1:] == s[..., :-1]
    dup = torch.zeros_like(dup_sorted).scatter(-1, order, dup_sorted)
    return dup & (ids >= 0)


def frontier_topw(ids: torch.Tensor, dists: torch.Tensor, expanded: torch.Tensor,
                  W: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions (B, W) of the W best unexpanded beam entries, and valid (B, W).
    Invalid lanes point at expanded or padding entries."""
    masked = torch.where(expanded | (ids < 0), torch.full_like(dists, INF), dists)
    vals, pos = topk_select(masked.contiguous(), W)
    return pos.long(), vals < INF


def expand_frontier(neighbors, codes, versions, live, luts, bitmap, p_ids, p_valid,
                    filter_bits: Optional[torch.Tensor], beta: float):
    """The shared W-way hop for a batch: gather the W adjacency rows of each
    lane, drop visited / dead / duplicate candidates, compute every ADC
    distance in one launch.

    p_ids (B, W) frontier node ids, p_valid (B, W). Returns (cand_ids (B, W·R),
    cand_dists, new_bitmap, n_new (B,))."""
    B = p_ids.shape[0]
    nbrs = neighbors[p_ids.long().clamp(min=0)]  # (B, W, R_slack)
    nbrs = torch.where(p_valid[..., None], nbrs, torch.full_like(nbrs, -1)).reshape(B, -1)
    safe = nbrs.long().clamp(min=0)
    valid = (nbrs >= 0) & live[safe] & ~g.bitmap_test(bitmap, nbrs)
    valid &= ~mask_duplicates(nbrs)
    bitmap = g.bitmap_or_new(bitmap, torch.where(valid, nbrs, torch.full_like(nbrs, -1)))

    d = pq_adc(luts, codes, versions, nbrs.contiguous())
    if filter_bits is not None:
        passes = g.bitmap_test(filter_bits, safe) & (nbrs >= 0)
        d = torch.where(passes, beta * d, d)
    d = torch.where(valid, d, torch.full_like(d, INF))
    cand = torch.where(valid, nbrs, torch.full_like(nbrs, -1))
    return cand, d, bitmap, valid.sum(1, dtype=torch.int32)


def default_max_hops(L: int, W: int) -> int:
    """Rounds bound that keeps the expansion budget (~2L+16 nodes) fixed in W."""
    return -(-(2 * L + 16) // W)


def batch_greedy_search(
    neighbors: torch.Tensor,  # (N, R_slack) int32
    codes: torch.Tensor,  # (N, M) uint8
    versions: torch.Tensor,  # (N,) uint8
    live: torch.Tensor,  # (N,) bool
    luts: torch.Tensor,  # (B, V, M, K) f32
    start,  # int: one start node for every lane, or (B,) int32: one per lane
    *,
    L: int,
    max_hops: int = 0,
    visited_cap: int = 0,
    filter_bits: Optional[torch.Tensor] = None,  # (B, words) int64 or None
    beta: float = 1.0,
    beam_width: int = 1,
) -> SearchResult:
    """Lockstep greedy search for a query batch (the reference's vmapped
    ``greedy_search``), one round per loop iteration. A start per lane lets
    lanes of different graphs share the rounds: the graphs stacked into one
    array, each lane starting at its own graph's entry point."""
    W = int(beam_width)
    if not 1 <= W <= L:
        raise ValueError(f"beam_width {W} must be in [1, L={L}]")
    if max_hops == 0:
        max_hops = default_max_hops(L, W)
    if visited_cap == 0:
        visited_cap = W * max_hops
    dev = luts.device
    B = luts.shape[0]
    cap = neighbors.shape[0]
    luts = luts.contiguous()

    if isinstance(start, torch.Tensor):
        if start.shape != (B,):
            raise ValueError(f"start per lane must be ({B},), got {tuple(start.shape)}")
        start_ids = start.to(device=dev, dtype=torch.int32).reshape(B, 1)
    else:
        start_ids = torch.full((B, 1), int(start), dtype=torch.int32, device=dev)
    note_signature(_SIGNATURES, (B, luts.shape[1], cap, L, W, max_hops, visited_cap,
                                 filter_bits is not None))
    start_d = pq_adc(luts, codes, versions, start_ids)[:, 0]
    ids = torch.full((B, L), -1, dtype=torch.int32, device=dev)
    ids[:, 0] = start_ids[:, 0]
    dists = torch.full((B, L), INF, dtype=torch.float32, device=dev)
    dists[:, 0] = start_d
    expanded = torch.ones((B, L), dtype=torch.bool, device=dev)
    expanded[:, 0] = False
    bitmap = g.bitmap_or_new(g.bitmap_init(cap, B, dev), start_ids)
    visited_ids = torch.full((B, visited_cap + 1), -1, dtype=torch.int32, device=dev)
    visited_dists = torch.full((B, visited_cap + 1), INF, dtype=torch.float32, device=dev)
    hops = torch.zeros((B,), dtype=torch.int32, device=dev)
    exp = torch.zeros((B,), dtype=torch.int32, device=dev)
    cmps = torch.ones((B,), dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)[:, None]

    while True:
        active = ((~expanded) & (ids >= 0)).any(1) & (hops < max_hops)
        if not bool(active.any()):
            break
        p_pos, p_valid = frontier_topw(ids, dists, expanded, W)
        p_valid &= active[:, None]  # a frozen lane expands nothing
        p_ids = ids.gather(1, p_pos)
        # mark the frontier expanded (active lanes only; an invalid position
        # points at an expanded or padding entry, so marking it is a no-op)
        expanded = expanded | torch.zeros_like(expanded).scatter(
            1, p_pos, active[:, None].expand(-1, W))

        # visited log: valid expansions pack after the running expansion
        # count; invalid lanes go to the spill column, which is dropped
        nv = p_valid.to(torch.int32)
        vpos = (exp[:, None] + torch.cumsum(nv, 1) - nv) % visited_cap
        vpos = torch.where(p_valid, vpos, torch.full_like(vpos, visited_cap)).long()
        visited_ids[rows, vpos] = p_ids
        visited_dists[rows, vpos] = dists.gather(1, p_pos)
        visited_ids[:, visited_cap] = -1
        visited_dists[:, visited_cap] = INF

        cand_ids, cand_d, bitmap, n_new = expand_frontier(
            neighbors, codes, versions, live, luts, bitmap, p_ids, p_valid,
            filter_bits, beta)

        # merge: a frozen lane's candidates are all +inf, and the beam is
        # sorted by (distance, position), so its merge is the identity
        all_ids = torch.cat([ids, cand_ids], 1)
        all_d = torch.cat([dists, cand_d], 1)
        all_e = torch.cat([expanded, torch.zeros_like(cand_ids, dtype=torch.bool)], 1)
        _, order = topk_select(all_d, L)
        order = order.long()
        ids = all_ids.gather(1, order)
        dists = all_d.gather(1, order)
        expanded = all_e.gather(1, order)
        hops = hops + active.to(torch.int32)
        exp = exp + nv.sum(1, dtype=torch.int32)
        cmps = cmps + n_new

    return SearchResult(
        beam_ids=ids, beam_dists=dists,
        visited_ids=visited_ids[:, :visited_cap].contiguous(),
        visited_dists=visited_dists[:, :visited_cap].contiguous(),
        n_hops=hops, n_exp=exp, n_cmps=cmps,
    )


def jit_cache_size() -> int:
    """The number of distinct launch signatures -- (batch, schemas V, graph
    rows, L, W, max_hops, visited_cap, has_filter) -- that
    ``batch_greedy_search`` has run: the port's counterpart of the
    reference's count of compiled signatures of its batched search entry.
    The port compiles nothing per shape; a signature seen for the first time
    is where the reference compiled, so a flat count means the traffic mints
    no new shape."""
    return len(_SIGNATURES)


# ---------------------------------------------------------------------------
# shape bucketing: the serving layer pads batches to a few fixed sizes
# ---------------------------------------------------------------------------

BATCH_BUCKETS: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)


def next_bucket(n: int, buckets: tuple[int, ...] = BATCH_BUCKETS) -> int:
    """Smallest bucket >= n; beyond the largest, round up to a multiple of it."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top


def pad_batch(arr: torch.Tensor, bucket: int) -> torch.Tensor:
    """Pad the leading (batch) axis to ``bucket`` by repeating row 0 -- padded
    lanes redo real work so every lane stays numerically well-formed."""
    b = arr.shape[0]
    if b == bucket:
        return arr
    return torch.cat([arr, arr[:1].expand(bucket - b, *arr.shape[1:])], 0)


def pad_batch_np(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Host-side twin of ``pad_batch``."""
    b = len(arr)
    if b == bucket:
        return arr
    return np.concatenate([arr, np.broadcast_to(arr[:1], (bucket - b,) + arr.shape[1:])])


def bucketed_batch_greedy_search(neighbors, codes, versions, live, luts, start, *, L: int,
                                 batch_buckets: tuple[int, ...] = BATCH_BUCKETS,
                                 max_hops: int = 0, visited_cap: int = 0,
                                 filter_bits: Optional[torch.Tensor] = None,
                                 beta: float = 1.0, beam_width: int = 1) -> SearchResult:
    """``batch_greedy_search`` padded to a batch bucket, sliced back after.
    A start per lane pads like the tables."""
    B = luts.shape[0]
    bucket = next_bucket(B, batch_buckets)
    if bucket != B:
        luts = pad_batch(luts, bucket)
        if filter_bits is not None:
            filter_bits = pad_batch(filter_bits, bucket)
        if isinstance(start, torch.Tensor):
            start = pad_batch(start, bucket)
    res = batch_greedy_search(
        neighbors, codes, versions, live, luts, start, L=L, max_hops=max_hops,
        visited_cap=visited_cap, filter_bits=filter_bits, beta=beta, beam_width=beam_width)
    if bucket != B:
        res = SearchResult(*(a[:B] for a in res))
    return res


def search_candidates(res: SearchResult) -> tuple[torch.Tensor, torch.Tensor]:
    """Union of the expanded set and the final beam, per row: the prune
    candidate pool of Insert (Algorithm 2). Later duplicates become -1/inf
    (the visited log wins)."""
    ids = torch.cat([res.visited_ids, res.beam_ids], -1)
    dists = torch.cat([res.visited_dists, res.beam_dists], -1)
    dup = mask_duplicates(ids)
    return (torch.where(dup, torch.full_like(ids, -1), ids),
            torch.where(dup, torch.full_like(dists, INF), dists))
