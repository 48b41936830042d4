"""Cross-partition query fan-out (§3.5 "SDK Query Plan", §4.3, Fig 10): the
port of ``repro.partition.fanout``.

Host paths, as in the reference:

  * ``fanout_search`` — the client-side SDK path: issue the query to every
    physical partition (through its replica set), merge partial top-k
    results, track per-partition RU and the max-latency effect the paper
    highlights ("client end-to-end latency is sensitive to the worst
    latency on the server side"), with hedged requests for stragglers;
  * ``batched_fanout_search`` / ``batched_filtered_fanout_search`` — one
    micro-batch to every partition, one search call each, merged;
  * ``start_paged_fanout`` / ``paged_fanout_search`` — continuation paging
    as a buffered k-way merge of per-partition page streams.

Device paths, the counterparts of the reference's ``shard_map`` programs:

  * ``SpmdFanout`` — every searchable partition in ONE batched search on one
    card: the partitions' provider arrays are concatenated (neighbor ids
    offset by each partition's first slot), each lane starts at its own
    partition's medoid and reads its own partition's LUTs, so one
    ``batch_greedy_search`` over P × bucket lanes runs the rounds of all P
    partitions together, then one rerank. No kernel reads across lanes and
    a finished lane's state does not move, so the results are bit-identical
    to the serial per-partition loop; RU is metered on each partition's own
    meter and governor.
  * ``distributed_search_fn`` — the multi-pod dry-run's search step over
    shard-stacked arrays, as one stacked search plus a ``topk_select`` merge.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import flat as fmod
from ..core import paginate as pgmod
from ..core import pq as pqmod
from ..core import search as smod
from ..core.index import QueryStats
from ..device import DeviceLike, resolve_device
from ..kernels.topk_select.ops import topk_select
from ..store.faults import CrashError
from ..store.props import words_to_mask
from ..store.ru import counters_for_latency, counters_for_ru

INF = float("inf")


class AllPartitionsFailed(RuntimeError):
    """Zero partitions answered a fan-out: nothing to degrade to — the
    only case where partial-result degradation still hard-fails."""


# ---------------------------------------------------------------------------
# client-side fan-out (host path)
# ---------------------------------------------------------------------------


def merge_topk(
    ids_list: Sequence[np.ndarray], dists_list: Sequence[np.ndarray], k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Merge per-partition (B, k_i) partial results into global (B, k)."""
    ids = np.concatenate(ids_list, axis=1)
    dists = np.concatenate(dists_list, axis=1)
    dists = np.where(ids >= 0, dists, np.inf)
    order = np.argsort(dists, axis=1)[:, :k]
    return np.take_along_axis(ids, order, 1), np.take_along_axis(dists, order, 1)


def fanout_search(
    partitions,  # Sequence[PhysicalPartition] or Sequence[ReplicaSet]
    queries: np.ndarray,
    k: int,
    L: Optional[int] = None,
    latency_model=None,
    hedge_at_ms: Optional[float] = None,
    rng: Optional[np.random.RandomState] = None,
) -> tuple[np.ndarray, np.ndarray, dict]:
    """Scatter to all partitions, gather, merge. Returns (ids, dists, info).

    info: per-partition RU, modelled server latencies, client latency
    (= max over partitions), hedges issued.
    """
    rng = rng or np.random.RandomState(0)
    ids_l, dists_l, rus, lats = [], [], [], []
    hedges = 0
    hedge_ru = 0.0
    for p in partitions:
        ids, dists, ru = p.search(queries, k, L)
        ids_l.append(ids)
        dists_l.append(dists)
        rus.append(ru)
        if latency_model is not None:
            lat = latency_model(p, rng)
            if hedge_at_ms is not None and lat > hedge_at_ms:
                hedges += 1
                # a hedge is a SECOND server-side execution on another
                # replica: the fastest answer wins the latency race, but
                # both executions did the work — the duplicate bills too
                hedge_ru += ru
                lat = min(lat, latency_model(p, rng))  # hedged duplicate
            lats.append(lat)
    ids, dists = merge_topk(ids_l, dists_l, k)
    info = dict(
        ru_per_partition=rus,
        ru_total=float(np.sum(rus)) + hedge_ru,
        server_latencies_ms=lats,
        client_latency_ms=float(np.max(lats)) if lats else 0.0,
        hedges=hedges,
        hedge_ru=hedge_ru,
    )
    return ids, dists, info


def batched_fanout_search(
    partitions,  # Sequence[PhysicalPartition]
    queries: np.ndarray,  # (B, D) — a dense micro-batch of independent queries
    k: int,
    L: Optional[int] = None,
    batch_buckets: Optional[tuple[int, ...]] = None,
    beam_width: Optional[int] = None,
    health=None,  # optional callable(partition) -> bool (replica liveness)
) -> tuple[np.ndarray, np.ndarray, dict]:
    """Multi-query scatter/gather for the serving engine.

    Unlike ``fanout_search`` (one logical query, per-partition bookkeeping),
    this dispatches a whole micro-batch to every partition as ONE
    fixed-shape device call (padded to `batch_buckets`), then merges the
    per-partition top-k. info carries total RU, per-partition RU/stats, and
    the modelled worst-partition latency (client latency tracks the slowest
    partition, §4.3).

    The latency model is *round-structured* (``store.ru
    .counters_for_latency``): a beam-width round's quantized reads issue
    concurrently and its adjacency fetches coalesce into one round trip.
    RU, by contrast, still charges every read (see
    ``PhysicalPartition.search_batch``): W buys latency, not free work.
    """
    kw: dict = {}
    if batch_buckets is not None:
        kw = dict(pad_to_bucket=True, batch_buckets=batch_buckets)
    if beam_width is not None:
        kw["beam_width"] = beam_width
    ids_l, dists_l, rus, lat_ms = [], [], [], []
    stats_l = []
    failed: list[tuple[int, str]] = []
    for p in partitions:
        if health is not None and not health(p):
            failed.append((int(p.pid), "replica set down"))
            continue
        try:
            ids, dists, ru, stats = p.search_batch(queries, k, L, **kw)
        except CrashError:
            raise  # an injected process kill is not a partition fault
        except Exception as e:  # noqa: BLE001 — degrade, don't collapse
            failed.append((int(p.pid), f"{type(e).__name__}: {e}"))
            continue
        ids_l.append(ids)
        dists_l.append(dists)
        rus.append(ru)
        stats_l.append(stats)
        lat_ms.append(
            p.providers.meter.latency_ms(counters_for_latency(stats))
        )
    if failed and not ids_l:
        raise AllPartitionsFailed(
            f"all {len(list(partitions))} partitions failed: {failed}"
        )
    if ids_l:
        ids, dists = merge_topk(ids_l, dists_l, k)
    else:  # empty collection: nothing failed, nothing to merge
        ids = np.full((len(queries), k), -1, np.int64)
        dists = np.full((len(queries), k), np.inf, np.float32)
    info = dict(
        partition_ids=[int(p.pid) for p in partitions],
        ru_per_partition=rus,
        ru_total=float(np.sum(rus)) if rus else 0.0,
        stats_per_partition=stats_l,
        server_latencies_ms=lat_ms,
        service_latency_ms=float(np.max(lat_ms)) if lat_ms else 0.0,
        failed_partitions=failed,
        complete=not failed,
    )
    return ids, dists, info


def compile_partition_filter(p, predicate):
    """Compile ``predicate`` against one partition's property-term index.
    Returns (bool slot mask, packed uint32 words, posting reads billed);
    mask and words are None when the predicate matches nothing in this
    partition. Pure bitmap algebra over the inverted PROP_TERM postings,
    cached per (partition, canonical predicate) and invalidated by ingest
    epoch. Never touches the doc store or ``doc_to_slot``. The words are
    already in the ``filter_bits`` layout, so the β-search path consumes
    them directly without a re-pack."""
    words = p.props.compile(predicate)
    nreads = p.props.last_compile_reads
    if not words.any():
        return None, None, nreads
    return words_to_mask(words, p.index.cfg.capacity), words, nreads


def batched_filtered_fanout_search(
    partitions,  # Sequence[PhysicalPartition]
    queries: np.ndarray,  # (B, D) — a micro-batch sharing ONE predicate
    k: int,
    predicate,  # serve.predicate.Predicate (canonical, hashable)
    L: Optional[int] = None,
    batch_buckets: Optional[tuple[int, ...]] = None,
    beam_width: Optional[int] = None,
    health=None,  # optional callable(partition) -> bool (replica liveness)
) -> tuple[np.ndarray, np.ndarray, dict]:
    """Multi-query scatter/gather for FILTERED micro-batches: every lane
    shares the same canonical predicate (the engine groups by predicate
    key), so the predicate compiles to one bitmap per partition —
    broadcast through ``bucketed_batch_greedy_search`` via the
    ``filter_bits`` plumbing — instead of one O(capacity) document scan
    per query per partition.

    Empty partitions and partitions where the predicate matches nothing
    are skipped outright (no bitmap minted, no search run). info carries
    the per-partition plan aggregate as ``plan`` (e.g.
    ``filtered-batched[beta×2,qflat×1]``), RU/stats/latency in the same
    shape as ``batched_fanout_search``.
    """
    kw: dict = {}
    if batch_buckets is not None:
        kw = dict(pad_to_bucket=True, batch_buckets=batch_buckets)
    if beam_width is not None:
        kw["beam_width"] = beam_width
    B, k = len(queries), int(k)
    ids_l, dists_l, rus, lat_ms, stats_l = [], [], [], [], []
    pids: list[int] = []
    plans: dict[str, int] = {}
    compile_ru = 0.0
    failed: list[tuple[int, str]] = []
    answered = 0  # searched OR legitimately skipped (known-empty) partitions
    for p in partitions:
        if p.num_docs == 0:
            answered += 1
            continue
        if health is not None and not health(p):
            failed.append((int(p.pid), "replica set down"))
            continue
        try:
            mask, words, nreads = compile_partition_filter(p, predicate)
            if mask is None:
                # the compile still read postings (cache miss) — a no-match
                # partition is skipped, not free
                compile_ru += nreads * p.providers.meter.cfg.ru_per_prop_read
                answered += 1
                continue
            ids, dists, ru, stats = p.filtered_search_batch(
                queries, k, mask, L=L, term_reads=nreads,
                filter_words=words, **kw
            )
        except CrashError:
            raise  # an injected process kill is not a partition fault
        except Exception as e:  # noqa: BLE001 — degrade, don't collapse
            failed.append((int(p.pid), f"{type(e).__name__}: {e}"))
            continue
        answered += 1
        ids_l.append(ids)
        dists_l.append(dists)
        rus.append(ru)
        stats_l.append(stats)
        pids.append(int(p.pid))
        plans[stats.plan] = plans.get(stats.plan, 0) + 1
        lat_ms.append(
            p.providers.meter.latency_ms(counters_for_latency(stats))
        )
    if failed and answered == 0:
        raise AllPartitionsFailed(
            f"all candidate partitions failed: {failed}"
        )
    if not ids_l:  # predicate matches nothing in any answering partition
        ids = np.full((B, k), -1, np.int64)
        dists = np.full((B, k), np.inf, np.float32)
        plan = "filtered-batched[empty]"
    else:
        ids, dists = merge_topk(ids_l, dists_l, k)
        plan = "filtered-batched[" + ",".join(
            f"{name}×{count}" for name, count in sorted(plans.items())
        ) + "]"
    info = dict(
        partition_ids=pids,
        ru_per_partition=rus,
        ru_total=(float(np.sum(rus)) if rus else 0.0) + compile_ru,
        stats_per_partition=stats_l,
        server_latencies_ms=lat_ms,
        service_latency_ms=float(np.max(lat_ms)) if lat_ms else 0.0,
        plan=plan,
        partitions_searched=len(ids_l),
        compile_ru=compile_ru,
        failed_partitions=failed,
        complete=not failed,
    )
    return ids, dists, info


# ---------------------------------------------------------------------------
# cross-partition pagination (§3.5 "Continuations" — client-side merge)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PartitionPageCursor:
    """One partition's slice of a cross-partition pagination.

    ``state`` is the partition-local ``PageState`` (dropped once the
    partition is exhausted, shrinking the token); ``buf_*`` hold results
    already fetched from the partition but not yet emitted in a merged
    page; ``fetch_hwm`` is the partition's high-water mark — the largest
    distance it has produced so far. A partition's page stream is
    ascending, so everything it will produce later is ≥ ``fetch_hwm``;
    the merge exploits that bound through its nonempty-buffer rule (see
    ``paged_fanout_search``).
    """

    pid: int
    state: Optional[pgmod.PageState]
    buf_ids: np.ndarray  # (n,) int64, ascending by buf_dists
    buf_dists: np.ndarray  # (n,) float32
    fetch_hwm: float = -np.inf
    exhausted: bool = False


@dataclasses.dataclass
class PagedQueryState:
    """The whole cross-partition continuation: one cursor per physical
    partition plus global merge bookkeeping."""

    shard_fp: int  # fingerprint of (shard_key, partition ids) at start
    emit_hwm: float  # largest distance emitted in any merged page
    pages: int  # merged pages emitted so far
    cursors: list[PartitionPageCursor]

    def exhausted(self) -> bool:
        return all(c.exhausted and len(c.buf_ids) == 0 for c in self.cursors)


def paged_fanout_fingerprint(shard_key, partitions, pred_key=None) -> int:
    """Bind a token to the routing that minted it: resuming under a
    different shard key — or after a split/merge changed the partition
    set, or under a DIFFERENT predicate (``pred_key`` = the predicate's
    canonical key bytes) — is rejected up front, not silently mis-merged."""
    from .partitioner import hash_key

    ident: tuple = (repr(shard_key), tuple(int(p.pid) for p in partitions))
    if pred_key is not None:
        ident += (pred_key,)
    return hash_key(ident)


def start_paged_fanout(partitions, query: np.ndarray, shard_key=None,
                       L: Optional[int] = None, pred_key=None,
                       slot_filters: Optional[Sequence] = None) -> PagedQueryState:
    """Open one pagination cursor per physical partition. With
    ``slot_filters`` (one compiled predicate mask — or None — per
    partition, index-aligned), partitions where the predicate matches
    nothing start exhausted: no cursor state is minted and no page is
    ever fetched from them."""
    query = np.asarray(query, np.float32)
    cursors = []
    for i, p in enumerate(partitions):
        dead = (slot_filters is not None and slot_filters[i] is None) \
            or p.num_docs == 0
        cursors.append(PartitionPageCursor(
            pid=int(p.pid),
            state=None if dead else p.start_pagination(query, L=L),
            buf_ids=np.zeros((0,), np.int64),
            buf_dists=np.zeros((0,), np.float32),
            exhausted=dead,
        ))
    return PagedQueryState(
        shard_fp=paged_fanout_fingerprint(shard_key, partitions, pred_key),
        emit_hwm=-np.inf, pages=0, cursors=cursors,
    )


def _fetch_partition_page(p, cur: PartitionPageCursor, query: np.ndarray,
                          k: int, beam_width: Optional[int],
                          slot_filter=None) -> tuple[float, float]:
    """Pull one page from partition ``p`` into the cursor's buffer.
    Returns (ru, modelled latency ms) for this fetch."""
    ids, dists, state, ru, stats = p.next_page(
        query, cur.state, k=k, beam_width=beam_width, slot_filter=slot_filter
    )
    lat_ms = p.providers.meter.latency_ms(counters_for_latency(stats))
    ids, dists = np.asarray(ids), np.asarray(dists)
    valid = (ids >= 0) & np.isfinite(dists)
    ids = ids[valid].astype(np.int64)
    dists = dists[valid].astype(np.float32)
    cur.state = state
    if len(ids):
        cur.fetch_hwm = max(cur.fetch_hwm, float(dists.max()))
        bi = np.concatenate([cur.buf_ids, ids])
        bd = np.concatenate([cur.buf_dists, dists])
        # re-sort: full-precision re-rank can jitter the tail ordering
        order = np.argsort(bd, kind="stable")
        cur.buf_ids, cur.buf_dists = bi[order], bd[order]
    # an empty page means "done" only on the unfiltered path: a filtered
    # page can legitimately carry zero matches while the traversal still
    # has unvisited region — exhaustion there is the traversal's call
    if (len(ids) == 0 and slot_filter is None) or bool(pgmod.exhausted(state)):
        cur.exhausted = True
        cur.state = None  # nothing left to resume — shrink the token
    return ru, lat_ms


def paged_fanout_search(
    partitions,  # Sequence[PhysicalPartition], index-aligned with cursors
    query: np.ndarray,  # (D,)
    pstate: PagedQueryState,
    page_size: int,
    beam_width: Optional[int] = None,
    slot_filters: Optional[Sequence] = None,  # per-partition masks or None
    executor=None,  # a lane executor with schedule_round(latencies) -> horizon ms
) -> tuple[np.ndarray, np.ndarray, dict]:
    """Produce the next globally-merged page across all partitions.

    Buffered k-way merge: before every emit, each non-exhausted partition
    holds a nonempty buffer, so the global buffer minimum is ≤ every
    partition's ``fetch_hwm`` — nothing still unfetched anywhere can beat
    it. Emitted results therefore never repeat and never skip, and the
    per-partition leftovers ride along in the continuation token.

    Refills run as multi-cursor ROUNDS: every starved partition pulls one
    ``next_page`` per round until all buffers are non-empty. With an
    ``executor`` each round books its fetches across the replica lanes
    and service latency is the lane horizon of the whole page; without
    one, the max of per-partition sums. The fetch sequence per partition
    is identical either way, so results, cursors and RU never depend on
    the executor. info also carries the fixed per-request RU floor — a
    continuation request is never free, even when a page is served
    entirely from the token's buffers (§2.2).
    """
    assert len(partitions) == len(pstate.cursors), \
        "cursors must be index-aligned with the partition routing"
    query = np.asarray(query, np.float32)
    n = len(partitions)
    out_ids: list[int] = []
    out_dists: list[float] = []
    rus = [0.0] * n
    lat_sums = [0.0] * n
    fetches = 0
    exec_ms = 0.0
    rounds = 0
    # per-fetch log (round, pid, ru, lat_ms) — one child span per fetch
    fetch_log: list[dict] = []

    def _refill_rounds():
        nonlocal fetches, exec_ms, rounds
        while True:
            round_lats = []
            for i, (p, cur) in enumerate(zip(partitions, pstate.cursors)):
                if cur.exhausted or len(cur.buf_ids):
                    continue
                ru, lat = _fetch_partition_page(
                    p, cur, query, page_size, beam_width,
                    slot_filter=None if slot_filters is None
                    else slot_filters[i],
                )
                rus[i] += ru
                lat_sums[i] += lat
                round_lats.append(lat)
                fetch_log.append(dict(round=rounds, pid=int(p.pid),
                                      ru=float(ru), lat_ms=float(lat)))
                fetches += 1
            if not round_lats:
                return
            rounds += 1
            if executor is not None:
                # schedule_round returns the lane horizon relative to the
                # (unmoving) clock; successive rounds stack on the same
                # lanes, so the LAST horizon is the page's total makespan
                exec_ms = max(exec_ms, executor.schedule_round(round_lats))

    while len(out_ids) < page_size:
        _refill_rounds()
        heads = [
            (float(cur.buf_dists[0]), i)
            for i, cur in enumerate(pstate.cursors) if len(cur.buf_ids)
        ]
        if not heads:
            break  # every partition exhausted and drained
        d, i = min(heads)
        cur = pstate.cursors[i]
        out_ids.append(int(cur.buf_ids[0]))
        out_dists.append(d)
        cur.buf_ids = cur.buf_ids[1:]
        cur.buf_dists = cur.buf_dists[1:]
        pstate.emit_hwm = max(pstate.emit_hwm, d)
    pstate.pages += 1

    ids = np.full((page_size,), -1, np.int64)
    dists = np.full((page_size,), np.inf, np.float32)
    ids[: len(out_ids)] = out_ids
    dists[: len(out_dists)] = out_dists
    request_ru = (
        partitions[0].providers.meter.cfg.ru_per_page_request if n else 0.0
    )
    info = dict(
        partition_ids=[int(p.pid) for p in partitions],
        ru_per_partition=rus,
        request_ru=request_ru,
        ru_total=float(np.sum(rus)) + request_ru,
        fetch_log=fetch_log,
        server_latencies_ms=lat_sums,
        service_latency_ms=(exec_ms if executor is not None
                            else float(np.max(lat_sums)) if lat_sums else 0.0),
        lane_scheduled=executor is not None,
        pages_fetched=fetches,
        emit_hwm=pstate.emit_hwm,  # how deep into the result set we are
        exhausted=pstate.exhausted(),
    )
    return ids, dists, info


# ---------------------------------------------------------------------------
# device paths: every partition in one stacked search
# ---------------------------------------------------------------------------


def _stack_graphs(neighbors: Sequence[torch.Tensor]) -> tuple[torch.Tensor, list[int]]:
    """Concatenate graphs (n_p, R_slack) into one, each id >= 0 offset by
    its graph's first row; returns it and the offsets."""
    offsets, total = [], 0
    for nb in neighbors:
        offsets.append(total)
        total += nb.shape[0]
    stacked = torch.cat([torch.where(nb >= 0, nb + off, nb)
                         for nb, off in zip(neighbors, offsets)])
    return stacked, offsets


def distributed_search_fn(*, L: int, k: int, metric: str = "l2", max_hops: int = 0,
                          beam_width: int = 1, device: DeviceLike = None):
    """The cross-partition search step over shard-stacked index arrays, on
    one card: the counterpart of the reference's ``shard_map`` program.

    The returned fn takes (neighbors (S, n, R_slack), codes (S, n, M),
    versions (S, n), live (S, n), vectors (S, n, D), doc_ids (S, n), medoid
    (S,), codebooks (S, M, K, dsub), queries (B, D)), numpy or torch, and
    returns (doc ids (B, k), dists (B, k)). The S shards run as one stacked
    search; each reranks its beam's first 2k, and the (B, S·k) partials
    merge through ``topk_select`` (ties to the lower index, as
    ``lax.top_k``). As in the reference, each shard's LUTs come from its
    version-0 codebooks only, so rows of a later schema are read through
    the first schema's table (versions clamp to the one table)."""
    dev = resolve_device(device)

    def fn(neighbors, codes, versions, live, vectors, doc_ids, medoid, codebooks, queries):
        t = lambda a: torch.as_tensor(a).to(dev)
        neighbors, codes, versions, live = t(neighbors), t(codes), t(versions), t(live)
        vectors, doc_ids, codebooks = t(vectors), t(doc_ids), t(codebooks)
        medoid, q = t(medoid), t(queries).float().contiguous()
        S, n = neighbors.shape[:2]
        B = q.shape[0]
        nb, offsets = _stack_graphs(list(neighbors.to(torch.int32)))
        luts = torch.cat([pqmod.adc_lut(pqmod.PQSchema(codebooks[s].float(), 0), q, metric)
                          for s in range(S)])[:, None].contiguous()  # (S·B, 1, M, K)
        start = (medoid.to(torch.int32)
                 + torch.tensor(offsets, dtype=torch.int32, device=dev)).repeat_interleave(B)
        with smod.uncounted():  # one program, as the reference's shard_map
            res = smod.batch_greedy_search(
                nb, codes.reshape(S * n, -1).contiguous(), versions.reshape(-1).contiguous(),
                live.reshape(-1).bool(), luts, start, L=L, max_hops=max_hops,
                beam_width=beam_width)
            lids, ldists = fmod.rerank(q.repeat(S, 1), res.beam_ids[:, :2 * k],
                                       vectors.reshape(S * n, -1).float(), k=k, metric=metric)
        docs = doc_ids.reshape(-1)
        gdoc = torch.where(lids >= 0, docs[lids.long().clamp(min=0)], -1)
        gd = torch.where(lids >= 0, ldists, INF)
        # (S, B, k) -> (B, S·k) -> top-k
        flat_d = gd.reshape(S, B, k).permute(1, 0, 2).reshape(B, S * k).contiguous()
        flat_i = gdoc.reshape(S, B, k).permute(1, 0, 2).reshape(B, S * k)
        vals, pos = topk_select(flat_d, k)
        return flat_i.gather(1, pos.long()), vals

    return fn


# the launch signatures the stacked fan-out has run (spmd_jit_cache_size)
_SPMD_SIGNATURES: set = set()


def spmd_jit_cache_size() -> int:
    """The number of distinct launch signatures -- (partitions P, bucket,
    schemas V, stacked rows, L, k, k', W, metric) -- that ``SpmdFanout`` has
    run: the port's counterpart of the reference's count of compiled
    ``shard_map`` programs and shapes. It feeds
    ``serve.vector_engine.serving_jit_cache_size``; the stacked call's own
    search and rerank count here, not in ``core.search.jit_cache_size``."""
    return len(_SPMD_SIGNATURES)


class SpmdFanout:
    """One stacked search driving every partition's query batch on one card.

    Where ``batched_fanout_search`` loops partitions on the host — one
    search per partition — this concatenates the searchable partitions'
    provider arrays and runs the graph search + full-precision rerank for
    ALL of them as one batch of P × bucket lanes. The per-partition merge
    stays on the host, in original partition order, so results are
    **bit-identical** to the serial loop: LUTs come from the very same
    calls (``DiskANNIndex._luts`` on the bucket-padded queries), each lane
    runs the kernels the serial lane runs on the same rows, and a finished
    lane's state does not move while other lanes go on.

    The visited bitmap of a lane spans all P·capacity slots (each lane
    only ever sets bits of its own partition's range): the bitmap code
    stays the one every path runs.

    The stacked arrays of the last partition set searched are kept (one
    copy of every partition's arrays on the device), invalidated by a
    change of the set or of a partition's ``providers.write_count`` epoch
    (plus count / schema-count / medoid, which can move without a provider
    write).

    Partitions whose graph isn't built (or that are empty) fall back to
    the host ``search_batch`` — the same call the serial path makes — and
    their results interleave back at their original merge position.
    Partitions whose replica set is down (``health``) go to
    ``failed_partitions``. RU is metered on each partition's own
    meter/governor exactly like ``PhysicalPartition.search_batch``.
    """

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._stack = None  # (stamp, the partitions, their stacked arrays)

    # -- stacked provider arrays (cached per write epoch) ----------------
    def _stacked(self, prog_parts) -> dict:
        # the partitions are held beside their stack, so no other object
        # can take one of their ids while it is cached
        stamp = tuple(
            (id(p), p.providers.write_count, p.index.count, len(p.index.schemas),
             int(p.index.medoid))
            for p in prog_parts
        )
        if self._stack is not None and self._stack[0] == stamp:
            return self._stack[2]
        self._stack = None  # the old stack's device memory goes before the new one's
        mats = [[a.to(self.device) for a in p.index.pv.materialize(p.index.ctx)]
                for p in prog_parts]
        neighbors, offsets = _stack_graphs([m[0] for m in mats])
        arrs = dict(
            neighbors=neighbors,
            codes=torch.cat([m[1] for m in mats]),
            versions=torch.cat([m[2] for m in mats]),
            live=torch.cat([m[3] for m in mats]),
            vectors=torch.cat([m[4] for m in mats]),
            slot_to_doc=np.concatenate([p.index.slot_to_doc for p in prog_parts]),
            offsets=offsets,
            medoid=torch.tensor([p.index.medoid + off for p, off in zip(prog_parts, offsets)],
                                dtype=torch.int32, device=self.device),
        )
        self._stack = (stamp, list(prog_parts), arrs)
        return arrs

    # -- the engine entry point ------------------------------------------
    def search(
        self,
        partitions,  # Sequence[PhysicalPartition]
        queries: np.ndarray,  # (B, D)
        k: int,
        L: Optional[int] = None,
        batch_buckets: tuple[int, ...] = smod.BATCH_BUCKETS,
        beam_width: Optional[int] = None,
        rerank_multiplier: float = fmod.QUANTIZED_LIST_MULTIPLIER,
        health=None,  # optional callable(partition) -> bool
    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Drop-in for ``batched_fanout_search``: same (ids, dists, info)."""
        parts = list(partitions)
        queries = np.asarray(queries, np.float32)
        B, k = len(queries), int(k)
        n = len(parts)
        failed: list[tuple[int, str]] = []
        down = set()
        for i, p in enumerate(parts):
            if health is not None and not health(p):
                down.add(i)
                failed.append((int(p.pid), "replica set down"))
        prog_idx = [i for i, p in enumerate(parts)
                    if i not in down
                    and p.index._graph_built and p.num_docs > 0]
        in_prog = set(prog_idx)

        ids_by: list = [None] * n
        d_by: list = [None] * n
        rus: list = [0.0] * n
        stats_by: list = [None] * n
        lat_by: list = [0.0] * n

        # host fallback — identical to the serial loop's search_batch call
        W = int(beam_width) if beam_width is not None else None
        for i, p in enumerate(parts):
            if i in in_prog or i in down:
                continue
            kw: dict = dict(pad_to_bucket=True, batch_buckets=batch_buckets)
            if W is not None:
                kw["beam_width"] = W
            try:
                ids, dists, ru, stats = p.search_batch(queries, k, L, **kw)
            except CrashError:
                raise  # an injected process kill is not a partition fault
            except Exception as e:  # noqa: BLE001 — degrade, don't collapse
                down.add(i)
                failed.append((int(p.pid), f"{type(e).__name__}: {e}"))
                continue
            ids_by[i], d_by[i], rus[i], stats_by[i] = ids, dists, ru, stats
            lat_by[i] = p.providers.meter.latency_ms(
                counters_for_latency(stats))

        if prog_idx:
            out = self._search_stacked([parts[i] for i in prog_idx], queries, k, L,
                                       batch_buckets, W, rerank_multiplier)
            for i, (ids, dists, ru, stats, lat) in zip(prog_idx, out):
                ids_by[i], d_by[i], rus[i], stats_by[i], lat_by[i] = ids, dists, ru, stats, lat

        ok = [i for i in range(n) if ids_by[i] is not None]
        if failed and not ok:
            raise AllPartitionsFailed(
                f"all {n} partitions failed: {failed}"
            )
        if ok:
            ids, dists = merge_topk([ids_by[i] for i in ok],
                                    [d_by[i] for i in ok], k)
        else:
            ids = np.full((B, k), -1, np.int64)
            dists = np.full((B, k), np.inf, np.float32)
        info = dict(
            partition_ids=[int(p.pid) for p in parts],
            ru_per_partition=[rus[i] for i in ok],
            ru_total=float(np.sum([rus[i] for i in ok])) if ok else 0.0,
            stats_per_partition=[stats_by[i] for i in ok],
            server_latencies_ms=[lat_by[i] for i in ok],
            service_latency_ms=(float(np.max([lat_by[i] for i in ok]))
                                if ok else 0.0),
            spmd=dict(partitions_in_program=len(prog_idx),
                      device=str(self.device)),
            failed_partitions=failed,
            complete=not failed,
        )
        return ids, dists, info

    def _search_stacked(self, prog_parts, queries, k, L, batch_buckets, W,
                        rerank_multiplier) -> list[tuple]:
        """The one stacked search + rerank. Returns (doc ids, dists, RU,
        stats, modelled latency ms) per partition, in order."""
        B = len(queries)
        idx0 = prog_parts[0].index
        W_eff = W or idx0.cfg.beam_width
        L_req = int(L or idx0.cfg.L_search)
        kprime = max(k, int(round(rerank_multiplier * k)))
        L_eff = max(L_req, kprime)
        bucket = smod.next_bucket(B, batch_buckets)
        padded = smod.pad_batch_np(queries, bucket)

        # per-partition LUTs from the SAME calls the serial path makes
        # (identical inputs → identical tables, bit for bit); the V axis
        # pads to the widest schema set by repeating the last table —
        # padded tables are never selected (versions < V_p)
        luts = [p.index._luts(p.index._t(padded)).to(self.device) for p in prog_parts]
        V_max = max(lt.shape[1] for lt in luts)
        luts = torch.cat([
            lt if lt.shape[1] == V_max else torch.cat(
                [lt, lt[:, -1:].expand(-1, V_max - lt.shape[1], -1, -1)], 1)
            for lt in luts]).contiguous()
        arrs = self._stacked(prog_parts)
        _SPMD_SIGNATURES.add((len(prog_parts), bucket, V_max, arrs["neighbors"].shape[0], L_eff,
                              k, kprime, int(W_eff), idx0.cfg.metric))
        with smod.uncounted():
            res = smod.batch_greedy_search(
                arrs["neighbors"], arrs["codes"], arrs["versions"], arrs["live"], luts,
                arrs["medoid"].repeat_interleave(bucket), L=L_eff, beam_width=int(W_eff))
            cand = res.beam_ids[:, :kprime]
            q = torch.from_numpy(padded).to(self.device).repeat(len(prog_parts), 1)
            ids, dists = fmod.rerank(q, cand, arrs["vectors"], k=k, metric=idx0.cfg.metric)
        ids, dists, cand = ids.cpu().numpy(), dists.cpu().numpy(), cand.cpu().numpy()
        doc = np.where(ids >= 0, arrs["slot_to_doc"][np.maximum(ids, 0)], -1)
        out = []
        for j, (p, off) in enumerate(zip(prog_parts, arrs["offsets"])):
            rows = slice(j * bucket, j * bucket + B)
            st = QueryStats(
                hops=float(res.n_hops[rows].float().mean()),
                cmps=float(res.n_cmps[rows].float().mean()),
                expansions=float(res.n_exp[rows].float().mean()),
                full_reads=float(kprime),
                plan="graph-spmd",
            )
            # paged-tier metering on the identical candidate pages the
            # serial path touches (same pin→touch→unpin sequence, so
            # cache state and hit/miss counts match bit for bit)
            pages = getattr(p.providers, "pages", None)
            if pages is not None:
                local = np.where(cand[rows] >= 0, cand[rows] - off, -1)
                th, tm, pinned = pages.touch(local, pin=True)
                pages.unpin(pinned)
                st.tier_hits = th / max(B, 1)
                st.tier_misses = tm / max(B, 1)
            # meter exactly like PhysicalPartition.search_batch: the work
            # ran in the stacked call, but it is THIS partition's work
            pv = p.providers
            pv.begin_op()
            pv.op += counters_for_ru(st, lanes=B)
            ru, _ = pv.end_op()
            p.governor.request(ru)
            out.append((doc[rows].astype(np.int64), dists[rows], ru, st,
                        pv.meter.latency_ms(counters_for_latency(st))))
        return out
