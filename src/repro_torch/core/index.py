"""DiskANNIndex, the host-side orchestrator of one partition: the port of
``repro.core.index``.

Mirrors the paper's control flow for one replica:

  * documents arrive -> full vector to the document store, quantized term
    generated inline (once a schema exists), graph updates applied in
    mini-batches (§3.4);
  * first PQ schema trained after ``bootstrap_sample`` docs; re-quantization
    at ``refine_sample`` docs, old and new schemas coexisting through
    versioned codes (§3.4);
  * queries run in quantized space over the graph, then rerank
    ``quantizedVectorListMultiplier x k`` candidates with full-precision
    vectors (§3.5, Fig 5);
  * the query planner routes by selectivity: brute force for tiny
    collections, Q-Flat below ~5000 predicate matches, graph search with
    post-filtering or filter-aware β-search otherwise (§3.5);
  * deletes are in-place (Alg 6) with a background consolidation sweep;
    paginated search resumes from a ``PageState`` (§3.2, Fig 3).

The distance work runs on ``device`` (CUDA unless the caller passes
``device="cpu"``) through the port's kernels; this class sequences it and
applies term writes through the provider interface. ``restore`` takes the
dict the reference's ``snapshot`` returns, and ``snapshot`` returns the same
layout, so state moves between the two packages exactly.

Graph repairs (delete, consolidate) compute the new rows on a copy of the
device mirror and write only the rows that changed through
``set_neighbors``, so a durable provider logs every repair. The paged
full-precision tier is the provider's ``pages`` (every ``ArrayProviderSet``
has one, fully resident unless given a budget); a provider without it makes
the tier hooks no-ops.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import spans
from ..device import DeviceLike
from . import delete as dmod
from . import flat as fmod
from . import graph as g
from . import insert as imod
from . import paginate as pgmod
from . import pq as pqmod
from . import prune as prmod
from . import search as smod
from .providers import ArrayProviderSet, Context, ProviderSet

# backup-queue capacity for paginated search: one value service-wide, so
# every continuation token carries a single known shape
PAGE_BACKUP_CAP = 512


@dataclasses.dataclass
class QueryStats:
    hops: float = 0.0  # sequential expansion rounds (latency-critical path)
    cmps: float = 0.0  # quantized distance comparisons (≈3500 @ L=100 in paper)
    full_reads: float = 0.0  # full-precision vectors touched (≈50 in paper)
    expansions: float = 0.0  # adjacency rows fetched (= hops·W̄; RU-relevant)
    tier_hits: float = 0.0  # paged-tier touches per query (0 without a tier)
    tier_misses: float = 0.0
    plan: str = "graph"


def _split_generator(gen: torch.Generator) -> torch.Generator:
    """A fresh generator seeded from ``gen`` (the port of jax.random.split)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    return torch.Generator().manual_seed(seed)


class DiskANNIndex:
    def __init__(self, cfg: g.GraphConfig, dim: int, providers: Optional[ProviderSet] = None,
                 seed: int = 0, context: Context = Context(), device: DeviceLike = None):
        if dim % cfg.M:
            raise ValueError(f"dim {dim} must divide into M={cfg.M} subspaces")
        self.cfg = cfg
        self.dim = dim
        self.ctx = context
        self.pv: ProviderSet = providers or ArrayProviderSet(
            cfg.capacity, cfg.R_slack, cfg.M, dim, device=device)
        self.device = self.pv.device
        self.gen = torch.Generator().manual_seed(seed)
        self.schemas: list[pqmod.PQSchema] = []  # ≤2 coexisting (§3.4)
        self.count = 0  # slot high-watermark
        self.medoid = 0
        self.doc_to_slot: dict[int, int] = {}
        self.slot_to_doc = np.full((cfg.capacity,), -1, np.int64)
        self._graph_built = False
        self._pending: list[int] = []  # slots awaiting first graph build
        self._requant_cursor = 0  # background re-encode progress
        self._consolidate_cursor = 0
        # tier touches of the most recent next_page() call (pagination has
        # no QueryStats of its own)
        self.last_page_tier: tuple[float, float] = (0.0, 0.0)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    @property
    def num_live(self) -> int:
        return int(self.pv.live.sum())

    def _t(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the index's device."""
        return torch.tensor(np.asarray(arr), device=self.device)

    def _codebook_stack(self) -> torch.Tensor:
        return torch.stack([s.codebooks for s in self.schemas], 0)

    def _luts(self, queries: torch.Tensor) -> torch.Tensor:
        """(B, V, M, K) LUTs of every coexisting schema."""
        return pqmod.multi_lut(self.schemas, queries, self.cfg.metric).contiguous()

    def _next_gen(self) -> torch.Generator:
        return _split_generator(self.gen)

    # -- paged vector tier: no-ops without ``pv.pages`` -------------------
    def _touch_tier(self, slots, stats: QueryStats, B: int, admit: bool = True,
                    pin: bool = False):
        pages = getattr(self.pv, "pages", None)
        if pages is None:
            return None
        if isinstance(slots, torch.Tensor):  # copied to the host only when a tier exists
            if spans.ACTIVE:
                spans.ACTIVE.syncs += 1
            slots = slots.cpu().numpy()
        hits, misses, touched = pages.touch(slots, admit=admit, pin=pin)
        stats.tier_hits += hits / max(B, 1)
        stats.tier_misses += misses / max(B, 1)
        return touched if pin else None

    def _unpin_tier(self, handle) -> None:
        if handle is not None:
            self.pv.pages.unpin(handle)

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------
    def insert(self, doc_ids: Sequence[int], vectors: np.ndarray) -> QueryStats:
        """Insert documents. Returns aggregate ingest stats."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"vectors must be (n, {self.dim})")
        stats = QueryStats(plan="insert")
        rec = spans.ACTIVE
        sp = rec.begin("index.insert", docs=len(doc_ids)) if rec else -1
        try:
            for start in range(0, len(doc_ids), self.cfg.batch_size):
                ids = list(doc_ids[start: start + self.cfg.batch_size])
                vecs = vectors[start: start + self.cfg.batch_size]
                self._insert_batch(ids, vecs, stats)
        finally:
            if rec:
                rec.end(sp)
        return stats

    def _alloc(self, n: int) -> np.ndarray:
        if self.count + n > self.cfg.capacity:
            raise RuntimeError(f"partition full ({self.count}+{n} > {self.cfg.capacity}); "
                               "split required")
        slots = np.arange(self.count, self.count + n, dtype=np.int64)
        self.count += n
        return slots

    def _insert_batch(self, ids: list[int], vecs: np.ndarray, stats: QueryStats):
        replace_mask = np.array([d in self.doc_to_slot for d in ids])
        if replace_mask.any():
            # Replace = overwrite vector + re-insert (§2.1); old edges are
            # cleaned lazily by later prunes.
            for d, v in zip(np.asarray(ids)[replace_mask], vecs[replace_mask]):
                self._replace_one(int(d), v)
            ids = list(np.asarray(ids)[~replace_mask])
            vecs = vecs[~replace_mask]
            if len(ids) == 0:
                return

        slots = self._alloc(len(ids))
        for d, s in zip(ids, slots):
            self.doc_to_slot[int(d)] = int(s)
            self.slot_to_doc[s] = int(d)
        rec = spans.ACTIVE
        sp = rec.begin("insert.full_write") if rec else -1
        self.pv.set_full(self.ctx, slots, vecs)
        self.pv.barrier("upsert:post_full")
        if rec:
            rec.end(sp)

        if not self.schemas:
            self._pending.extend(int(s) for s in slots)
            self.pv.set_live(self.ctx, slots, True)
            if self.count >= min(self.cfg.bootstrap_sample, self.cfg.capacity):
                self._bootstrap_schema()
            return

        # quantized term inline with the document write (§3.4)
        sp = rec.begin("insert.term_write") if rec else -1
        codes = pqmod.encode(self.schemas[-1], self._t(vecs)).cpu().numpy()
        ver = np.full((len(slots),), len(self.schemas) - 1, np.uint8)
        self.pv.set_quant(self.ctx, slots, codes, ver)
        self.pv.set_live(self.ctx, slots, True)
        if rec:
            rec.end(sp)

        if self._graph_built:
            self._graph_insert(slots, vecs, stats)
        else:
            self._pending.extend(int(s) for s in slots)

        if len(self.schemas) == 1 and self.count >= min(self.cfg.refine_sample,
                                                        self.cfg.capacity):
            self.requantize()

    def _bootstrap_schema(self):
        """Train the first PQ schema from the earliest docs (§3.4), backfill
        quantized terms, then build the graph over the backlog."""
        sample = self.pv.vectors[: min(self.count, self.cfg.bootstrap_sample)]
        self.schemas = [pqmod.train_pq(self._next_gen(), self._t(sample), self.cfg.M)]
        backlog = np.asarray(self._pending, np.int64)
        codes = pqmod.encode(self.schemas[0], self._t(self.pv.vectors[backlog])).cpu().numpy()
        self.pv.set_quant(self.ctx, backlog, codes, np.zeros(len(backlog), np.uint8))
        self._pending = []
        self._build_initial_graph(backlog)

    def _build_initial_graph(self, slots: np.ndarray):
        _, _, _, live, vectors = self.pv.materialize(self.ctx)
        self.medoid = g.compute_medoid(vectors, live)
        self._graph_built = True
        order = np.random.RandomState(0).permutation(slots)
        st = QueryStats()
        # Ramp-up: batch-inserting into a near-empty graph funnels every new
        # node's single candidate (the medoid) into one overflowing adjacency
        # list. Grow batches 4 -> 8 -> ... so early nodes wire densely.
        i, bs = 0, 4
        while i < len(order):
            batch = order[i: i + bs]
            i += bs
            bs = min(bs * 2, self.cfg.batch_size)
            batch = batch[batch != self.medoid]
            if len(batch) == 0:
                continue
            self._graph_insert(batch, self.pv.vectors[batch], st)
        self.repair_orphans()

    def repair_orphans(self) -> int:
        """Re-insert live nodes with zero in-degree (background maintenance;
        keeps every vector reachable from the medoid's side)."""
        nb = self.pv.neighbors[: self.count]
        indeg = np.bincount(nb[nb >= 0], minlength=self.cfg.capacity)
        live = self.pv.live
        orphans = np.nonzero((indeg[: self.count] == 0) & live[: self.count])[0]
        orphans = orphans[orphans != self.medoid]
        if len(orphans) == 0:
            return 0
        st = QueryStats()
        for i in range(0, len(orphans), self.cfg.batch_size):
            batch = orphans[i: i + self.cfg.batch_size]
            self._graph_insert(batch, self.pv.vectors[batch], st)
        return len(orphans)

    def _graph_insert(self, slots: np.ndarray, vecs: np.ndarray, stats: QueryStats):
        """Mini-batch graph update (Alg 5): batched search + prune, then one
        consolidated reverse-edge append per touched node."""
        cfg = self.cfg
        rec = spans.ACTIVE
        sp = rec.begin("insert.materialize") if rec else -1
        neighbors, codes, versions, live, _ = self.pv.materialize(self.ctx)
        books = self._codebook_stack()
        q = self._t(vecs)
        if rec:
            rec.end(sp)
            sp = rec.begin("insert.candidates")
        cand_ids, _cand_d, istats = imod.insert_candidates(
            neighbors, codes, versions, live, books, q, self.medoid,
            L_build=cfg.L_build, metric=cfg.metric)
        if rec:
            rec.end(sp)
            sp = rec.begin("insert.prune")
        nbrs = imod.prune_batch(codes, versions, books, q, cand_ids, R=cfg.R,
                                alpha=cfg.alpha, metric=cfg.metric).cpu().numpy()  # (B, R)
        stats.hops += float(istats.hops.sum())
        stats.cmps += float(istats.cmps.sum())

        rows = np.full((len(slots), cfg.R_slack), -1, np.int32)
        rows[:, : cfg.R] = nbrs
        self.pv.set_neighbors(self.ctx, slots, rows)
        if rec:
            rec.end(sp)
            sp = rec.begin("insert.edges")

        # group reverse edges by target: ONE consolidated append per node --
        # the Bw-Tree "no duplicate patch for a key" contract (§2.1)
        rev: dict[int, list[int]] = {}
        for s, row in zip(slots.tolist(), nbrs.tolist()):
            for b in row:
                if b >= 0 and b != s:
                    rev.setdefault(b, []).append(s)
        over_nodes: list[int] = []
        over_cands: list[list[int]] = []
        for b, ps in rev.items():
            row = self.pv.neighbors[b]
            existing = set(row[row >= 0].tolist())
            ps = [p for p in dict.fromkeys(ps) if p not in existing]
            if not ps:
                continue
            fitted = self.pv.append_neighbors(self.ctx, b, np.asarray(ps, np.int32))
            if fitted < len(ps):
                row = self.pv.neighbors[b]
                over_nodes.append(b)
                over_cands.append(list(dict.fromkeys(row[row >= 0].tolist() + ps)))
        if rec:
            rec.end(sp)
        # Each overflow prune reads only its own node's row (plus codes and
        # liveness, which no prune writes) and writes only that row, so
        # running all of this call's prunes as one batch gives the graph the
        # reference's one-at-a-time loop gives.
        if over_nodes:
            sp = rec.begin("insert.overflow_prune") if rec else -1
            self._prune_nodes(np.asarray(over_nodes, np.int64), over_cands)
            if rec:
                rec.end(sp)

    def _prune_nodes(self, nodes: np.ndarray, cands: list[list[int]]):
        """RobustPrune each node's merged candidate list down to R, in one batch."""
        cfg = self.cfg
        cap = cfg.R_slack + cfg.batch_size
        ids = np.full((len(nodes), cap), -1, np.int64)
        for i, c in enumerate(cands):
            c = c[:cap]
            ids[i, : len(c)] = c
        live_mask = self.pv.live[np.maximum(ids, 0)] & (ids >= 0)
        ids = np.where(live_mask, ids, -1)
        rec = spans.ACTIVE
        sp = rec.begin("insert.materialize") if rec else -1
        _, codes, versions, _, _ = self.pv.materialize(self.ctx)
        if rec:
            rec.end(sp)
        books = self._codebook_stack()
        ids_t = self._t(ids.astype(np.int32))
        nodes_t = self._t(nodes)
        pruned = prmod.prune_with_vectors(
            imod.decode_rows(codes, versions, books, nodes_t),
            ids_t,
            imod.decode_rows(codes, versions, books, ids_t),
            alpha=cfg.alpha, R=cfg.R, metric=cfg.metric, self_id=nodes_t,
        ).cpu().numpy()
        rows = np.full((len(nodes), cfg.R_slack), -1, np.int32)
        rows[:, : cfg.R] = pruned
        self.pv.set_neighbors(self.ctx, nodes, rows)
        # the reference writes each pruned row with a call of its own: its
        # write epoch advances once per node
        self.pv.write_count += len(nodes) - 1

    def _replace_one(self, doc_id: int, vec: np.ndarray):
        slot = self.doc_to_slot[doc_id]
        self.pv.set_full(self.ctx, np.asarray([slot]), vec[None, :])
        self.pv.barrier("upsert:post_full")
        if self.schemas:
            codes = pqmod.encode(self.schemas[-1], self._t(vec[None, :])).cpu().numpy()
            self.pv.set_quant(self.ctx, np.asarray([slot]), codes,
                              np.asarray([len(self.schemas) - 1], np.uint8))
        if self._graph_built:
            self._graph_insert(np.asarray([slot]), vec[None, :], QueryStats())

    # ------------------------------------------------------------------
    # re-quantization (§3.4)
    # ------------------------------------------------------------------
    def requantize(self):
        """Refine the PQ schema from a larger sample; terms re-encode in place
        (background chunks via requantize_step); the graph is not rebuilt --
        old and new codes coexist through versioned LUTs."""
        n = min(self.count, self.cfg.refine_sample)
        refined = pqmod.refine_pq(self._next_gen(), self.schemas[-1],
                                  self._t(self.pv.vectors[:n]))
        self.schemas = [self.schemas[-1], refined][-2:]
        self._requant_cursor = 0

    def requantize_step(self, chunk: int = 4096) -> bool:
        """Re-encode one chunk with the newest schema. True when done."""
        if len(self.schemas) < 2:
            return True
        lo = self._requant_cursor
        hi = min(lo + chunk, self.count)
        if lo >= hi:
            # transition complete: retire the old schema
            self.schemas = [self.schemas[-1]]
            self.pv.versions[: self.count] = 0
            self.pv._dirty()
            return True
        ids = np.arange(lo, hi)
        codes = pqmod.encode(self.schemas[-1], self._t(self.pv.vectors[ids])).cpu().numpy()
        self.pv.set_quant(self.ctx, ids, codes, np.full(len(ids), 1, np.uint8))
        self._requant_cursor = hi
        return False

    def requantize_all(self):
        while not self.requantize_step():
            pass

    # ------------------------------------------------------------------
    # deletion (Alg 6) + background consolidation
    # ------------------------------------------------------------------
    def delete(self, doc_ids: Sequence[int], policy: str = "inplace"):
        """Delete documents one at a time, in the order given: ``inplace``
        rewires the graph around each (Alg 6), any other policy only marks it
        dead (the "drop" policy). A deleted medoid is replaced."""
        cfg = self.cfg
        for d in doc_ids:
            slot = self.doc_to_slot.pop(int(d), None)
            if slot is None:
                continue
            self.slot_to_doc[slot] = -1
            self.pv.set_live(self.ctx, np.asarray([slot]), False)
            if policy == "inplace" and self._graph_built:
                neighbors, codes, versions, live, _ = self.pv.materialize(self.ctx)
                books = self._codebook_stack()
                # quantized-space coordinates (§3.2) of only the rows it reads
                new_nb = dmod.inplace_delete(
                    neighbors, live, lambda ids: imod.decode_rows(codes, versions, books, ids),
                    slot, R=cfg.R, R_slack=cfg.R_slack, alpha=cfg.alpha,
                    c_replace=cfg.c_replace, metric=cfg.metric)
                self._write_neighbor_diff(neighbors, new_nb)
            if slot == self.medoid and self.num_live:
                self.recompute_medoid()

    def recompute_medoid(self):
        """Start-point maintenance (FreshDiskANN practice): after heavy churn
        the medoid should track the live distribution."""
        if self.num_live:
            _, _, _, live, vectors = self.pv.materialize(self.ctx)
            self.medoid = g.compute_medoid(vectors, live)

    def consolidate(self, chunk: int = 1024):
        """One background-sweep step: clear dangling edges to dead nodes."""
        neighbors, _, _, live, _ = self.pv.materialize(self.ctx)
        new_nb = dmod.consolidate_chunk(neighbors, live, self._consolidate_cursor, chunk)
        self._write_neighbor_diff(neighbors, new_nb)
        self._consolidate_cursor = (self._consolidate_cursor + chunk) % max(self.count, 1)

    def _write_neighbor_diff(self, old_nb: torch.Tensor, new_nb: torch.Tensor):
        """Write only the rows a graph repair changed, through the provider:
        durable providers log ``set_neighbors`` to their WAL, so recovery
        replays the repair. The device mirror is left as it is; the rows
        written are copied up at the next ``materialize``."""
        changed = (old_nb != new_nb).any(1).nonzero()[:, 0]
        if changed.numel():
            self.pv.set_neighbors(self.ctx, changed.cpu().numpy(),
                                  new_nb[changed].cpu().numpy())
        # the reference ends every repair with a whole-cache invalidation:
        # one more write epoch, so the two packages count alike
        self.pv.write_count += 1

    # ------------------------------------------------------------------
    # queries (§3.5)
    # ------------------------------------------------------------------
    def search(self, queries: np.ndarray, k: int, L: Optional[int] = None,
               rerank_multiplier: float = fmod.QUANTIZED_LIST_MULTIPLIER,
               pad_to_bucket: bool = False,
               batch_buckets: tuple[int, ...] = smod.BATCH_BUCKETS,
               beam_width: Optional[int] = None) -> tuple[np.ndarray, np.ndarray, QueryStats]:
        """Top-k ANN: graph search in quantized space + full-precision rerank.
        Returns (doc_ids (B, k), dists (B, k), stats)."""
        W = int(beam_width or self.cfg.beam_width)
        queries = np.asarray(queries, np.float32)
        B = len(queries)
        if pad_to_bucket:
            queries = smod.pad_batch_np(queries, smod.next_bucket(B, batch_buckets))
        L = L or self.cfg.L_search
        stats = QueryStats()
        kprime = max(k, int(round(rerank_multiplier * k)))
        rec = spans.ACTIVE
        sp = rec.begin("index.search", queries=B) if rec else -1
        try:
            neighbors, codes, versions, live, vectors = self.pv.materialize(self.ctx)
            q = self._t(queries)

            if not self._graph_built:
                stats.plan = "brute_force"
                ids, dists = fmod.brute_force(q, vectors, live, k=k, metric=self.cfg.metric)
                stats.full_reads = self.num_live
                self._touch_tier(np.nonzero(self.pv.live)[0], stats, B, admit=False)
                if rec:
                    rec.syncs += 2  # the answers read back
                return (self._to_doc_ids(ids.cpu().numpy())[:B], dists.cpu().numpy()[:B],
                        stats)

            c = rec.begin("search.luts") if rec else -1
            luts = self._luts(q)
            if rec:
                rec.end(c)
            res = smod.bucketed_batch_greedy_search(
                neighbors, codes, versions, live, luts, self.medoid,
                L=max(L, kprime), batch_buckets=batch_buckets, beam_width=W)
            cand = res.beam_ids[:, :kprime]
            c = rec.begin("search.rerank") if rec else -1
            pinned = self._touch_tier(cand[:B], stats, B, pin=True)
            ids, dists = fmod.rerank(q, cand, vectors, k=k, metric=self.cfg.metric)
            self._unpin_tier(pinned)
            if rec:
                rec.end(c)
                c = rec.begin("search.answer")
                rec.syncs += 5  # the three stats and the two answers read back
            stats.hops = float(res.n_hops[:B].float().mean())
            stats.cmps = float(res.n_cmps[:B].float().mean())
            stats.expansions = float(res.n_exp[:B].float().mean())
            stats.full_reads = float(kprime)
            out = self._to_doc_ids(ids.cpu().numpy())[:B], dists.cpu().numpy()[:B], stats
            if rec:
                rec.end(c)
            return out
        finally:
            if rec:
                rec.end(sp, syncs=rec.syncs_since(sp))

    def _to_doc_ids(self, slots: np.ndarray) -> np.ndarray:
        return np.where(slots >= 0, self.slot_to_doc[np.maximum(slots, 0)], -1)

    # -- filtered queries (§3.5, Fig 9) ---------------------------------
    def filtered_search(self, queries: np.ndarray, k: int, doc_filter: np.ndarray,
                        L: Optional[int] = None, mode: str = "auto", beta: float = 0.3,
                        rerank_multiplier: float = fmod.QUANTIZED_LIST_MULTIPLIER,
                        beam_width: Optional[int] = None, pad_to_bucket: bool = False,
                        batch_buckets: tuple[int, ...] = smod.BATCH_BUCKETS,
                        filter_words: Optional[np.ndarray] = None
                        ) -> tuple[np.ndarray, np.ndarray, QueryStats]:
        """Query-planner routing by selectivity (``mode``: auto | post | beta
        | qflat | brute), then post-filter or β-biased graph search. Any other
        ``mode`` runs β-search and is reported as given in ``stats.plan``, as
        the reference does. ``doc_filter`` is a bool mask over doc slots;
        ``filter_words`` optionally supplies it pre-packed in the uint32
        bitmap layout."""
        W = int(beam_width or self.cfg.beam_width)
        queries = np.asarray(queries, np.float32)
        B = len(queries)
        if pad_to_bucket:
            queries = smod.pad_batch_np(queries, smod.next_bucket(B, batch_buckets))
        L = L or self.cfg.L_search
        matches = int((doc_filter & self.pv.live).sum())
        stats = QueryStats()
        if mode == "auto":
            if self.num_live <= fmod.BRUTE_FORCE_MAX_DOCS or not self._graph_built:
                mode = "brute"
            elif matches < fmod.QFLAT_MAX_MATCHES:
                mode = "qflat"
            else:
                mode = "beta"
        stats.plan = mode
        kprime = max(k, int(round(rerank_multiplier * k)))
        neighbors, codes, versions, live, vectors = self.pv.materialize(self.ctx)
        fmask = self._t(doc_filter & self.pv.live)
        q = self._t(queries)

        if mode == "brute":
            ids, dists = fmod.brute_force(q, vectors, fmask, k=k, metric=self.cfg.metric)
            stats.full_reads = matches
            self._touch_tier(np.nonzero(doc_filter & self.pv.live)[0], stats, B, admit=False)
            return self._to_doc_ids(ids.cpu().numpy())[:B], dists.cpu().numpy()[:B], stats

        luts = self._luts(q)
        if mode == "qflat":
            cand, _ = fmod.qflat_scan(luts, codes, versions, fmask, kprime=kprime,
                                      metric=self.cfg.metric)
            pinned = self._touch_tier(cand[:B], stats, B, pin=True)
            ids, dists = fmod.rerank(q, cand, vectors, k=k, metric=self.cfg.metric)
            self._unpin_tier(pinned)
            stats.cmps = matches
            stats.full_reads = kprime
            return self._to_doc_ids(ids.cpu().numpy())[:B], dists.cpu().numpy()[:B], stats

        if mode == "post":
            res = smod.bucketed_batch_greedy_search(
                neighbors, codes, versions, live, luts, self.medoid,
                L=max(L, kprime), batch_buckets=batch_buckets, beam_width=W)
        else:  # beta (Alg 7), and any mode not named above
            fbits = filter_words if filter_words is not None else self._pack_bits(
                np.asarray(doc_filter))
            fb = g.bitmap_from_numpy(fbits, self.device)[None].expand(len(queries), -1)
            res = smod.bucketed_batch_greedy_search(
                neighbors, codes, versions, live, luts, self.medoid,
                L=max(L, kprime), batch_buckets=batch_buckets,
                filter_bits=fb.contiguous(), beta=beta, beam_width=W)
        beam = res.beam_ids
        dfilt = self._t(np.asarray(doc_filter, bool))
        passes = dfilt[beam.long().clamp(min=0)] & (beam >= 0)
        beam = torch.where(passes, beam, torch.full_like(beam, -1))
        cand = beam[:, : max(L, kprime)]
        pinned = self._touch_tier(cand[:B], stats, B, pin=True)
        ids, dists = fmod.rerank(q, cand, vectors, k=k, metric=self.cfg.metric)
        self._unpin_tier(pinned)
        stats.hops = float(res.n_hops[:B].float().mean())
        stats.cmps = float(res.n_cmps[:B].float().mean())
        stats.expansions = float(res.n_exp[:B].float().mean())
        stats.full_reads = float(kprime)
        return self._to_doc_ids(ids.cpu().numpy())[:B], dists.cpu().numpy()[:B], stats

    @staticmethod
    def _pack_bits(mask: np.ndarray) -> np.ndarray:
        words = np.zeros(((len(mask) + 31) // 32,), np.uint32)
        idx = np.nonzero(mask)[0]
        np.bitwise_or.at(words, idx >> 5, np.uint32(1) << (idx & 31).astype(np.uint32))
        return words

    # -- pagination (§3.2 / §3.5 Continuations) ---------------------------
    def start_pagination(self, query: np.ndarray, L: Optional[int] = None,
                         backup_cap: int = PAGE_BACKUP_CAP) -> pgmod.PageState:
        L = L or self.cfg.L_search
        _, codes, versions, _, _ = self.pv.materialize(self.ctx)
        lut = self._luts(self._t(np.asarray(query, np.float32)[None, :]))[0]
        return pgmod.start_pagination(self.cfg.capacity, L, backup_cap, codes, versions, lut,
                                      self.medoid)

    @staticmethod
    def page_stats(prev: pgmod.PageState, new: pgmod.PageState, k: int,
                   rerank: bool = True) -> QueryStats:
        """Per-page work from the cumulative PageState counters: the quantized
        comparisons and adjacency rows the page fetched, plus the k
        full-precision rerank reads."""
        return QueryStats(
            hops=float(int(new.hops) - int(prev.hops)),
            cmps=float(int(new.cmps) - int(prev.cmps)),
            expansions=float(int(new.exp) - int(prev.exp)),
            full_reads=float(k if rerank else 0),
            plan="paginated",
        )

    def next_page(self, query: np.ndarray, state: pgmod.PageState, k: int,
                  rerank: bool = True, beam_width: Optional[int] = None,
                  slot_filter: Optional[np.ndarray] = None
                  ) -> tuple[np.ndarray, np.ndarray, pgmod.PageState]:
        """One page of k results. With ``slot_filter`` (a bool mask over doc
        slots) non-matching slots are dropped from the page after the
        traversal step, so the visited set still advances and later pages
        surface matches not yet reached: a filtered page may hold fewer than
        k rows, but the stream never skips or repeats one."""
        neighbors, codes, versions, live, vectors = self.pv.materialize(self.ctx)
        q = self._t(np.asarray(query, np.float32)[None, :])
        lut = self._luts(q)[0]
        ids, dists, state = pgmod.next_page(
            neighbors, codes, versions, live, lut, state, k=k,
            beam_width=int(beam_width or self.cfg.beam_width))
        if slot_filter is not None:
            keep = (ids >= 0) & self._t(np.asarray(slot_filter, bool))[ids.long().clamp(min=0)]
            ids = torch.where(keep, ids, torch.full_like(ids, -1))
            dists = torch.where(keep, dists, torch.full_like(dists, float("inf")))
        self.last_page_tier = (0.0, 0.0)
        if rerank:
            tst = QueryStats()
            pinned = self._touch_tier(ids, tst, 1, pin=True)
            rids, rd = fmod.rerank(q, ids[None, :], vectors, k=k, metric=self.cfg.metric)
            self._unpin_tier(pinned)
            self.last_page_tier = (tst.tier_hits, tst.tier_misses)
            return self._to_doc_ids(rids.cpu().numpy())[0], rd.cpu().numpy()[0], state
        return self._to_doc_ids(ids[None, :].cpu().numpy())[0], dists.cpu().numpy(), state

    # ------------------------------------------------------------------
    # persistence: the same dict layout as repro.core.index.DiskANNIndex
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        return dict(
            neighbors=self.pv.neighbors.copy(),
            codes=self.pv.codes.copy(),
            versions=self.pv.versions.copy(),
            live=self.pv.live.copy(),
            vectors=self.pv.vectors.copy(),
            slot_to_doc=self.slot_to_doc.copy(),
            count=self.count,
            medoid=self.medoid,
            schemas=[s.codebooks.cpu().numpy() for s in self.schemas],
            graph_built=self._graph_built,
        )

    def restore(self, snap: dict):
        self.pv.neighbors[:] = snap["neighbors"]
        self.pv.codes[:] = snap["codes"]
        self.pv.versions[:] = snap["versions"]
        self.pv.live[:] = snap["live"]
        self.pv.vectors[:] = snap["vectors"]
        self.pv._dirty()
        self.slot_to_doc[:] = snap["slot_to_doc"]
        self.count = int(snap["count"])
        self.medoid = int(snap["medoid"])
        self.schemas = [
            pqmod.PQSchema(codebooks=self._t(np.asarray(cb, np.float32)), version=i)
            for i, cb in enumerate(snap["schemas"])
        ]
        self._graph_built = bool(snap["graph_built"])
        self.doc_to_slot = {int(d): int(s) for s, d in enumerate(self.slot_to_doc) if d >= 0}
