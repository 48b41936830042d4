"""Logical partitioning and elasticity (§2.2, §4.3): the port of
``repro.partition.partitioner``.

A Collection hashes each document's partition key into a 32-bit keyspace
split into contiguous ranges, one per PhysicalPartition. Partitions are
capacity-bounded (the paper's 50 GB limit → a vector-count budget here);
when one fills, `split()` halves its hash range and re-homes documents —
the scale-out path that takes collections to a billion vectors across ~50
partitions (Fig 10). `merge()` is the scale-in inverse.

Each PhysicalPartition owns a DiskANN index over *its* documents plus a
store and resource governor — faithfully one-vector-index-per-partition,
queried via fanout.py. The device travels as a constructor argument: every
partition's provider arrays and index live on it (CUDA unless the caller
passes ``device="cpu"``). ``from_reference_state`` builds partitions and
collections from the plain state of the reference's (arrays, bytes and
dicts), so the two packages can be held against each other on one state.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np

from ..core import DiskANNIndex, GraphConfig
from ..core.providers import Context
from ..device import DeviceLike
from ..store.pages import PagedVectorStore
from ..store.props import PropertyTermIndex
from ..store.provider import StoreProviderSet
from ..store.ru import ResourceGovernor, counters_for_ru


def hash_key(key) -> int:
    """32-bit stable hash of a logical partition-key value."""
    return int.from_bytes(
        hashlib.blake2b(repr(key).encode(), digest_size=4).digest(), "big"
    )


@dataclasses.dataclass
class CollectionConfig:
    dim: int
    graph: GraphConfig
    max_vectors_per_partition: int  # the 50 GB limit analogue
    initial_partitions: int = 1
    provisioned_ru_s: float = 10000.0
    vector_path: str = "/embedding"
    shard_key_path: Optional[str] = None  # sharded DiskANN (§3.3) when set
    # tiered storage: fraction of each partition's full-precision vector
    # pages kept resident. None → fully resident; e.g. 0.25 keeps PQ codes +
    # adjacency + postings resident and pages the vectors, billing RU +
    # modelled latency per rerank-stage page miss
    resident_frac: Optional[float] = None
    vector_page_size: int = 64


class PhysicalPartition:
    def __init__(self, cfg: CollectionConfig, lo: int, hi: int, pid: int,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.lo, self.hi = lo, hi  # hash range [lo, hi)
        self.pid = pid
        self.providers = StoreProviderSet(
            cfg.graph.capacity, cfg.graph.R_slack, cfg.graph.M, cfg.dim,
            path=cfg.vector_path, device=device,
        )
        self.device = self.providers.device
        self.index = DiskANNIndex(cfg.graph, cfg.dim, providers=self.providers,
                                  seed=pid, context=Context(replica=pid))
        # configure the paged full-precision tier: page size from config,
        # cache seeded per-partition so eviction is deterministic per pid
        self.providers.pages = PagedVectorStore(
            cfg.graph.capacity, cfg.dim, page_size=cfg.vector_page_size,
            seed=pid,
        )
        self.set_residency(cfg.resident_frac)
        self.governor = ResourceGovernor(cfg.provisioned_ru_s)
        self.doc_pk: dict[int, int] = {}  # doc id -> partition key hash
        # inverted property-term postings over THIS partition's slots (the
        # predicate/WHERE index) + each doc's extracted (path, value) items
        # so re-homing (split/merge/re-key) carries the terms along
        self.props = PropertyTermIndex(cfg.graph.capacity, store=self.providers)
        self.doc_props: dict[int, tuple] = {}

    @classmethod
    def from_reference_state(cls, cfg: CollectionConfig, state: dict,
                             device: DeviceLike = None) -> "PhysicalPartition":
        """A partition holding the state of one of the reference's, given as
        plain data: ``lo``, ``hi``, ``pid``; ``index`` (its index's
        ``snapshot()`` dict, arrays as numpy); ``snapshot`` and ``wal`` (its
        store's ``snapshot_bytes()`` and ``wal_bytes()``); ``doc_pk`` and
        ``doc_props``. The store is recovered from the bytes, the index
        restored from the dict, and the property postings rebuilt in memory
        (the recovered store already holds their terms). The paged tier
        starts cold."""
        p = cls(cfg, int(state["lo"]), int(state["hi"]), int(state["pid"]), device=device)
        p.providers.recover(state["snapshot"], state["wal"])
        p.index.restore(state["index"])
        p.doc_pk = {int(d): int(h) for d, h in state["doc_pk"].items()}
        p.doc_props = {int(d): tuple(tuple(it) for it in items)
                       for d, items in state["doc_props"].items()}
        store, p.props._store = p.props._store, None  # no second write of the terms
        for d, items in p.doc_props.items():
            p.props.assign(p.index.doc_to_slot[d], items)
        p.props._store = store
        return p

    def set_residency(self, frac: Optional[float]) -> None:
        """(Re)size this partition's resident vector budget. ``None`` →
        fully resident (the paged tier never misses); ``frac`` ∈ (0, 1]
        caps the page cache at that fraction of the partition's pages."""
        pages = self.providers.pages
        if frac is None:
            pages.set_budget(None)
        else:
            pages.set_budget(max(1, int(round(float(frac) * pages.n_pages))))

    def owns(self, h: int) -> bool:
        return self.lo <= h < self.hi

    @property
    def num_docs(self) -> int:
        return len(self.doc_pk)

    def insert(self, doc_ids: Sequence[int], pk_hashes: Sequence[int],
               vectors: np.ndarray,
               props: Optional[Sequence[tuple]] = None) -> tuple[float, float]:
        """``props`` aligns with ``doc_ids``: each entry is the doc's
        (path, value) property items (``serve.predicate.property_items``).
        None keeps a replaced doc's existing terms (core-level callers that
        never index properties stay property-free)."""
        self.providers.begin_op()
        self.providers.barrier("upsert:begin")
        self.index.insert(doc_ids, vectors)
        self.providers.barrier("upsert:post_index")
        for j, (d, h) in enumerate(zip(doc_ids, pk_hashes)):
            d = int(d)
            self.doc_pk[d] = int(h)
            items = (tuple(props[j]) if props is not None
                     else self.doc_props.get(d, ()))
            self.props.assign(self.index.doc_to_slot[d], items)
            self.doc_props[d] = items
        self.providers.barrier("upsert:pre_commit")
        ru, lat = self.providers.end_op()
        delay = self.governor.request(ru)
        return ru, lat + delay * 1000.0

    def delete(self, doc_ids: Sequence[int]) -> float:
        self.providers.begin_op()
        self.providers.barrier("delete:begin")
        for d in doc_ids:
            slot = self.index.doc_to_slot.get(int(d))
            if slot is not None:
                self.props.remove(slot)
            self.doc_props.pop(int(d), None)
        self.providers.barrier("delete:post_props")
        self.index.delete(doc_ids)
        for d in doc_ids:
            self.doc_pk.pop(int(d), None)
        self.providers.barrier("delete:pre_commit")
        ru, _ = self.providers.end_op()
        self.governor.request(ru)
        return ru

    def search(self, queries: np.ndarray, k: int, L: Optional[int] = None,
               **kw) -> tuple[np.ndarray, np.ndarray, float]:
        ids, dists, ru, _stats = self.search_batch(queries, k, L, **kw)
        return ids, dists, ru / max(len(queries), 1)

    def search_batch(self, queries: np.ndarray, k: int, L: Optional[int] = None, **kw):
        """Dense multi-query search. Returns (ids, dists, total RU, stats) —
        the serving engine's entry point: stats feed its latency model and
        the total RU feeds per-tenant admission accounting."""
        self.providers.begin_op()
        ids, dists, stats = self.index.search(queries, k, L, **kw)
        # RU charges the adjacency rows actually fetched (expansions), not
        # the round count — W-way hop batching must not deflate the bill
        self.providers.op += counters_for_ru(stats, lanes=len(queries))
        ru, _ = self.providers.end_op()
        self.governor.request(ru)
        return ids, dists, ru, stats

    def filtered_search_batch(self, queries: np.ndarray, k: int, doc_filter: np.ndarray,
                              L: Optional[int] = None, term_reads: int = 0, **kw):
        """Dense multi-query FILTERED search — the serving engine's batched
        predicate path. ``doc_filter`` is the compiled predicate mask over
        this partition's slots (shared by every lane of the micro-batch);
        ``term_reads`` is the posting-lookup count the predicate→bitmap
        compilation performed (0 on a bitmap-cache hit), billed as
        property-term reads. Extra ``kw`` (e.g. ``filter_words``,
        ``pad_to_bucket``) pass through to ``DiskANNIndex.filtered_search``."""
        self.providers.begin_op()
        self.providers.op.prop_reads += int(term_reads)
        ids, dists, stats = self.index.filtered_search(
            queries, k, doc_filter, L=L, **kw
        )
        self.providers.op += counters_for_ru(stats, lanes=len(queries))
        ru, _ = self.providers.end_op()
        self.governor.request(ru)
        return ids, dists, ru, stats

    # -- pagination (one partition's slice of a cross-partition page) ----
    def start_pagination(self, query: np.ndarray, L: Optional[int] = None):
        """Open a pagination cursor over THIS partition's index."""
        return self.index.start_pagination(np.asarray(query, np.float32), L=L)

    def next_page(self, query: np.ndarray, state, k: int,
                  beam_width: Optional[int] = None,
                  slot_filter: Optional[np.ndarray] = None):
        """Produce this partition's next page, RU-metered like the main
        search path. Returns (doc_ids, dists, state, ru, stats): RU charges
        the page's quantized comparisons + adjacency fetches + k re-rank
        reads (a paged scan is never free), and the stats feed the
        round-structured latency model. ``slot_filter`` threads a compiled
        predicate bitmap through the page (filtered pagination)."""
        self.providers.begin_op()
        ids, dists, new_state = self.index.next_page(
            query, state, k=k, beam_width=beam_width, slot_filter=slot_filter
        )
        stats = self.index.page_stats(state, new_state, k)
        # fold the page's rerank-stage tier touches (recorded by the index
        # since PageState carries no tier counters) into the billing stats
        stats.tier_hits, stats.tier_misses = self.index.last_page_tier
        self.providers.op += counters_for_ru(stats)
        ru, _ = self.providers.end_op()
        self.governor.request(ru)
        return ids, dists, new_state, ru, stats


class Collection:
    """A scaled-out collection: hash ranges → physical partitions."""

    def __init__(self, cfg: CollectionConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = device
        n = cfg.initial_partitions
        span = 1 << 32
        bounds = [span * i // n for i in range(n)] + [span]
        self.partitions: list[PhysicalPartition] = [
            PhysicalPartition(cfg, bounds[i], bounds[i + 1], i, device=device)
            for i in range(n)
        ]
        self._next_pid = n
        self.splits = 0
        self.merges = 0

    @classmethod
    def from_reference_state(cls, cfg: CollectionConfig, state: dict,
                             device: DeviceLike = None) -> "Collection":
        """A collection holding the state of one of the reference's, given as
        plain data: ``partitions`` (one ``PhysicalPartition.from_reference_state``
        dict each, in routing order), ``next_pid``, ``splits`` and ``merges``."""
        col = cls.__new__(cls)
        col.cfg, col.device = cfg, device
        col.partitions = [PhysicalPartition.from_reference_state(cfg, s, device)
                          for s in state["partitions"]]
        col._next_pid = int(state["next_pid"])
        col.splits, col.merges = int(state["splits"]), int(state["merges"])
        return col

    def _partition(self, lo: int, hi: int) -> PhysicalPartition:
        p = PhysicalPartition(self.cfg, lo, hi, self._next_pid, device=self.device)
        self._next_pid += 1
        return p

    # ------------------------------------------------------------------
    def _route(self, pk) -> PhysicalPartition:
        h = hash_key(pk)
        for p in self.partitions:
            if p.owns(h):
                return p
        raise RuntimeError("hash ranges must cover the keyspace")

    def owner_of(self, doc_id: int) -> Optional[PhysicalPartition]:
        """The partition that currently holds ``doc_id`` (each partition
        records the pk hash it ingested every doc under), or None."""
        for p in self.partitions:
            if int(doc_id) in p.doc_pk:
                return p
        return None

    def insert(self, doc_ids: Sequence[int], partition_keys: Sequence,
               vectors: np.ndarray,
               props: Optional[Sequence[tuple]] = None) -> float:
        """Route documents to their partitions; split when full. ``props``
        (aligned with ``doc_ids``) carries each doc's property-term items
        into the owning partition's inverted predicate index."""
        total_ru = 0.0
        by_part: dict[int, list[int]] = {}
        hashes = [hash_key(pk) for pk in partition_keys]
        # Cosmos identity is (partition key, id): re-upserting an id under
        # a key that hashes to a DIFFERENT partition moves the document —
        # tombstone the old copy first, or it lingers live in its old
        # partition serving stale results forever
        for i, h in enumerate(hashes):
            owner = self.owner_of(doc_ids[i])
            if owner is not None and not owner.owns(h):
                total_ru += owner.delete([int(doc_ids[i])])
        for i, h in enumerate(hashes):
            for j, p in enumerate(self.partitions):
                if p.owns(h):
                    by_part.setdefault(j, []).append(i)
                    break
        for j, rows in by_part.items():
            p = self.partitions[j]
            if p.num_docs + len(rows) > self.cfg.max_vectors_per_partition:
                self.split(j)
                # re-route this chunk after the split
                total_ru += self.insert(
                    [doc_ids[i] for i in rows],
                    [partition_keys[i] for i in rows],
                    vectors[rows],
                    props=[props[i] for i in rows] if props is not None else None,
                )
                continue
            ru, _ = p.insert(
                [doc_ids[i] for i in rows], [hashes[i] for i in rows],
                vectors[rows],
                props=[props[i] for i in rows] if props is not None else None,
            )
            total_ru += ru
        return total_ru

    def delete(self, doc_ids: Sequence[int], partition_keys: Sequence) -> float:
        ru = 0.0
        for d, pk in zip(doc_ids, partition_keys):
            ru += self._route(pk).delete([d])
        return ru

    def delete_by_id(self, doc_ids: Sequence[int]) -> float:
        """Delete by locating each doc's OWNING partition — no
        caller-supplied pk, so a delete can never route to the wrong
        partition and silently no-op (unknown ids are skipped, matching
        ``DiskANNIndex.delete`` semantics)."""
        ru = 0.0
        for d in doc_ids:
            p = self.owner_of(d)
            if p is not None:
                ru += p.delete([int(d)])
        return ru

    # ------------------------------------------------------------------
    # elasticity
    # ------------------------------------------------------------------
    def split(self, j: int):
        """Split partition j's hash range in half and re-home documents —
        the paper's partition split behind elastic scaling (§2.2)."""
        old = self.partitions[j]
        # a crash anywhere before the final partition-list swap abandons
        # the half-built children and leaves the collection untouched —
        # split is all-or-nothing at the routing level by construction
        old.providers.barrier("split:begin")
        mid = (old.lo + old.hi) // 2
        left = self._partition(old.lo, mid)
        right = self._partition(mid, old.hi)
        halfway = len(old.doc_pk) // 2
        for i, (doc, h) in enumerate(old.doc_pk.items()):
            if i == halfway:
                old.providers.barrier("split:mid_rehome")
            slot = old.index.doc_to_slot.get(doc)
            if slot is None or not old.providers.live[slot]:
                continue
            vec = old.providers.vectors[slot][None, :]
            dst = left if h < mid else right
            # property terms re-home with the document: the new partition's
            # posting bitmaps must track its doc_to_slot exactly
            dst.insert([doc], [h], vec, props=[old.doc_props.get(doc, ())])
        old.providers.barrier("split:pre_commit")
        self.partitions = (
            self.partitions[:j] + [left, right] + self.partitions[j + 1:]
        )
        self.splits += 1

    def split_hottest(self) -> tuple[int, tuple]:
        """Split the fullest partition — the control-plane actuation for
        sustained overload: more partitions means more parallel fan-out
        lanes and smaller per-partition search cost. Returns ``(j, (left,
        right))`` — the split index and the two new partitions that
        replaced it."""
        j = max(range(len(self.partitions)),
                key=lambda i: self.partitions[i].num_docs)
        self.split(j)
        return j, (self.partitions[j], self.partitions[j + 1])

    def merge(self, j: int):
        """Merge partitions j and j+1 (adjacent ranges) — scale-in."""
        a, b = self.partitions[j], self.partitions[j + 1]
        assert a.hi == b.lo, "only adjacent ranges merge"
        a.providers.barrier("merge:begin")
        big = self._partition(a.lo, b.hi)
        for src in (a, b):
            if src is b:
                a.providers.barrier("merge:mid")
            for doc, h in src.doc_pk.items():
                slot = src.index.doc_to_slot.get(doc)
                if slot is None or not src.providers.live[slot]:
                    continue
                big.insert([doc], [h], src.providers.vectors[slot][None, :],
                           props=[src.doc_props.get(doc, ())])
        a.providers.barrier("merge:pre_commit")
        self.partitions = self.partitions[:j] + [big] + self.partitions[j + 2:]
        self.merges += 1

    @property
    def num_docs(self) -> int:
        return sum(p.num_docs for p in self.partitions)
