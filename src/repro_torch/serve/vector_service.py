"""VectorCollectionService — the user-facing query layer (§3.5).

Ties together everything the paper composes: JSON-ish documents with a
declared vector path, automatic index-term generation on ingest, the
VectorDistance query function with the planner's selectivity routing
(brute force / Q-Flat / graph ± filters), paginated queries with
client-side continuation tokens (the 5-second-preemption model), sharded
DiskANN for multi-tenancy, and cross-partition fan-out with RU accounting.

Since the serving PR this class is a thin façade over
``serve.vector_engine.VectorServeEngine``: every query path flows through
the engine (admission control, micro-batching, metrics, simulated clock),
and ingest rides the engine's interleaved mini-batch queue. The service
keeps what needs the document store — property-term extraction at ingest,
tenant routing, and pagination state. The engine's dispatch plane
(``EngineConfig.dispatch_mode``) gets this service's replica sets wired
in, so lane health routes reads and dead replicas re-probe.

This is the host-side service; the device-parallel path for the same
operation is `partition.fanout.SpmdFanout` (the engine's
``dispatch_mode="spmd"``).

The port of ``repro.serve.vector_service``. The collection, the tenant
collections and the engine live on ``device`` (the CUDA card unless the
caller passes ``device="cpu"``); continuation tokens decode onto it.
``from_reference_state`` wraps a collection given as the reference's plain
state, so the two packages can serve one state side by side.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

from ..core import GraphConfig
from ..device import DeviceLike
from ..core.graph import bitmap_words
from ..core.index import PAGE_BACKUP_CAP
from ..partition import Collection, CollectionConfig, ReplicaSet
from ..partition.fanout import (compile_partition_filter,
                                paged_fanout_fingerprint, paged_fanout_search,
                                start_paged_fanout)
from .continuation import (ContinuationError, decode_continuation,
                           encode_continuation)
from .predicate import Predicate, property_items
from .vector_engine import EngineConfig, ServeRequest, Throttled, VectorServeEngine


class DeadlineExceeded(Exception):
    """408-style abandonment: the request's deadline expired while it was
    still queued; no work was done and the RU reservation was refunded."""

    def __init__(self, tenant: Any, waited_ms: float):
        super().__init__(
            f"tenant {tenant!r} request abandoned after waiting "
            f"{waited_ms:.3f} ms past its deadline"
        )
        self.tenant = tenant
        self.waited_ms = waited_ms


@dataclasses.dataclass
class VectorQuery:
    vector: np.ndarray
    k: int = 10
    # WHERE clause: a declarative ``serve.predicate.Predicate``, compiled
    # to index-term bitmaps and batched through the engine. Opaque
    # callables are rejected with ``ValueError`` — the legacy host path
    # (``filtered-legacy[...]`` plans) is gone.
    filter: Optional[Predicate] = None
    search_list_multiplier: float = 5.0  # searchListSizeMultiplier
    exact: bool = False  # VectorDistance(..., true) → brute force
    shard_key: Any = None  # route to a sharded-DiskANN tenant index
    tenant: Any = "default"  # RU-admission principal (429s when over budget)
    beam_width: Optional[int] = None  # paged-path W override; None → engine cfg
    # queue-abandonment budget (ms): expires → DeadlineExceeded (408),
    # reservation refunded. None → EngineConfig.default_deadline_ms.
    deadline_ms: Optional[float] = None


@dataclasses.dataclass
class QueryResult:
    ids: np.ndarray
    dists: np.ndarray
    ru: float
    plan: str
    continuation: Optional[bytes] = None
    latency_ms: float = 0.0
    # False → one or more partitions were unreachable and the results
    # merge only the survivors (see the plan's ``+degraded[pids]`` marker)
    complete: bool = True


class VectorCollectionService:
    """A collection with vector indexing enabled on one path."""

    def __init__(
        self,
        dim: int,
        graph: Optional[GraphConfig] = None,
        max_vectors_per_partition: int = 100_000,
        initial_partitions: int = 1,
        replicas: int = 4,
        shard_key_path: Optional[str] = None,
        engine_cfg: EngineConfig = EngineConfig(),
        resident_frac: Optional[float] = None,
        vector_page_size: int = 64,
        device: DeviceLike = None,
    ):
        graph = graph or GraphConfig(capacity=max_vectors_per_partition + 1024)
        self.cfg = CollectionConfig(
            dim=dim,
            graph=graph,
            max_vectors_per_partition=max_vectors_per_partition,
            initial_partitions=initial_partitions,
            shard_key_path=shard_key_path,
            resident_frac=resident_frac,
            vector_page_size=vector_page_size,
        )
        self._wire(Collection(self.cfg, device=device), replicas, engine_cfg,
                   device)

    def _wire(self, collection: Collection, replicas: int,
              engine_cfg: EngineConfig, device: DeviceLike) -> None:
        self.device = device
        self.collection = collection
        self.replica_sets = [
            ReplicaSet(p, num_replicas=replicas) for p in self.collection.partitions
        ]
        self.docs: dict[int, dict] = {}  # document store (JSON side)
        self.shard_key_path = self.cfg.shard_key_path
        # sharded DiskANN: tenant value → per-tenant collection
        self._tenant_collections: dict[Any, Collection] = {}
        self.engine = VectorServeEngine(
            self.collection, cfg=engine_cfg, resolver=self._partitions_for,
            replica_sets=self.replica_sets, device=device,
        )

    @classmethod
    def from_reference_state(cls, state: dict, docs: dict[int, dict],
                             cfg: CollectionConfig, *, replicas: int = 4,
                             engine_cfg: EngineConfig = EngineConfig(),
                             device: DeviceLike = None,
                             ) -> "VectorCollectionService":
        """A service around a collection given as the reference's plain
        state: ``state`` is ``Collection.from_reference_state``'s dict, plus
        ``tenants`` (shard-key value → such a dict) when ``cfg`` shards by
        tenant; ``docs`` is the document store. Replica sets and the engine
        start fresh, as a newly constructed service's do."""
        svc = cls.__new__(cls)
        svc.cfg = cfg
        svc._wire(Collection.from_reference_state(cfg, state, device),
                  replicas, engine_cfg, device)
        svc.docs = {int(d): dict(doc) for d, doc in docs.items()}
        tenant_cfg = dataclasses.replace(cfg, initial_partitions=1)
        for key, st in state.get("tenants", {}).items():
            svc._tenant_collections[key] = Collection.from_reference_state(
                tenant_cfg, st, device)
        return svc

    def _partitions_for(self, shard_key: Any):
        if shard_key is not None and self.shard_key_path:
            return self._tenant(shard_key).partitions
        return self.collection.partitions

    def set_residency(self, frac: Optional[float]) -> None:
        """Resize every partition's paged full-precision tier to hold
        ``frac`` of its vector pages (None → fully resident). Search keeps
        answering out of the always-resident PQ codes + adjacency; only
        the final-rerank page fetches see the new budget."""
        for p in self.collection.partitions:
            p.set_residency(frac)

    # ------------------------------------------------------------------
    # ingest (through the engine's interleaved mini-batch queue)
    # ------------------------------------------------------------------
    def upsert(self, documents: Sequence[dict], vectors: np.ndarray,
               partition_keys: Optional[Sequence] = None,
               tenant: Any = "default") -> float:
        """Insert documents (dicts with 'id') + their embedding vectors.
        Synchronous: enqueues chunked ingest work on the engine and drains
        it before returning (use ``upsert_async`` to leave it interleaving
        with query traffic). ``tenant`` attributes the write RU in the
        engine's per-tenant cost registry."""
        total = self.upsert_async(documents, vectors, partition_keys,
                                  tenant=tenant)
        self.engine.flush_ingest()
        return total.value

    def upsert_async(self, documents: Sequence[dict], vectors: np.ndarray,
                     partition_keys: Optional[Sequence] = None,
                     tenant: Any = "default") -> "_RUTally":
        vectors = np.asarray(vectors, np.float32)
        ids = [int(d["id"]) for d in documents]
        pks = list(partition_keys) if partition_keys is not None else ids
        tally = _RUTally()
        chunk = self.engine.cfg.ingest_chunk
        for lo in range(0, len(documents), chunk):
            hi = min(lo + chunk, len(documents))
            docs_c = list(documents[lo:hi])
            ids_c, pks_c, vecs_c = ids[lo:hi], pks[lo:hi], vectors[lo:hi]
            self.engine.submit_ingest(
                "upsert",
                lambda d=docs_c, i=ids_c, p=pks_c, v=vecs_c:
                    tally.add(self._apply_upsert(d, i, p, v)),
                len(docs_c), tenant=tenant,
            )
        return tally

    def _apply_upsert(self, documents, ids, pks, vectors) -> float:
        ru = 0.0
        if self.shard_key_path:
            # sharded-DiskANN identity includes the shard key: re-upserting
            # a doc under a different shard value MOVES it — tombstone the
            # copy in the old tenant's index first, or that tenant serves
            # the deleted/stale document forever
            for d in documents:
                old = self.docs.get(int(d["id"]))
                if old is not None:
                    old_key = old.get(self.shard_key_path)
                    if old_key != d.get(self.shard_key_path):
                        ru += self._tenant(old_key).delete_by_id([int(d["id"])])
        for d in documents:
            self.docs[int(d["id"])] = d
        # property-term extraction happens ONCE at ingest: each partition's
        # inverted PROP_TERM postings track the doc from here on, so the
        # predicate query path never has to look at the document again
        props = [property_items(d) for d in documents]
        ru += self.collection.insert(ids, pks, vectors, props=props)
        if self.shard_key_path:
            groups: dict[Any, list[int]] = {}
            for i, d in enumerate(documents):
                groups.setdefault(d.get(self.shard_key_path), []).append(i)
            for key, rows in groups.items():
                ru += self._tenant(key).insert(
                    [ids[i] for i in rows], [pks[i] for i in rows],
                    vectors[rows], props=[props[i] for i in rows],
                )
        return ru

    def delete(self, doc_ids: Sequence[int], tenant: Any = "default") -> float:
        total = self.delete_async(doc_ids, tenant=tenant)
        self.engine.flush_ingest()
        return total.value

    def delete_async(self, doc_ids: Sequence[int],
                     tenant: Any = "default") -> "_RUTally":
        tally = _RUTally()
        chunk = self.engine.cfg.ingest_chunk
        doc_ids = list(doc_ids)
        for lo in range(0, len(doc_ids), chunk):
            ids_c = doc_ids[lo:lo + chunk]
            self.engine.submit_ingest(
                "delete", lambda i=ids_c: tally.add(self._apply_delete(i)),
                len(ids_c), tenant=tenant,
            )
        return tally

    def _apply_delete(self, doc_ids: Sequence[int]) -> float:
        doc_ids = [int(d) for d in doc_ids]
        shard_groups: dict[Any, list[int]] = {}
        for d in doc_ids:
            doc = self.docs.pop(d, None)
            if doc is not None and self.shard_key_path:
                shard_groups.setdefault(doc.get(self.shard_key_path), []).append(d)
        # route by each doc's OWNING partition (which recorded the pk at
        # ingest) — deleting "by id as pk" sends custom-keyed docs to the
        # wrong partition, where the tombstone is a silent no-op
        ru = self.collection.delete_by_id(doc_ids)
        for key, ids in shard_groups.items():
            ru += self._tenant(key).delete_by_id(ids)
        return ru

    def _tenant(self, key) -> Collection:
        if key not in self._tenant_collections:
            self._tenant_collections[key] = Collection(
                dataclasses.replace(self.cfg, initial_partitions=1),
                device=self.device,
            )
        return self._tenant_collections[key]

    # ------------------------------------------------------------------
    # query (§3.5 routing — thin façade over the engine)
    # ------------------------------------------------------------------
    def query(self, q: VectorQuery) -> QueryResult:
        """Route one query through the serving engine. Raises ``Throttled``
        when the tenant is over its RU budget (the 429 path) and
        ``DeadlineExceeded`` when ``q.deadline_ms`` (or the engine's
        default) expires while the request is queued (the 408 path — the
        reservation is refunded, no partition work happens). A query that
        merged only a subset of partitions (the rest down/faulted)
        returns ``complete=False`` rather than failing; only every
        partition failing raises (``partition.fanout.AllPartitionsFailed``).

        ``q.filter`` must be a declarative ``Predicate`` (or None): it
        flows through the engine's micro-batcher (same-predicate queries
        coalesce and share one compiled bitmap per partition — plan
        ``filtered-batched[...]`` / ``exact-filtered``). Opaque callables
        raise ``ValueError``: the legacy host path that served them
        (O(capacity) doc-store scan per partition per query, plans
        ``filtered-legacy[...]``) is retired."""
        qv = np.asarray(q.vector, np.float32)

        if q.filter is not None and not isinstance(q.filter, Predicate):
            raise ValueError(
                "callable filters are no longer supported (the legacy "
                "filtered-legacy[...] host path is retired); build a "
                "declarative predicate with repro_torch.serve.F, e.g. "
                "F.eq('category', 3)"
            )

        L = max(q.k, int(round(q.search_list_multiplier * q.k)))
        rid = self.engine.next_rid()
        resp = self.engine.query_sync(ServeRequest(
            rid=rid, vector=qv, k=q.k, L=L, tenant=q.tenant,
            exact=q.exact, shard_key=q.shard_key, predicate=q.filter,
            deadline_ms=q.deadline_ms,
        ))
        if resp.status == 429:
            raise Throttled(q.tenant, resp.retry_after_s)
        if resp.status == 408:
            raise DeadlineExceeded(q.tenant, resp.wait_ms)
        return QueryResult(resp.ids, resp.dists, resp.ru, resp.plan,
                           latency_ms=resp.latency_ms,
                           complete=resp.complete)

    # ------------------------------------------------------------------
    # pagination / continuation tokens (§3.5 "Continuations")
    # ------------------------------------------------------------------
    def query_page(self, q: VectorQuery, continuation: Optional[bytes] = None,
                   page_size: int = 10) -> QueryResult:
        """One page of a cross-partition paginated query, through the
        engine.

        The continuation token carries one pagination cursor per physical
        partition (plus fetched-but-unemitted buffers and per-partition
        high-water marks); each page fans out ``next_page`` to whichever
        partitions need refilling and merges client-side, so pages never
        repeat or skip results across partitions. The page is RU-metered
        and admission-controlled exactly like the main path: an
        over-budget tenant gets ``Throttled`` (429 + retry-after) with no
        budget consumed, and every served page bills at least the request
        floor. ``shard_key`` routes to a sharded-DiskANN tenant index;
        ``q.beam_width`` overrides the engine's per-round hop batching.

        ``q.filter`` must be a declarative ``Predicate`` (or None): the
        compiled per-partition bitmap threads through
        ``paged_fanout_search`` so every emitted row satisfies the
        predicate, with no-match partitions exhausted at birth. Opaque
        callable filters are REJECTED here — the old behavior silently
        ignored them and returned unfiltered pages, which is worse than an
        error. The token binds to the predicate's canonical key: resuming
        a filtered pagination under a different predicate raises
        ``ContinuationError``.

        Returns ``continuation=None`` once every partition is exhausted
        and its buffers are drained. The client re-sends the SAME query
        vector (and predicate) with each token (the token deliberately
        excludes them, as in the SDK); resuming under a different shard
        key or after a partition split/merge raises ``ContinuationError``.
        """
        if q.filter is not None and not isinstance(q.filter, Predicate):
            raise ValueError(
                "query_page does not support callable filters (they were "
                "previously ignored, silently returning unfiltered pages); "
                "pass a declarative predicate built with repro_torch.serve.F"
            )
        pred = q.filter
        pred_key = pred.key() if pred is not None else None
        qv = np.asarray(q.vector, np.float32)
        target = self._partitions_for(q.shard_key)
        W = int(q.beam_width or self.engine.cfg.beam_width)
        # beam_width is client input on this path: bound it here as a
        # client error, not an error from deep inside the search
        W_max = min((p.index.cfg.L_search for p in target), default=1)
        if not 1 <= W <= W_max:
            raise ValueError(
                f"beam_width {W} out of range [1, {W_max}] for this "
                f"collection's search list size"
            )
        holder: dict[str, Any] = {}

        def body():
            # cursor construction / token decode / predicate compilation
            # happen HERE, behind the engine's admission check: a throttled
            # tenant (or a malformed token) must not trigger per-partition
            # work
            slot_filters = None
            compile_ru = 0.0
            if pred is not None:
                slot_filters = []
                for p in target:
                    if p.num_docs == 0:
                        slot_filters.append(None)
                        continue
                    mask, _words, nreads = compile_partition_filter(p, pred)
                    # compile cost bills like the batched path — a filtered
                    # page on a cold bitmap cache is not free
                    compile_ru += (
                        nreads * p.providers.meter.cfg.ru_per_prop_read
                    )
                    slot_filters.append(mask)
            if continuation is None:
                pstate = start_paged_fanout(target, qv, shard_key=q.shard_key,
                                            pred_key=pred_key,
                                            slot_filters=slot_filters)
            else:
                pstate = decode_continuation(continuation, self.device)
                if pstate.shard_fp != paged_fanout_fingerprint(
                        q.shard_key, target, pred_key):
                    raise ContinuationError(
                        "token does not match this query's routing "
                        "(different shard key or predicate, or the "
                        "partition set changed)"
                    )
                self._check_token_topology(pstate, target)
            if slot_filters is not None:
                # a partition whose match-set went empty since the last
                # page (ingest re-labelled / deleted its matches) must NOT
                # fall back to unfiltered fetches — a None slot_filter
                # means "no filter" downstream. Exhaust its cursor;
                # already-buffered rows (which matched at fetch time)
                # still drain.
                for cur, mask in zip(pstate.cursors, slot_filters):
                    if mask is None and not cur.exhausted:
                        cur.exhausted = True
                        cur.state = None
            holder["pstate"] = pstate
            # under a multi-lane dispatch plane, each refill round's
            # per-partition fetches schedule onto executor lanes (round
            # makespan, not sum); serial keeps the legacy max-of-sums
            # accounting byte-identical
            lane_exec = (self.engine.executor
                         if self.engine.cfg.dispatch_mode != "serial" else None)
            ids, dists, info = paged_fanout_search(
                target, qv, pstate, page_size, beam_width=W,
                slot_filters=slot_filters, executor=lane_exec,
            )
            # per-fetch child spans for the trace plane: one span per
            # partition page-fetch, labelled by refill round
            fetch_spans = [
                dict(name=f"page.fetch[p{e['pid']}]", stage="partition",
                     dur_ms=e["lat_ms"],
                     attrs=dict(pid=e["pid"], round=e["round"], ru=e["ru"]))
                for e in info["fetch_log"]
            ]
            return (ids, dists, info["ru_total"] + compile_ru,
                    info["service_latency_ms"],
                    "paginated" if pred is None else "paginated-filtered",
                    fetch_spans)

        resp = self.engine.execute_host(q.tenant, "paginated", body,
                                        is_page=True)
        pstate = holder["pstate"]
        token = None if pstate.exhausted() else encode_continuation(pstate)
        return QueryResult(resp.ids, resp.dists, resp.ru, resp.plan,
                           continuation=token, latency_ms=resp.latency_ms)

    @staticmethod
    def _check_token_topology(pstate, target) -> None:
        """Schema-level binding of a decoded token to the live partitions:
        cursor count, partition ids, visited-bitmap widths, AND the beam /
        backup array widths must all match the routing that will serve the
        next page. The width checks matter beyond correctness: array
        shapes are launch signatures, so a well-formed token with an
        arbitrary L would mint a fresh signature per request — an easy way
        for a client to break the serving layer's steady-state signature
        contract."""
        if len(pstate.cursors) != len(target):
            raise ContinuationError(
                f"token has {len(pstate.cursors)} cursors for "
                f"{len(target)} partitions"
            )
        for cur, p in zip(pstate.cursors, target):
            if cur.pid != p.pid:
                raise ContinuationError(
                    f"token cursor pid {cur.pid} != partition {p.pid}"
                )
            if cur.state is not None:
                L_want = p.index.cfg.L_search
                if cur.state.best_ids.shape[0] != L_want:
                    raise ContinuationError(
                        f"token beam width {cur.state.best_ids.shape[0]} "
                        f"!= configured L_search {L_want}"
                    )
                if cur.state.backup_ids.shape[0] != PAGE_BACKUP_CAP:
                    raise ContinuationError(
                        f"token backup width {cur.state.backup_ids.shape[0]}"
                        f" != {PAGE_BACKUP_CAP}"
                    )
                words = bitmap_words(p.index.cfg.capacity)
                if cur.state.bitmap.shape[0] != words:
                    raise ContinuationError(
                        f"token bitmap width {cur.state.bitmap.shape[0]} "
                        f"does not fit partition capacity "
                        f"{p.index.cfg.capacity}"
                    )


class _RUTally:
    """Accumulates RU across deferred ingest thunks (the async-upsert
    handle: read ``.value`` after the engine has drained the queue)."""

    def __init__(self):
        self.value = 0.0

    def add(self, ru: float) -> float:
        self.value += ru
        return ru
