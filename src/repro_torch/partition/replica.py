"""Replica sets — availability and durability (§2.2, §5.3).

Cosmos DB keeps four data replicas per partition by default (vs. one in
Pinecone serverless — a point §5.3 presses). We model the replica-set
control plane faithfully enough to demonstrate the fault-tolerance story:

  * quorum writes: an insert acks after ⌈(R+1)/2⌉ replicas apply it; lagging
    replicas catch up from the WAL;
  * failover: killing the primary promotes the most-caught-up secondary;
    a replacement replica rebuilds from snapshot + WAL replay;
  * read spreading: queries round-robin over healthy replicas, which is
    what fan-out hedging exploits for stragglers.

One authoritative StoreProviderSet holds the data; replicas are modeled as
(applied-LSN, alive) cursors over its WAL — the realistic bookkeeping
without 4× memory. `rebuild()` exercises the real snapshot/WAL recovery
path of the port's ``store.provider``, into a provider on the partition's
own device.

The port of ``repro.partition.replica``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ReplicaState:
    rid: int
    alive: bool = True
    applied_lsn: int = 0
    reads: int = 0  # queries served by this replica (read spreading)
    down_since_s: float = 0.0  # when the replica died (re-probe cooldown)


class ReplicaSet:
    def __init__(self, partition, num_replicas: int = 4,
                 reprobe_after_s: float = 5.0):
        self.partition = partition  # PhysicalPartition with StoreProviderSet
        self.replicas = [ReplicaState(i) for i in range(num_replicas)]
        self.primary = 0
        self.lsn = 0
        self.failovers = 0
        self.reprobe_after_s = float(reprobe_after_s)
        self.recoveries = 0
        self._rr = 0

    # ------------------------------------------------------------------
    @property
    def quorum(self) -> int:
        return len(self.replicas) // 2 + 1

    def healthy(self) -> list[ReplicaState]:
        return [r for r in self.replicas if r.alive]

    def add_replica(self) -> ReplicaState:
        """Scale-out actuation (the serving control plane): a new replica joins at
        the set's current LSN — in this model the authoritative store
        already holds every applied write, so the joiner is immediately
        caught up (the real path would seed it via ``capture()`` +
        WAL replay, which ``rebuild()`` exercises). Quorum grows with
        the set (⌈(R+1)/2⌉ over the new count)."""
        r = ReplicaState(rid=len(self.replicas), applied_lsn=self.lsn)
        self.replicas.append(r)
        return r

    # ------------------------------------------------------------------
    def insert(self, doc_ids, pk_hashes, vectors: np.ndarray, props=None):
        """Write through the primary; ack at quorum."""
        if not self.replicas[self.primary].alive:
            self.failover()
        out = self.partition.insert(doc_ids, pk_hashes, vectors, props=props)
        self.lsn += 1
        acked = 0
        for r in self.healthy():
            r.applied_lsn = self.lsn  # synchronous apply in-model
            acked += 1
        if acked < self.quorum:
            raise RuntimeError(
                f"write cannot reach quorum ({acked}/{self.quorum}) — partition offline"
            )
        return out

    def search(self, queries, k, L=None, **kw):
        """Read-spread across healthy replicas (round robin): the cursor
        actually SELECTS the serving replica — dead replicas receive no
        reads, and per-replica read counts make the spreading observable
        (it is what fan-out hedging exploits for stragglers)."""
        healthy = self.healthy()
        if not healthy:
            raise RuntimeError("no healthy replicas")
        replica = healthy[self._rr % len(healthy)]
        self._rr = (self._rr + 1) % len(healthy)
        replica.reads += 1
        return self.partition.search(queries, k, L, **kw)

    def note_read(self, rid: int):
        """Attribute one externally-routed read (the engine's lane plane
        routes reads itself; this keeps per-replica counts observable)."""
        self.replicas[rid].reads += 1

    def read_counts(self) -> dict[int, int]:
        return {r.rid: r.reads for r in self.replicas}

    # ------------------------------------------------------------------
    # failures
    # ------------------------------------------------------------------
    def kill(self, rid: int, now_s: float = 0.0):
        r = self.replicas[rid]
        if not r.alive:
            return
        r.alive = False
        r.down_since_s = float(now_s)
        if rid == self.primary:
            self.failover()

    def probe_dead(self, now_s: float) -> list[int]:
        """Re-probe dead replicas whose cooldown has elapsed and bring
        them back through the real rebuild path — a dead replica is not
        dead forever. Returns the rids revived this probe."""
        revived = []
        for r in self.replicas:
            if not r.alive and now_s - r.down_since_s >= self.reprobe_after_s:
                self.rebuild(r.rid)
                self.recoveries += 1
                revived.append(r.rid)
        return revived

    def failover(self):
        """Promote the most-caught-up healthy secondary."""
        healthy = self.healthy()
        if not healthy:
            raise RuntimeError("total partition loss")
        self.primary = max(healthy, key=lambda r: r.applied_lsn).rid
        self.failovers += 1

    def capture(self) -> tuple[bytes, bytes, int, int]:
        """Atomically capture ``(snapshot, wal, set_lsn, store_lsn)``: the
        replica-set LSN is read *with* the snapshot/WAL pair, so a rebuild
        finishing later cannot claim writes that landed after the capture."""
        pv = self.partition.providers
        lsn = self.lsn
        snap = pv.snapshot_bytes()
        wal = pv.wal_bytes()
        return snap, wal, lsn, pv.committed

    def rebuild(self, rid: int, capture=None):
        """Replace a dead replica: snapshot + WAL replay through the real
        recovery path. The revived replica's ``applied_lsn`` is the LSN
        captured with the snapshot/WAL pair — NOT the set's current LSN,
        which may have advanced past what the pair contains; a lagging
        rebuild comes back behind and catches up like any other replica."""
        snap, wal, lsn, store_lsn = capture or self.capture()
        pv = self.partition.providers
        fresh = type(pv)(
            pv.neighbors.shape[0], pv.neighbors.shape[1],
            pv.codes.shape[1], pv.vectors.shape[1], device=pv.device,
        )
        applied = fresh.recover(snap, wal)
        assert applied == store_lsn, (
            f"rebuild replayed {applied} committed records, capture had "
            f"{store_lsn}"
        )
        if lsn == self.lsn:  # nothing landed since capture: full parity
            assert np.array_equal(fresh.live, pv.live)
        self.replicas[rid].alive = True
        self.replicas[rid].applied_lsn = lsn
        return fresh
