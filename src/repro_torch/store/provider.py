"""StoreProviderSet: the provider traits backed by the Bw-Tree analogue, the
port of ``repro.store.provider`` on the port's ``core.providers``.

The write path mirrors Fig 15: the index orchestrator calls the provider,
which encodes index terms (terms.py) into the Bw-Tree (durability and RU
metering) and writes through to the dense arrays; the setters of
``ArrayProviderSet`` mark the rows they write, and ``materialize`` copies
those rows to the device mirror. Reads for the query hot path come from
the mirror; the store read path serves cold reads and page / chain-length
accounting.

A write-ahead log gives crash recovery: ``snapshot_bytes()`` + WAL replay
rebuild the store and the arrays. The bytes go through the pickle-free
codec of ``store/codec.py`` (the reference's layout, so either package
reads what the other wrote): the snapshot is versioned and CRC'd, each WAL
record is one committed transaction with its own CRC, so recovery truncates
a torn tail to the last whole transaction and rejects interior bit rot.
WAL entries hold numpy arrays, never tensors. Writes inside a ``begin_op``
/ ``end_op`` window commit atomically at ``end_op``; a crash in between
leaves no trace of the interrupted operation in the log.

The paged full-precision tier (``pages``) comes from ``ArrayProviderSet``,
as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..device import DeviceLike
from ..core.providers import ArrayProviderSet, Context
from . import codec as storecodec
from .bwtree import BwTree
from .ru import OpCounters, RUConfig, RUMeter
from .terms import TermCodec, merge_adjacency


class StoreProviderSet(ArrayProviderSet):
    """Write-through providers: Bw-Tree terms + dense arrays and their device
    mirror + RU meter + paged tier."""

    def __init__(
        self,
        capacity: int,
        R_slack: int,
        M: int,
        dim: int,
        path: str = "/embedding",
        ru: Optional[RUMeter] = None,
        cache_pages: int = 1 << 30,
        wal: bool = True,
        device: DeviceLike = None,
    ):
        super().__init__(capacity, R_slack, M, dim, device=device)
        self._cache_pages = cache_pages
        self.tree = BwTree(merge_fn=merge_adjacency, cache_pages=cache_pages)
        self.codec = TermCodec(path)
        self.meter = ru or RUMeter(RUConfig())
        self.op = OpCounters()  # counters for the current logical operation
        # committed WAL: one record (list of entries) per transaction
        self._wal: list[list[tuple]] | None = [] if wal else None
        self._txn: list[tuple] | None = None  # open (uncommitted) transaction
        self.committed = 0  # committed records since construction/recovery
        self.snapshot_lsn = 0  # `committed` as of the last snapshot
        self.recovered_torn_tail = False
        self.faults = None  # optional store.faults.FaultPlan

    # ------------------------------------------------------------------
    def barrier(self, name: str):
        """Crash-injection point: a no-op unless a FaultPlan is attached."""
        if self.faults is not None:
            self.faults.barrier(name)

    def begin_op(self):
        self.op = OpCounters()
        # open a WAL transaction; an uncommitted one left behind by an
        # injected crash is discarded — exactly what a process kill does
        self._txn = [] if self._wal is not None else None

    def end_op(self) -> tuple[float, float]:
        """Returns (RU charge, modelled latency ms) for the finished op.
        Commits the op's WAL transaction atomically: all entries land as
        one record, or (if the op crashed before reaching here) none do."""
        self.op.page_reads = self.tree.stats.page_reads
        self.op.cache_misses = self.tree.stats.cache_misses
        self.op.chain_records = self.tree.stats.delta_traversals
        self.tree.stats.reset()
        ru = self.meter.charge(self.op)
        lat = self.meter.latency_ms(self.op)
        if self._wal is not None and self._txn:
            self._wal.append(self._txn)
            self.committed += 1
        self._txn = None
        return ru, lat

    def _log(self, *entry):
        if self._wal is None:
            return
        if self._txn is not None:
            self._txn.append(entry)
        else:  # bare write outside a begin_op/end_op window: auto-commit
            self._wal.append([entry])
            self.committed += 1

    # ------------------------------------------------------------------
    # neighbor (forward) terms
    # ------------------------------------------------------------------
    def set_neighbors(self, ctx: Context, ids, rows):
        super().set_neighbors(ctx, ids, rows)
        rows = np.asarray(rows)
        for i, node in enumerate(np.asarray(ids)):
            row = rows[i]
            docs = [int(x) for x in row[row >= 0]]
            self.tree.upsert(
                self.codec.adj_key(int(node), ctx.shard_key),
                self.codec.encode_adjacency(docs),
            )
            self.op.adj_writes += 1
        self._log("set_neighbors", np.asarray(ids).copy(), rows.copy())

    def append_neighbors(self, ctx: Context, node: int, new_ids):
        fitted = super().append_neighbors(ctx, node, new_ids)
        # blind incremental update — the paper's fast append path
        self.tree.append(
            self.codec.adj_key(int(node), ctx.shard_key),
            self.codec.encode_adjacency([int(x) for x in new_ids[:fitted]]),
        )
        self.op.adj_writes += 1
        self._log("append_neighbors", int(node), np.asarray(new_ids[:fitted]).copy())
        return fitted

    def read_neighbors_from_store(self, ctx: Context, node: int) -> list[int]:
        self.op.adj_reads += 1
        v = self.tree.get(self.codec.adj_key(int(node), ctx.shard_key))
        return self.codec.decode_adjacency(v) if v else []

    # ------------------------------------------------------------------
    # quantized (inverted) terms
    # ------------------------------------------------------------------
    def set_quant(self, ctx: Context, ids, codes, versions):
        super().set_quant(ctx, ids, codes, versions)
        codes = np.asarray(codes)
        versions = np.asarray(versions)
        for i, node in enumerate(np.asarray(ids)):
            self.tree.upsert(
                self.codec.quant_key(int(node), ctx.shard_key),
                self.codec.encode_quant_value(codes[i].tobytes(), int(versions[i])),
            )
            self.op.quant_writes += 1
        self._log("set_quant", np.asarray(ids).copy(), codes.copy(), versions.copy())

    def read_quant_from_store(self, ctx: Context, node: int):
        self.op.quant_reads += 1
        v = self.tree.get(self.codec.quant_key(int(node), ctx.shard_key))
        if v is None:
            return None
        codes, ver = self.codec.decode_quant_value(v)
        return np.frombuffer(codes, np.uint8), ver

    # ------------------------------------------------------------------
    # inverted property terms (predicate postings)
    # ------------------------------------------------------------------
    def write_prop_posting(self, term_key: bytes, words: np.ndarray):
        """Persist one PROP_TERM posting bitmap (store.props write-through):
        the predicate index durably rides the same Bw-Tree as the quantized
        and adjacency terms, and each upsert is RU-metered."""
        self.tree.upsert(term_key, self.codec.encode_posting(words))
        self.op.prop_writes += 1
        self._log("write_prop_posting", bytes(term_key),
                  np.asarray(words).copy())

    def read_prop_posting(self, term_key: bytes) -> Optional[np.ndarray]:
        self.op.prop_reads += 1
        v = self.tree.get(term_key)
        return None if v is None else self.codec.decode_posting(v)

    # ------------------------------------------------------------------
    # document store (full vectors)
    # ------------------------------------------------------------------
    def set_full(self, ctx: Context, ids, vecs):
        super().set_full(ctx, ids, vecs)
        vecs = np.asarray(vecs)
        self.op.doc_writes += len(np.asarray(ids))
        self.op.vector_kb += vecs.nbytes / 1024.0
        self._log("set_full", np.asarray(ids).copy(), vecs.copy())

    def get_full(self, ctx: Context, ids):
        self.op.full_reads += len(np.asarray(ids))
        return super().get_full(ctx, ids)

    def set_live(self, ctx: Context, ids, value: bool):
        super().set_live(ctx, ids, value)
        self._log("set_live", np.asarray(ids).copy(), value)

    # ------------------------------------------------------------------
    # durability: snapshot + WAL replay (pickle-free; store/codec.py)
    # ------------------------------------------------------------------
    def snapshot_bytes(self) -> bytes:
        """Checkpoint the durable state (dense caches + every term in the
        Bw-Tree) and clear the committed WAL. Uncommitted transaction
        entries are never captured — they don't exist durably yet."""
        self.snapshot_lsn = self.committed
        if self._wal is not None:
            self._wal = []
        return storecodec.encode_snapshot(
            self.neighbors, self.codes, self.versions, self.live,
            self.vectors, self.tree.dump_items(), self.snapshot_lsn,
        )

    def wal_bytes(self) -> bytes:
        return storecodec.encode_wal(self._wal or [])

    def _check_replay_entry(self, name: str, args: tuple):
        """Schema-check decoded WAL args against THIS provider's topology
        before they touch fancy indexing (recovery bytes are untrusted)."""
        capacity = self.neighbors.shape[0]
        if name == "write_prop_posting":
            return
        ids = np.atleast_1d(args[0])
        if ids.size and (ids.min() < 0 or ids.max() >= capacity):
            raise storecodec.StoreCodecError(f"{name}: doc id out of range")
        want = {
            "set_neighbors": (1, self.neighbors.shape[1]),
            "set_quant": (1, self.codes.shape[1]),
            "set_full": (1, self.vectors.shape[1]),
        }.get(name)
        if want is not None:
            rows = np.asarray(args[1])
            if rows.ndim != 2 or rows.shape[1] != want[1] \
                    or rows.shape[0] != ids.shape[0]:
                raise storecodec.StoreCodecError(f"{name}: row shape mismatch")

    def recover(self, snapshot: bytes, wal: bytes,
                ctx: Context = Context()) -> int:
        """Restore from (snapshot, wal) bytes: validate + load the
        snapshot, rebuild the term tree, then replay committed WAL records
        to the longest consistent prefix. A torn tail is truncated
        (``recovered_torn_tail`` flags it); interior corruption raises.
        Returns the applied LSN (committed-record count)."""
        arrays, tree_items, base_lsn = storecodec.decode_snapshot(
            snapshot, self.neighbors.shape[0], self.neighbors.shape[1],
            self.codes.shape[1], self.vectors.shape[1],
        )
        records, torn = storecodec.decode_wal(wal)  # parse BEFORE mutating
        self.neighbors[:] = arrays["neighbors"].reshape(self.neighbors.shape)
        self.codes[:] = arrays["codes"].reshape(self.codes.shape)
        self.versions[:] = arrays["versions"]
        self.live[:] = arrays["live"].astype(bool)
        self.vectors[:] = arrays["vectors"].reshape(self.vectors.shape)
        tree = BwTree(merge_fn=merge_adjacency, cache_pages=self._cache_pages)
        for key, value in tree_items:
            tree.upsert(key, value)
        self.tree = tree
        self._dirty()  # the whole mirror is uploaded again; replay's setters mark their rows
        saved_wal, self._wal = self._wal, None  # don't re-log during replay
        self._txn = None
        try:
            for entries in records:
                for name, *args in entries:
                    self._check_replay_entry(name, tuple(args))
                    if name == "write_prop_posting":
                        self.write_prop_posting(args[0], args[1])
                    elif name == "set_live":
                        self.set_live(ctx, args[0], bool(args[1]))
                    elif name == "append_neighbors":
                        # python int → basic indexing (a 0-d array index
                        # would copy the row instead of viewing it)
                        self.append_neighbors(ctx, int(args[0]), args[1])
                    else:
                        getattr(self, name)(ctx, *args)
        finally:
            self._wal = [] if saved_wal is not None else None
        self.committed = base_lsn + len(records)
        self.snapshot_lsn = base_lsn
        self.recovered_torn_tail = torn
        return self.committed
