"""Provider traits, the paper's stateless-DiskANN interface (§3.1): the port
of ``repro.core.providers``.

The library reads and writes index terms -- quantized vectors,
full-precision vectors, neighbor lists -- through providers owned by the
database, addressed by an execution ``Context``.

``ArrayProviderSet`` keeps numpy arrays as the canonical state, as the
reference does, plus one device tensor mirroring each. The reference
re-uploads all five arrays after every write; here every setter records the
rows it wrote and ``materialize`` copies only those rows to the device, so
the upload per insert mini-batch is O(rows written), not O(capacity). The
tensors it returns are the same either way.

Like the reference's, every provider carries the paged full-precision tier
(``pages``, a ``store.pages.PagedVectorStore`` fully resident until given a
budget, so the index counts tier hits and misses at rerank) and a
``write_count`` epoch: one per setter call and one per whole-array
invalidation, whatever the rows a call marks. Caches of stacked provider
arrays (``partition.fanout.SpmdFanout``) are stamped with it.
``store.StoreProviderSet`` extends this class with the durable terms and the
WAL.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

_FIELDS = ("neighbors", "codes", "versions", "live", "vectors")


@dataclasses.dataclass(frozen=True)
class Context:
    """Execution context (§3.1): which logical index a call targets, plus
    telemetry identity. The database, not the library, interprets it."""

    collection: str = "default"
    replica: int = 0
    shard_key: Optional[int] = None  # sharded-DiskANN logical index (§3.3)
    activity_id: str = ""
    lsn: int = 0


class ProviderSet(Protocol):
    """The union of the paper's Neighbor/QuantVector/FullVector providers."""

    def get_neighbors(self, ctx: Context, ids: np.ndarray) -> np.ndarray: ...
    def set_neighbors(self, ctx: Context, ids: np.ndarray, rows: np.ndarray) -> None: ...
    def append_neighbors(self, ctx: Context, node: int, new_ids: np.ndarray) -> int: ...
    def get_quant(self, ctx: Context, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]: ...
    def set_quant(self, ctx: Context, ids: np.ndarray, codes: np.ndarray, versions: np.ndarray) -> None: ...
    def get_full(self, ctx: Context, ids: np.ndarray) -> np.ndarray: ...
    def set_full(self, ctx: Context, ids: np.ndarray, vecs: np.ndarray) -> None: ...
    def set_live(self, ctx: Context, ids: np.ndarray, value: bool) -> None: ...
    def materialize(self, ctx: Context): ...
    def barrier(self, name: str) -> None: ...


class ArrayProviderSet:
    """Memory-backed providers: numpy canonical state, device mirrors written
    through row-wise."""

    def __init__(self, capacity: int, R_slack: int, M: int, dim: int,
                 device: DeviceLike = None):
        # deferred import: store.provider subclasses this module, so a
        # top-level import of the store package would be circular
        from ..store.pages import PagedVectorStore

        self.device = resolve_device(device)
        self.neighbors = np.full((capacity, R_slack), -1, np.int32)
        self.codes = np.zeros((capacity, M), np.uint8)
        self.versions = np.zeros((capacity,), np.uint8)
        self.live = np.zeros((capacity,), bool)
        self.vectors = np.zeros((capacity, dim), np.float32)
        # the paged tier's residency ledger: budget None keeps every page resident
        self.pages = PagedVectorStore(capacity, dim)
        self._mirror: dict[str, torch.Tensor] = {}
        self._pending: dict[str, list[np.ndarray]] = {f: [] for f in _FIELDS}
        self.write_count = 0

    def barrier(self, name: str) -> None:
        """Named crash-barrier hook; a no-op for memory-backed terms."""

    # -- invalidation ------------------------------------------------------
    def _dirty(self):
        """Whole-array invalidation: the next ``materialize`` uploads all."""
        self._mirror = {}
        self._pending = {f: [] for f in _FIELDS}
        self.write_count += 1

    def _wrote(self, fields: tuple, ids) -> None:
        """One setter call: its rows of ``fields`` go up at the next
        ``materialize``, and the write epoch advances once."""
        rows = np.asarray(ids, np.int64).reshape(-1)
        for f in fields:
            self._pending[f].append(rows)
        self.write_count += 1

    def materialize(self, ctx: Context = Context()):
        """Device tensors (neighbors, codes, versions, live, vectors), brought
        up to date by copying only the rows written since the last call."""
        if not self._mirror:
            self._mirror = {f: torch.from_numpy(getattr(self, f)).to(self.device)
                            for f in _FIELDS}
            self._pending = {f: [] for f in _FIELDS}
        for f in _FIELDS:
            if self._pending[f]:
                rows = np.unique(np.concatenate(self._pending[f]))
                src = torch.from_numpy(getattr(self, f)[rows])
                self._mirror[f][torch.from_numpy(rows).to(self.device)] = src.to(self.device)
                self._pending[f] = []
        return tuple(self._mirror[f] for f in _FIELDS)

    # -- neighbor terms ------------------------------------------------------
    def get_neighbors(self, ctx: Context, ids):
        return self.neighbors[np.asarray(ids)]

    def set_neighbors(self, ctx: Context, ids, rows):
        self.neighbors[np.asarray(ids)] = rows
        self._wrote(("neighbors",), ids)

    def append_neighbors(self, ctx: Context, node: int, new_ids):
        """Blind incremental append (the Bw-Tree forward-term fast path)."""
        row = self.neighbors[node]
        deg = int((row >= 0).sum())
        n = min(len(new_ids), row.shape[0] - deg)
        row[deg: deg + n] = new_ids[:n]
        self._wrote(("neighbors",), [node])
        return n  # how many fit; caller prunes on overflow

    # -- quantized terms ---------------------------------------------------
    def get_quant(self, ctx: Context, ids):
        ids = np.asarray(ids)
        return self.codes[ids], self.versions[ids]

    def set_quant(self, ctx: Context, ids, codes, versions):
        ids = np.asarray(ids)
        self.codes[ids] = codes
        self.versions[ids] = versions
        self._wrote(("codes", "versions"), ids)

    # -- full-precision vectors (document store role) ----------------------
    def get_full(self, ctx: Context, ids):
        return self.vectors[np.asarray(ids)]

    def set_full(self, ctx: Context, ids, vecs):
        self.vectors[np.asarray(ids)] = vecs
        self._wrote(("vectors",), ids)

    def set_live(self, ctx: Context, ids, value: bool):
        self.live[np.asarray(ids)] = value
        self._wrote(("live",), ids)
