"""A Bw-Tree analogue: ordered pages, delta chains, consolidation, cache.

Cosmos DB's Bw-Tree (§2.2) is latch-free and log-structured; what the
paper's vector design *uses* from it is narrower and is what we model:

  * key-ordered logical pages found via a binary-searchable page table;
  * **blind incremental updates**: an append to a key (e.g. new out-edges
    for a graph vertex) is recorded as a delta record without reading the
    base value — O(1) writes, no write amplification;
  * **delta chains** capped at a max length (15 in the paper's experiments);
    reads must traverse the chain, so lookup cost grows with chain length —
    exactly the effect behind Fig 12's declining ingest rate — and
    consolidation merges deltas into the base value via a type-specific
    merge callback (§3.3: "a new corresponding merge callback procedure");
  * a page cache: hot pages pinned in memory with hit/miss accounting,
    feeding the RU/latency model (cold reads = SSD in the paper).

Single-writer semantics (one writer per replica's index-maintenance loop)
make latch-freedom moot here; contracts that matter — *no duplicate insert
patches for a key, no delete patches for a non-existent key* (§2.1) — are
enforced and raise, which is what forces the mini-batch update design.

The port's own copy of ``repro.store.bwtree`` (no JAX there, but importing it
through ``repro`` loads JAX); both packages read and write the same bytes.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Iterator, Optional

PAGE_CAPACITY = 64  # keys per logical page (8KB pages / ~128B terms)
MAX_CHAIN = 15  # paper §4: "Bw-tree max chain length is set to 15"


@dataclasses.dataclass
class BwTreeStats:
    page_reads: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    delta_traversals: int = 0  # chain records walked on reads
    consolidations: int = 0
    writes: int = 0
    splits: int = 0

    def reset(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


class _Page:
    __slots__ = ("keys", "base", "deltas")

    def __init__(self):
        self.keys: list[bytes] = []  # sorted keys present in base
        self.base: dict[bytes, bytes] = {}
        # delta chain, newest last: (op, key, payload)
        self.deltas: list[tuple[str, bytes, bytes]] = []


class BwTree:
    """Ordered KV store with delta chains and a bounded page cache."""

    def __init__(
        self,
        merge_fn: Optional[Callable[[bytes, list[bytes]], bytes]] = None,
        cache_pages: int = 1 << 30,
        page_capacity: int = PAGE_CAPACITY,
        max_chain: int = MAX_CHAIN,
    ):
        # merge callback for blind appends (§3.3) — default: concatenation
        self.merge_fn = merge_fn or (lambda base, deltas: (base or b"") + b"".join(deltas))
        self.page_capacity = page_capacity
        self.max_chain = max_chain
        self.stats = BwTreeStats()
        self._fences: list[bytes] = [b""]  # lower fence key per page
        self._pages: list[_Page] = [_Page()]
        self._cache_pages = cache_pages
        self._hot: dict[int, int] = {}  # page idx -> last access tick
        self._tick = 0

    # ------------------------------------------------------------------
    def _locate(self, key: bytes) -> int:
        return bisect.bisect_right(self._fences, key) - 1

    def _touch(self, pidx: int):
        self._tick += 1
        self.stats.page_reads += 1
        if pidx in self._hot:
            self.stats.cache_hits += 1
        else:
            self.stats.cache_misses += 1
            if len(self._hot) >= self._cache_pages:
                coldest = min(self._hot, key=self._hot.get)
                del self._hot[coldest]
        self._hot[pidx] = self._tick

    def _maybe_consolidate(self, pidx: int, force: bool = False):
        page = self._pages[pidx]
        if not force and len(page.deltas) <= self.max_chain:
            return
        self.stats.consolidations += 1
        appends: dict[bytes, list[bytes]] = {}
        for op, key, payload in page.deltas:
            if op == "set":
                page.base[key] = payload
                appends.pop(key, None)
                if key not in page.keys:
                    bisect.insort(page.keys, key)
            elif op == "append":
                appends.setdefault(key, []).append(payload)
            elif op == "del":
                page.base.pop(key, None)
                appends.pop(key, None)
                i = bisect.bisect_left(page.keys, key)
                if i < len(page.keys) and page.keys[i] == key:
                    page.keys.pop(i)
        for key, payloads in appends.items():
            page.base[key] = self.merge_fn(page.base.get(key), payloads)
            if key not in page.base or key not in page.keys:
                if key not in page.keys:
                    bisect.insort(page.keys, key)
        page.deltas = []
        self._maybe_split(pidx)

    def _maybe_split(self, pidx: int):
        page = self._pages[pidx]
        if len(page.keys) <= self.page_capacity:
            return
        self.stats.splits += 1
        mid = len(page.keys) // 2
        fence = page.keys[mid]
        right = _Page()
        right.keys = page.keys[mid:]
        page.keys = page.keys[:mid]
        for k in right.keys:
            right.base[k] = page.base.pop(k)
        self._pages.insert(pidx + 1, right)
        self._fences.insert(pidx + 1, fence)
        # cache entries after pidx shift by one
        self._hot = {(i + 1 if i > pidx else i): t for i, t in self._hot.items()}

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------
    def put(self, key: bytes, value: bytes):
        pidx = self._locate(key)
        page = self._pages[pidx]
        # contract (§2.1): no duplicate *insert* patches for a key within
        # the un-consolidated chain
        for op, k, _ in page.deltas:
            if op == "set" and k == key:
                raise ValueError(
                    f"duplicate insert patch for key {key!r} before consolidation "
                    "(mini-batch updates must coalesce writes per key)"
                )
        page.deltas.append(("set", key, value))
        self.stats.writes += 1
        self._maybe_consolidate(pidx)

    def append(self, key: bytes, payload: bytes):
        """Blind incremental update — no base read (the fast adjacency path)."""
        pidx = self._locate(key)
        self._pages[pidx].deltas.append(("append", key, payload))
        self.stats.writes += 1
        self._maybe_consolidate(pidx)

    def delete(self, key: bytes):
        pidx = self._locate(key)
        if self.get(key) is None:
            raise KeyError(f"delete patch for non-existent key {key!r} (§2.1 contract)")
        self._pages[pidx].deltas.append(("del", key, b""))
        self.stats.writes += 1
        self._maybe_consolidate(pidx)

    def upsert(self, key: bytes, value: bytes):
        """set-or-replace that satisfies the no-duplicate-patch contract by
        consolidating first when needed."""
        pidx = self._locate(key)
        page = self._pages[pidx]
        if any(op == "set" and k == key for op, k, _ in page.deltas):
            self._maybe_consolidate(pidx, force=True)
        self.put(key, value)

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        pidx = self._locate(key)
        self._touch(pidx)
        page = self._pages[pidx]
        value = page.base.get(key)
        pending: list[bytes] = []
        deleted = False
        for op, k, payload in page.deltas:  # chain walk, oldest→newest
            self.stats.delta_traversals += 1
            if k != key:
                continue
            if op == "set":
                value, pending, deleted = payload, [], False
            elif op == "append":
                pending.append(payload)
                deleted = False
            elif op == "del":
                value, pending, deleted = None, [], True
        if deleted:
            return None
        if pending:
            return self.merge_fn(value, pending)
        return value

    def prefix_seek(self, prefix: bytes) -> Iterator[tuple[bytes, bytes]]:
        """Range scan over all keys with the given prefix (§3.3 Prefix Seek)."""
        pidx = self._locate(prefix)
        while pidx < len(self._pages):
            self._maybe_consolidate(pidx, force=True)
            self._touch(pidx)
            page = self._pages[pidx]
            i = bisect.bisect_left(page.keys, prefix)
            advanced = False
            for k in page.keys[i:]:
                if not k.startswith(prefix):
                    return
                advanced = True
                yield k, page.base[k]
            pidx += 1
            if pidx < len(self._pages) and not self._fences[pidx].startswith(prefix):
                # next page's fence already beyond the prefix range
                if not advanced and self._fences[pidx] > prefix + b"\xff" * 4:
                    return

    def dump_items(self) -> list[tuple[bytes, bytes]]:
        """Every (key, value) pair in key order, after consolidating all
        delta chains — the logical content a snapshot must capture. Two
        trees with equal dumps answer every read identically."""
        pidx = 0
        while pidx < len(self._pages):  # consolidation may split pages
            self._maybe_consolidate(pidx, force=True)
            pidx += 1
        return [
            (k, page.base[k]) for page in self._pages for k in page.keys
        ]

    def chain_length(self, key: bytes) -> int:
        return len(self._pages[self._locate(key)].deltas)

    @property
    def num_pages(self) -> int:
        return len(self._pages)
