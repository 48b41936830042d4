"""PropertyTermIndex — per-partition inverted property-term postings.

The server-side half of the declarative predicate API (§3.3 "Term Design",
§3.5 Fig 9): for every (path, value) a document carries, the partition
maintains a posting bitmap over its doc *slots* (the same slot space the
DiskANN filter masks and packed ``filter_bits`` use). Predicates compile to
a few bitmap AND/OR/NOT operations over these postings — **no document is
ever scanned on the query path**, unlike the legacy callable-filter path
which rebuilt an O(capacity) mask from the doc store per partition per
query.

Maintained incrementally:
  * ``assign(slot, items)`` on upsert (removes the slot's previous terms
    first, so a re-upsert with changed field values self-corrects);
  * ``remove(slot)`` on delete / re-home (split, merge, shard re-key);
  * every mutation bumps ``epoch`` — the invalidation signal for the
    per-(partition, predicate) compiled-bitmap cache below.

Postings write through to the Bw-Tree as PROP_TERM index terms
(``store.terms``) when a store provider is attached, mirroring how the
quantized and adjacency terms persist, and are RU-metered as property-term
writes.

Layout note: postings are packed uint32 words with bit ``slot`` at word
``slot >> 5``, bit ``slot & 31`` — identical to ``DiskANNIndex._pack_bits``
/ ``core.graph.bitmap_*``, so a compiled predicate bitmap can feed the
β-search ``filter_bits`` directly.

The port's own copy of ``repro.store.props`` (no JAX there, but importing it
through ``repro`` loads JAX); both packages read and write the same bytes.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np

from .terms import TermCodec, value_token

# compiled-bitmap cache bound (canonical predicates per partition),
# enforced on every insert: oldest entry evicted when full, and ingest
# mutations drop the whole (now stale-epoch) cache — the cache is an
# epoch-checked memo, never a correctness requirement
COMPILE_CACHE_CAP = 256


class PropertyTermIndex:
    """Inverted (path, value) → posting-bitmap index over one partition's
    doc slots, plus the predicate→bitmap compiler and its epoch-invalidated
    cache."""

    def __init__(self, capacity: int, store=None, shard=None):
        self.capacity = int(capacity)
        self.nwords = (self.capacity + 31) // 32
        self._store = store  # StoreProviderSet (write-through) or None
        self._shard = shard
        self._postings: dict[bytes, np.ndarray] = {}  # term key → words
        # per path: value token → (value, term key); feeds range compilation
        self._by_path: dict[str, dict[bytes, tuple[Any, bytes]]] = {}
        self._slot_terms: dict[int, tuple[bytes, ...]] = {}
        self._universe = np.zeros((self.nwords,), np.uint32)  # present docs
        self.epoch = 0
        self._cache: dict[bytes, tuple[int, np.ndarray]] = {}
        self.last_compile_reads = 0  # posting lookups by the last compile
        self._reads = 0

    # ------------------------------------------------------------------
    # maintenance (ingest path)
    # ------------------------------------------------------------------
    def _set_bit(self, words: np.ndarray, slot: int, on: bool):
        if on:
            words[slot >> 5] |= np.uint32(1) << np.uint32(slot & 31)
        else:
            words[slot >> 5] &= ~(np.uint32(1) << np.uint32(slot & 31))

    def assign(self, slot: int, items: tuple) -> None:
        """Point the slot's property terms at ``items`` ((path, value)
        pairs): removes whatever the slot carried before, so re-upserts
        with changed fields and slot reuse both self-correct."""
        slot = int(slot)
        self.remove(slot)
        keys = []
        for path, value in items:
            key = TermCodec.prop_key(path, value, self._shard)
            words = self._postings.get(key)
            if words is None:
                words = np.zeros((self.nwords,), np.uint32)
                self._postings[key] = words
                self._by_path.setdefault(str(path), {})[value_token(value)] = (
                    value, key,
                )
            self._set_bit(words, slot, True)
            keys.append(key)
            self._write_through(key, words)
        self._slot_terms[slot] = tuple(keys)
        self._set_bit(self._universe, slot, True)
        self._touch()

    def remove(self, slot: int) -> None:
        """Clear the slot from every posting it appears in (delete /
        re-home / pre-upsert cleanup)."""
        slot = int(slot)
        for key in self._slot_terms.pop(slot, ()):
            words = self._postings.get(key)
            if words is not None:
                self._set_bit(words, slot, False)
                self._write_through(key, words)
        if (self._universe[slot >> 5] >> np.uint32(slot & 31)) & np.uint32(1):
            self._set_bit(self._universe, slot, False)
            self._touch()

    def _write_through(self, key: bytes, words: np.ndarray) -> None:
        if self._store is not None:
            self._store.write_prop_posting(key, words)

    def _touch(self):
        self.epoch += 1
        self._cache.clear()  # every cached bitmap is now stale-epoch

    # ------------------------------------------------------------------
    # compiler interface (consumed by Predicate.compile_words)
    # ------------------------------------------------------------------
    def zeros(self) -> np.ndarray:
        return np.zeros((self.nwords,), np.uint32)

    def universe(self) -> np.ndarray:
        """Bitmap of slots that currently hold a document (the complement
        base for NOT: absent-field docs pass ``~F.eq(path, v)``)."""
        return self._universe.copy()

    def posting(self, path: str, value) -> Optional[np.ndarray]:
        self._reads += 1
        entry = self._by_path.get(str(path), {}).get(value_token(value))
        return None if entry is None else self._postings[entry[1]]

    def values_for(self, path: str) -> Iterator[tuple[Any, np.ndarray]]:
        """(value, posting words) for every distinct value seen at
        ``path`` — range predicates OR the in-bound subset together."""
        for tok, (value, key) in self._by_path.get(str(path), {}).items():
            self._reads += 1
            yield value, self._postings[key]

    # ------------------------------------------------------------------
    # compilation + per-(partition, predicate) cache
    # ------------------------------------------------------------------
    def compile(self, pred) -> np.ndarray:
        """Compile a canonical predicate to packed uint32 words over this
        partition's slots. Cached per canonical key; any ingest mutation
        (epoch bump) invalidates. ``last_compile_reads`` reports how many
        posting lookups the call performed (0 == cache hit) for RU
        metering."""
        key = pred.key()
        hit = self._cache.get(key)
        if hit is not None and hit[0] == self.epoch:
            self.last_compile_reads = 0
            return hit[1]
        self._reads = 0
        words = np.asarray(pred.compile_words(self), np.uint32)
        self.last_compile_reads = self._reads
        # bound the cache on the INSERT path too: a query-only workload
        # (no ingest, many distinct predicates) must not grow it forever
        while len(self._cache) >= COMPILE_CACHE_CAP:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = (self.epoch, words)
        return words

    def mask(self, words: np.ndarray) -> np.ndarray:
        """Unpack compiled words to the bool slot mask the filtered search
        planner consumes (vectorized — not a document scan)."""
        return words_to_mask(words, self.capacity)

    @property
    def num_terms(self) -> int:
        return len(self._postings)


def words_to_mask(words: np.ndarray, capacity: int) -> np.ndarray:
    """Packed uint32 words (bit i of word w == slot 32w+i) → bool mask."""
    bits = np.unpackbits(
        np.ascontiguousarray(words, dtype="<u4").view(np.uint8),
        bitorder="little",
    )
    return bits[:capacity].astype(bool)


def mask_to_words(mask: np.ndarray) -> np.ndarray:
    """Inverse of ``words_to_mask`` (shared layout with
    ``DiskANNIndex._pack_bits``)."""
    words = np.zeros(((len(mask) + 31) // 32,), np.uint32)
    idx = np.nonzero(mask)[0]
    np.bitwise_or.at(
        words, idx >> 5, np.uint32(1) << (idx & 31).astype(np.uint32)
    )
    return words
