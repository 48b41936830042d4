"""Paged full-precision vector tier.

The DiskANN storage position that the paper's cost story rests on:
quantized codes + graph adjacency + postings stay memory-resident while
full-precision vectors live in a cheaper paged tier, fetched only for
the final rerank stage. This module is the residency ledger for that
tier — a fixed-size-page cache over the partition's vector array with
clock (second-chance) eviction, pin-during-rerank, and deterministic
behaviour under SimClock (no wall clock, no unseeded randomness).

Residency here is *modelled*, not physical: the vectors stay in the
provider's numpy array (so the rerank math is byte-identical at
every residency level), and the cache tracks which pages WOULD be
resident, charging RU + modelled fetch latency for each miss via
``store/ru.py``'s ``vector_page_misses`` counter. ``budget_pages=None``
(the default) keeps every page resident — zero misses, zero cost — so
an untiered partition is bit-identical to the pre-tier engine.

Determinism contract: the resident set is a pure function of
``(seed, budget history, touch sequence)``. The warm set on a cold
finite-budget cache is a seeded permutation; eviction is a clock sweep
from a persistent hand. Two runs issuing identical touch sequences see
identical hits/misses/evictions.

The port's own copy of ``repro.store.pages`` (no JAX there, but importing it
through ``repro`` loads JAX); both packages read and write the same bytes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class PagedVectorStore:
    """Residency ledger for fixed-size pages of full-precision vectors.

    Parameters
    ----------
    capacity : int
        Number of vector slots in the backing array.
    dim : int
        Vector dimensionality (used only for byte accounting).
    page_size : int
        Vectors per page. Slot ``s`` lives on page ``s // page_size``.
    budget_pages : Optional[int]
        Resident-set budget in pages. ``None`` → unbounded (fully
        resident, every touch a free hit). ``0 <= budget <= n_pages``
        caps residency; misses beyond it cost RU + latency.
    seed : int
        Seeds the warm resident set on a cold finite-budget cache.
    """

    def __init__(self, capacity: int, dim: int, *, page_size: int = 64,
                 budget_pages: Optional[int] = None, seed: int = 0):
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.page_size = int(page_size)
        self.seed = int(seed)
        self.n_pages = max(1, -(-self.capacity // self.page_size))
        # clock state
        self.resident = np.zeros(self.n_pages, dtype=bool)
        self.ref = np.zeros(self.n_pages, dtype=bool)
        self.pins = np.zeros(self.n_pages, dtype=np.int32)
        self.hand = 0
        # cumulative counters (page granularity)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.admits = 0
        self.budget_pages: Optional[int] = None
        self.set_budget(budget_pages)

    # -- residency -------------------------------------------------------

    def set_budget(self, budget_pages: Optional[int]) -> None:
        """(Re)set the resident budget deterministically.

        ``None`` → everything resident. Shrinking a finite budget clock-
        evicts down (pinned pages are never victims — transient overflow
        drains on ``unpin``). Growing leaves the resident set as-is; new
        room fills on demand. A COLD cache (nothing resident yet) given a
        finite budget gets a seeded warm set, so a freshly-tiered
        partition starts at its budget rather than all-miss.
        """
        if budget_pages is None:
            self.budget_pages = None
            self.resident[:] = True
            return
        budget = int(np.clip(budget_pages, 0, self.n_pages))
        if self.budget_pages is None:
            # transitioning from unbounded: keep a seeded warm subset
            self.resident[:] = False
            if budget > 0:
                warm = np.random.RandomState(self.seed).permutation(
                    self.n_pages)[:budget]
                self.resident[warm] = True
            self.ref[:] = False
        self.budget_pages = budget
        self._evict_to_budget()

    def resize_budget(self, budget_pages: Optional[int]) -> None:
        """Policy-plane alias for :meth:`set_budget`."""
        self.set_budget(budget_pages)

    @property
    def n_resident(self) -> int:
        return int(self.resident.sum())

    # -- the access path -------------------------------------------------

    def touch(self, slots, admit: bool = True, pin: bool = False):
        """Record a rerank-stage access to ``slots`` (any int array-like).

        Returns ``(hits, misses, pages)`` for this touch: page-level
        counts plus the unique page ids accessed (pass ``pages`` back to
        :meth:`unpin` when ``pin=True``). Negative slots (padding
        sentinels) are ignored.

        * ``admit=True`` (graph rerank): missed pages are fetched AND
          admitted, clock-evicting unpinned pages to make room.
        * ``admit=False`` (brute/exact scans): misses are counted and
          billed but never admitted — scan resistance, a full sweep must
          not flush the hot set.
        * ``pin=True``: every touched page is pinned for the duration of
          the rerank; pinned pages are never eviction victims, even if
          that transiently overflows the budget (drained on unpin).
        """
        slots = np.asarray(slots).reshape(-1)
        slots = slots[slots >= 0]
        if slots.size == 0:
            return 0, 0, np.empty(0, dtype=np.int64)
        pages = np.unique(slots // self.page_size).astype(np.int64)
        pages = pages[pages < self.n_pages]
        if self.budget_pages is None:
            # unbounded: everything resident, touches are free hits
            self.hits += int(pages.size)
            self.ref[pages] = True
            if pin:
                self.pins[pages] += 1
            return int(pages.size), 0, pages
        res = self.resident[pages]
        hits = int(res.sum())
        misses = int(pages.size - hits)
        self.hits += hits
        self.misses += misses
        self.ref[pages[res]] = True
        if pin:
            # pin the working set FIRST so room-making can't evict a page
            # this same rerank is about to touch
            self.pins[pages] += 1
        if admit and misses and self.budget_pages > 0:
            for pg in pages[~res]:
                self._make_room()
                self.resident[pg] = True
                self.ref[pg] = True
                self.admits += 1
        return hits, misses, pages

    def unpin(self, pages) -> None:
        """Release a rerank's pins and drain any pin-induced overflow."""
        pages = np.asarray(pages, dtype=np.int64).reshape(-1)
        if pages.size == 0:
            return
        self.pins[pages] -= 1
        if np.any(self.pins < 0):
            raise AssertionError("unpin without matching pin")
        self._evict_to_budget()

    # -- clock eviction --------------------------------------------------

    def _make_room(self) -> None:
        if self.budget_pages is None:
            return
        while self.n_resident >= max(self.budget_pages, 1):
            if not self._evict_one():
                break  # everything pinned: transient overflow allowed

    def _evict_to_budget(self) -> None:
        if self.budget_pages is None:
            return
        while self.n_resident > self.budget_pages:
            if not self._evict_one():
                break

    def _evict_one(self) -> bool:
        """One clock sweep: skip pinned, clear ref on first pass, evict
        the first unreferenced unpinned resident page. Returns False if
        no victim exists (all resident pages pinned)."""
        for _ in range(2 * self.n_pages):
            pg = self.hand
            self.hand = (self.hand + 1) % self.n_pages
            if not self.resident[pg] or self.pins[pg] > 0:
                continue
            if self.ref[pg]:
                self.ref[pg] = False
                continue
            self.resident[pg] = False
            self.evictions += 1
            return True
        return False

    # -- introspection ---------------------------------------------------

    def page_slots(self, pg: int) -> slice:
        """Slot range backing page ``pg`` — residency-independent, used
        by recovery parity checks to bit-compare the paged tier page by
        page regardless of either side's cache state."""
        lo = pg * self.page_size
        return slice(lo, min(lo + self.page_size, self.capacity))

    def state(self) -> dict:
        bytes_per_page = self.page_size * self.dim * 4
        n_res = self.n_resident
        return dict(
            page_size=self.page_size,
            n_pages=self.n_pages,
            budget_pages=self.budget_pages,
            resident_pages=n_res,
            resident_frac=n_res / self.n_pages,
            resident_bytes=n_res * bytes_per_page,
            total_bytes=self.n_pages * bytes_per_page,
            pinned_pages=int((self.pins > 0).sum()),
            hits=self.hits, misses=self.misses,
            evictions=self.evictions, admits=self.admits,
        )
