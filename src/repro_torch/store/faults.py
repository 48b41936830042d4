"""Deterministic fault injection + recovery invariants (chaos plumbing).

The paper's availability story (§2.2: the vector index inherits the
database's HA/durability) is only credible if kill-and-recover is
exercised, not assumed. This module provides the three pieces the tests
and ``benchmarks/bench_chaos.py`` drive:

  * ``FaultPlan`` — a seeded crash schedule. Write paths call
    ``providers.barrier("upsert:post_index")`` etc. at named points;
    an armed (or probabilistically tripped) barrier raises
    ``CrashError``, modelling a process kill at exactly that point.
    Determinism comes from the seeded RNG (and the SimClock timestamps
    recorded for each trip), so every chaos run is replayable.
  * WAL damage helpers — ``torn_tail`` (the crash interrupted the disk
    write of the final record) and ``corrupt_record`` (interior bit
    rot), built on the codec's frame boundaries so they tear real
    record edges rather than random garbage.
  * ``recovery_invariants`` — the parity contract after every
    kill-and-recover: doc store (full vectors + tombstones), graph
    adjacency, quantized codes, and every durable index term (adjacency
    / quantized / property postings) must match the uncrashed twin
    bit-for-bit.

A crash at any barrier must leave durable state equal to the committed
transaction prefix: the in-memory arrays die with the process, and the
WAL's record-per-transaction framing (see ``store/codec.py``) guarantees
the interrupted operation is invisible after replay.

The port's own copy of ``repro.store.faults`` (no JAX there, but importing it
through ``repro`` loads JAX); both packages read and write the same bytes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import codec


class CrashError(RuntimeError):
    """Injected process kill: in-memory state is gone; what survives is
    the last snapshot plus the committed WAL records."""


class FaultPlan:
    """Seeded, deterministic crash schedule over named barriers.

    Two triggering modes compose: ``arm(name, count)`` trips the next
    ``count`` hits of an exact barrier, and ``p_crash`` trips any barrier
    with the given probability from the plan's own seeded RNG.
    """

    def __init__(self, seed: int = 0, p_crash: float = 0.0, clock=None):
        self.rng = np.random.RandomState(seed)
        self.p_crash = float(p_crash)
        self.clock = clock  # optional SimClock for trip timestamps
        self.enabled = True
        self._armed: dict[str, int] = {}
        self.seen: list[str] = []  # every barrier crossed (armed or not)
        self.tripped: list[tuple[str, Optional[float]]] = []

    def arm(self, barrier: str, count: int = 1) -> "FaultPlan":
        self._armed[barrier] = self._armed.get(barrier, 0) + count
        return self

    def attach(self, providers) -> "FaultPlan":
        providers.faults = self
        return self

    def barrier(self, name: str):
        if not self.enabled:
            return
        self.seen.append(name)
        trip = False
        if self._armed.get(name, 0) > 0:
            self._armed[name] -= 1
            trip = True
        elif self.p_crash > 0.0 and self.rng.random_sample() < self.p_crash:
            trip = True
        if trip:
            now = self.clock.now() if self.clock is not None else None
            self.tripped.append((name, now))
            raise CrashError(f"injected crash at barrier {name!r}")


# ---------------------------------------------------------------------------
# WAL damage (what a real crash / bad disk does to the log bytes)
# ---------------------------------------------------------------------------


def torn_tail(wal: bytes, rng: np.random.RandomState,
              nbytes: Optional[int] = None) -> bytes:
    """Chop bytes off the end of the WAL, at most into the final record —
    the on-disk picture of a crash mid-write. Recovery must truncate the
    damaged frame and replay the intact prefix."""
    frames = codec.wal_frames(wal)
    if not frames:
        return wal
    last_off, last_len = frames[-1]
    if nbytes is None:
        nbytes = int(rng.randint(1, last_len + 1))
    nbytes = min(nbytes, last_len)
    return wal[: len(wal) - nbytes]


def corrupt_record(wal: bytes, rng: np.random.RandomState,
                   index: Optional[int] = None) -> bytes:
    """Flip one payload byte of record ``index`` (random interior record
    by default). Interior damage is bit rot: recovery must *reject* it,
    not silently truncate committed data."""
    frames = codec.wal_frames(wal)
    if not frames:
        return wal
    if index is None:
        index = int(rng.randint(0, max(len(frames) - 1, 1)))
    off, flen = frames[index]
    # payload spans [off+4, off+4+plen); flip one byte inside it
    lo, hi = off + 4, off + flen - 4
    pos = int(rng.randint(lo, hi)) if hi > lo else lo
    damaged = bytearray(wal)
    damaged[pos] ^= 0xFF
    return bytes(damaged)


# ---------------------------------------------------------------------------
# recovery invariants
# ---------------------------------------------------------------------------

_ARRAY_CHECKS = (
    ("doc_store", "vectors"),
    ("tombstones", "live"),
    ("graph", "neighbors"),
    ("quantized", "codes"),
    ("quant_versions", "versions"),
)


def recovery_invariants(recovered, twin) -> dict[str, bool]:
    """Assert bit-for-bit parity between a recovered provider set and its
    uncrashed twin: dense caches AND the durable term store (which covers
    adjacency, quantized, and property-posting terms). Raises
    ``AssertionError`` naming every violated invariant."""
    checks: dict[str, bool] = {}
    for label, attr in _ARRAY_CHECKS:
        a, b = getattr(recovered, attr), getattr(twin, attr)
        checks[label] = (
            a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
        )
    checks["terms"] = recovered.tree.dump_items() == twin.tree.dump_items()
    # the paged full-precision tier, page by page: a WAL that
    # loses a ``set_full`` replay would serve stale vectors at rerank.
    # Page CONTENT must match regardless of either side's cache residency
    # (budgets may differ between a recovered replica and its twin), so
    # compare through the residency-independent page→slot mapping.
    pages = getattr(recovered, "pages", None)
    if pages is not None and hasattr(twin, "vectors"):
        bad_pages = [
            pg for pg in range(pages.n_pages)
            if not np.array_equal(recovered.vectors[pages.page_slots(pg)],
                                  twin.vectors[pages.page_slots(pg)])
        ]
        checks["paged_tier"] = not bad_pages
        if bad_pages:
            checks["paged_tier_bad_pages"] = False  # surfaced in the assert
    bad = [name for name, ok in checks.items() if not ok]
    assert not bad, f"recovery parity violated: {bad}"
    return checks
