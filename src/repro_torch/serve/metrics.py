"""Deterministic serving metrics: simulated clock + latency/throughput stats.

Everything the serving engine reports is computed against a *simulated*
clock, so tests and benchmarks are bit-reproducible offline: arrivals are
stamped by the workload generator, service time comes from the calibrated
§4.4 access-time model, and queue wait falls out of the two. The same
registry also tracks real recompile telemetry (`core.search.jit_cache_size`)
because compile stalls are the one latency source the model cannot see.

The port's own copy of ``repro.serve.metrics`` (numpy only, but importing
it through ``repro`` loads JAX). In the port the recompile telemetry counts
launch signatures (``core.search.jit_cache_size``): the port has no JIT
cache, so a signature first seen is what a compile was to the reference.
Host-clock time is not kept here: ``repro_torch.spans`` records it, as spans
of the engine, the fan-out, the search and the insert path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


class SimClock:
    """Monotonic simulated time in seconds. Advanced explicitly by the
    engine (service time) and by workload generators (arrival gaps)."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, seconds: float) -> float:
        assert seconds >= 0.0, "time only moves forward"
        self._t += seconds
        return self._t


class Histogram:
    """Bounded streaming histogram: O(1) memory regardless of samples.

    Replaces the old unbounded exact sample list. Values land in
    geometric bins (ratio ``GROWTH`` per bin starting at ``LO``), so the
    percentile readout — the geometric midpoint of the target bin,
    clamped to the exact observed [min, max] — carries ≤ √GROWTH−1
    (≈3.4%) relative error while ``count``/``sum``/``mean``/``max`` stay
    exact. Percentiles are monotone in p by construction
    (cumulative scan over ordered bins). Parity against the retained
    ``ExactHistogram`` is tested on seeded workloads.
    """

    LO = 1e-3  # lowest resolved value; below lands in the underflow bin
    GROWTH = 1.07
    NBINS = 420  # covers LO … LO·G^NBINS ≈ 2e9; beyond is the overflow bin

    __slots__ = ("_counts", "_count", "_sum", "_min", "_max")

    def __init__(self):
        # [underflow, NBINS geometric bins, overflow]
        self._counts = np.zeros(self.NBINS + 2, dtype=np.int64)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float):
        v = float(v)
        self._count += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if v <= self.LO:
            idx = 0
        else:
            idx = min(1 + int(math.log(v / self.LO) / _LOG_GROWTH),
                      self.NBINS + 1)
        self._counts[idx] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, p: float) -> float:
        if not self._count:
            return 0.0
        target = min(max(1, int(math.ceil(p / 100.0 * self._count))),
                     self._count)
        cum = np.cumsum(self._counts)
        idx = int(np.searchsorted(cum, target))
        if idx == 0:
            val = self._min  # underflow bin: everything ≤ LO
        elif idx == self.NBINS + 1:
            val = self._max  # overflow bin
        else:
            val = self.LO * self.GROWTH ** (idx - 0.5)  # geometric midpoint
        return float(min(max(val, self._min), self._max))


_LOG_GROWTH = math.log(Histogram.GROWTH)


class ExactHistogram:
    """Exact sample store — the reference implementation the streaming
    ``Histogram`` is parity-tested against. Unbounded memory; use only
    where the sample count is small and exactness matters."""

    def __init__(self):
        self._samples: list[float] = []

    def observe(self, v: float):
        self._samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self._samples)

    @property
    def sum(self) -> float:
        return float(np.sum(self._samples)) if self._samples else 0.0

    def mean(self) -> float:
        return float(np.mean(self._samples)) if self._samples else 0.0

    def percentile(self, p: float) -> float:
        return float(np.percentile(self._samples, p)) if self._samples else 0.0


@dataclasses.dataclass
class EngineMetrics:
    """Counters + distributions for one VectorServeEngine lifetime."""

    queries_ok: int = 0
    queries_throttled: int = 0
    queries_deadline: int = 0  # 408s: deadline expired while queued
    queries_degraded: int = 0  # 200s served from a partial partition set
    pages_served: int = 0  # merged continuation pages (each RU-metered)
    batches: int = 0
    lanes_total: int = 0  # dispatched lanes incl. padding
    lanes_padded: int = 0
    ingest_ops: int = 0
    ingest_batches: int = 0
    # RU attribution is disjoint: ru_query_total is the *work* RU of
    # query/page dispatches (hedge duplicates excluded), hedge_ru_total
    # is the hedge surcharge, ru_ingest_total the write path. The three
    # sum to every RU settled against tenant governors (conservation is
    # asserted in tests/test_observability.py).
    ru_query_total: float = 0.0
    ru_ingest_total: float = 0.0
    # per-query sequential search rounds (beam-width telemetry): hop
    # batching shows up here as mean_hops dropping ~W×
    hops_weighted: float = 0.0
    hops_lanes: int = 0
    # dispatch-plane telemetry: hedged duplicates bill RU; lane faults
    # and recoveries mirror the executor's health machine
    hedges: int = 0
    hedges_won: int = 0
    hedge_ru_total: float = 0.0
    # control-plane telemetry (serve.policy): ticks evaluated, beam-width
    # moves, topology actions, and the ingest-yield debt ledger (chunks
    # the policy deferred under latency pressure vs chunks repaid by
    # idle catch-up beyond the static 1-chunk trickle)
    policy_ticks: int = 0
    policy_w_changes: int = 0
    policy_splits: int = 0
    policy_lanes_added: int = 0
    policy_cache_resizes: int = 0  # paged-tier budget moves
    ingest_deferred_chunks: int = 0
    ingest_catchup_chunks: int = 0
    started_s: float = 0.0
    latency_ms: Histogram = dataclasses.field(default_factory=Histogram)
    wait_ms: Histogram = dataclasses.field(default_factory=Histogram)
    occupancy: Histogram = dataclasses.field(default_factory=Histogram)
    # trajectory of the batched-search jit cache size, one point per batch:
    # flat in steady state == zero recompiles
    jit_cache_trajectory: list = dataclasses.field(default_factory=list)

    def note_batch(self, true_lanes: int, bucket: int, service_ms: float,
                   ru: float, cache_size: int):
        self.batches += 1
        self.lanes_total += bucket
        self.lanes_padded += bucket - true_lanes
        self.ru_query_total += ru
        self.occupancy.observe(true_lanes / max(bucket, 1))
        self.jit_cache_trajectory.append(int(cache_size))

    def note_hedge(self, won: bool, hedge_ru: float):
        self.hedges += 1
        self.hedges_won += int(won)
        self.hedge_ru_total += hedge_ru

    def note_hops(self, mean_hops: float, true_lanes: int):
        self.hops_weighted += mean_hops * true_lanes
        self.hops_lanes += true_lanes

    def recompiles_since(self, batch_index: int = 0) -> int:
        """Jit cache growth after batch `batch_index` (0 = engine start)."""
        traj = self.jit_cache_trajectory
        if not traj:
            return 0
        base = traj[batch_index] if batch_index < len(traj) else traj[-1]
        return traj[-1] - base

    def snapshot(self, now_s: float) -> dict:
        elapsed = max(now_s - self.started_s, 1e-9)
        return dict(
            queries_ok=self.queries_ok,
            queries_throttled=self.queries_throttled,
            queries_deadline=self.queries_deadline,
            queries_degraded=self.queries_degraded,
            pages_served=self.pages_served,
            batches=self.batches,
            qps=self.queries_ok / elapsed,
            ru_per_s=(self.ru_query_total + self.hedge_ru_total) / elapsed,
            ru_query_total=self.ru_query_total,
            ru_ingest_total=self.ru_ingest_total,
            ingest_ops=self.ingest_ops,
            p50_ms=self.latency_ms.percentile(50),
            p95_ms=self.latency_ms.percentile(95),
            p99_ms=self.latency_ms.percentile(99),
            mean_wait_ms=self.wait_ms.mean(),
            p95_wait_ms=self.wait_ms.percentile(95),
            hedges=self.hedges,
            hedges_won=self.hedges_won,
            hedge_ru_total=self.hedge_ru_total,
            mean_hops=self.hops_weighted / max(self.hops_lanes, 1),
            mean_occupancy=self.occupancy.mean(),
            pad_fraction=self.lanes_padded / max(self.lanes_total, 1),
            jit_cache_size=(self.jit_cache_trajectory[-1]
                            if self.jit_cache_trajectory else 0),
            elapsed_s=elapsed,
        )


def poisson_arrivals(rng: np.random.RandomState, n: int, rate_per_s: float,
                     t0: float = 0.0) -> np.ndarray:
    """Deterministic (seeded) Poisson-process arrival times for workloads."""
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    return t0 + np.cumsum(gaps)
