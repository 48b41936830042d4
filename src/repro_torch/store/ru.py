"""Request Units — Cosmos DB's normalized cost currency (§2.2), calibrated.

RUs abstract CPU, IOPS and memory; the Resource Governance component
guarantees provisioned RU/s per partition and throttles beyond it. The
paper publishes enough operating points to calibrate a linear RU model over
the index-term access counters our store/search paths expose:

    Table 1: ~70 RU per query   (10M × 768D, default settings)
    Table 2: ~65 RU per insert  (768D, R=32, L_build=100)
    §4.4:    ~3500 quantized + ~50 full-precision reads per query;
             each insert touches ≈ R·L_build quantized vectors and ≈L_build
             adjacency lists; 10 µs / 25 µs per quantized / adjacency read;
             ~3 ms CPU in the DiskANN library per insert
    Fig 7/8: query RU grows < 2× for 100× more vectors (logarithmic hops)

With the defaults below the modelled costs land on those points (validated
in benchmarks/bench_cost.py), and RU-vs-L / RU-vs-N curves reproduce the
shapes of Figs 6-8 because the underlying counters do.

The port's own copy of ``repro.store.ru`` (no JAX there, but importing it
through ``repro`` loads JAX); both packages read and write the same bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RUConfig:
    ru_per_quant_read: float = 0.0125  # ≈80 quantized-term reads / RU
    ru_per_adj_read: float = 0.10
    ru_per_full_read: float = 0.50  # document-store vector load
    ru_per_quant_write: float = 0.50
    ru_per_adj_write: float = 0.30  # incl. blind appends
    # inverted property-term postings (the predicate/WHERE index): writes
    # are bitmap upserts riding the doc write; reads are the per-leaf-term
    # posting lookups a predicate compilation performs on a bitmap-cache
    # miss (a cache hit costs zero — the hit rate is directly visible in
    # query RU)
    ru_per_prop_write: float = 0.05
    ru_per_prop_read: float = 0.005
    ru_per_doc_write: float = 5.0  # the transactional document write
    ru_per_cpu_ms: float = 0.50
    ru_per_page_read: float = 0.005  # Bw-Tree page touch (cache-miss extra)
    ru_per_cache_miss: float = 0.05
    # upfront vector charge (§3.4 "Upfront charging"): per KB of vector
    ru_upfront_per_kb: float = 1.0
    # minimum charge per continuation/page request (§2.2): Cosmos bills
    # every request at least the request-processing floor, so a paginated
    # query is never free even when a page is answered from buffered state
    ru_per_page_request: float = 1.0
    # tiered vector storage: full-precision vectors live in a
    # paged tier; a rerank-stage page miss is a cold fetch billed in RU
    # AND modelled latency, a hit costs neither (the resident set is the
    # cost lever the "Cloud-Native Vector Search" curve sweeps)
    ru_per_vector_page: float = 0.25

    # latency model (paper §4.4 micro-measurements)
    us_per_quant_read: float = 10.0
    us_per_adj_read: float = 25.0
    us_per_full_read: float = 100.0  # random document-store access
    us_per_chain_record: float = 0.8  # extra per delta-chain record walked
    us_per_vector_page: float = 110.0  # cold paged-tier vector fetch


@dataclasses.dataclass
class OpCounters:
    quant_reads: int = 0
    adj_reads: int = 0
    full_reads: int = 0
    quant_writes: int = 0
    adj_writes: int = 0
    prop_writes: int = 0  # property-term posting upserts
    prop_reads: int = 0  # posting lookups (predicate compile, cache miss)
    doc_writes: int = 0
    cpu_ms: float = 0.0
    page_reads: int = 0
    cache_misses: int = 0
    chain_records: int = 0
    vector_kb: float = 0.0
    vector_page_misses: int = 0  # paged-tier cold fetches (rerank stage)

    def __iadd__(self, o: "OpCounters"):
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(o, f.name))
        return self


class RUMeter:
    """Accumulates per-operation counters and converts to RUs / latency."""

    def __init__(self, cfg: RUConfig = RUConfig()):
        self.cfg = cfg
        self.total = OpCounters()

    def charge(self, c: OpCounters) -> float:
        self.total += c
        return self.ru(c)

    def ru(self, c: OpCounters) -> float:
        g = self.cfg
        return (
            g.ru_per_quant_read * c.quant_reads
            + g.ru_per_adj_read * c.adj_reads
            + g.ru_per_full_read * c.full_reads
            + g.ru_per_quant_write * c.quant_writes
            + g.ru_per_adj_write * c.adj_writes
            + g.ru_per_prop_write * c.prop_writes
            + g.ru_per_prop_read * c.prop_reads
            + g.ru_per_doc_write * c.doc_writes
            + g.ru_per_cpu_ms * c.cpu_ms
            + g.ru_per_page_read * c.page_reads
            + g.ru_per_cache_miss * c.cache_misses
            + g.ru_upfront_per_kb * c.vector_kb
            + g.ru_per_vector_page * c.vector_page_misses
        )

    def latency_ms(self, c: OpCounters) -> float:
        """Modelled single-thread latency (the paper's ≈25 ms/insert napkin
        math in §4.4 falls out of these constants)."""
        g = self.cfg
        us = (
            g.us_per_quant_read * c.quant_reads
            + g.us_per_adj_read * c.adj_reads
            + g.us_per_full_read * c.full_reads
            + g.us_per_chain_record * c.chain_records
            + g.us_per_vector_page * c.vector_page_misses
        )
        return us / 1000.0 + c.cpu_ms


def counters_for_ru(stats, lanes: int = 1) -> OpCounters:
    """Work-based counters from search ``QueryStats``: RU charges every
    quantized comparison and every adjacency row actually fetched
    (``expansions``) — beam width buys latency, not free reads."""
    adj = getattr(stats, "expansions", 0.0) or stats.hops
    return OpCounters(
        quant_reads=int(stats.cmps * lanes),
        adj_reads=int(adj * lanes),
        full_reads=int(stats.full_reads * lanes),
        # tier misses in QueryStats are per-query means; RU bills the
        # whole batch's page fetches (work-based), so scale back up
        vector_page_misses=int(
            round(getattr(stats, "tier_misses", 0.0) * lanes)),
    )


def counters_for_latency(stats) -> OpCounters:
    """Critical-path counters from search ``QueryStats``: one beam-width
    round issues its ≤ W·R_slack quantized reads concurrently (the paper's
    beamWidth bang-for-the-buck), so the sequential path sees ``cmps / W̄``
    of them — W̄ = expansions/rounds, measured from the stats so
    partially-filled late rounds are not over-credited. Adjacency fetches
    coalesce into one round trip per round. The single source of truth for
    the round-structured latency model (fanout, serve, benchmarks)."""
    w_bar = max(
        getattr(stats, "expansions", 0.0) / max(stats.hops, 1e-9), 1.0
    )
    return OpCounters(
        quant_reads=int(round(stats.cmps / w_bar)),
        adj_reads=int(stats.hops),
        full_reads=int(stats.full_reads),
        # per-query critical path: this query's own page misses (the
        # batch amortizes fetches, the mean IS the per-query cost)
        vector_page_misses=int(
            round(getattr(stats, "tier_misses", 0.0))),
    )


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of a non-blocking admission check (the 429 path): when not
    admitted, `retry_after_s` is the refill time until the estimate fits."""

    admitted: bool
    retry_after_s: float = 0.0


class ResourceGovernor:
    """Provisioned-throughput governance (§2.2): grants RU budget per
    second of simulated time; callers exceeding it are throttled (made to
    wait), which is how background graph maintenance is paced so it can
    catch up with transactions (§3.4).

    Two client styles coexist:
      * ``request`` — blocking: the caller absorbs the throttle delay
        (background maintenance pacing);
      * ``try_admit`` / ``settle`` — non-blocking: the serving layer asks
        first, rejects over-budget tenants with a retry-after instead of
        degrading everyone, then settles the actual cost post-execution
        (which may push `available` negative — the debt refills over time).
    """

    def __init__(self, provisioned_ru_s: float):
        self.provisioned = provisioned_ru_s
        self.clock_s = 0.0
        self.available = provisioned_ru_s
        self.throttle_events = 0
        self.consumed = 0.0
        # settlement telemetry (cost-attribution reconciliation): every
        # settle/refund event counts, and refunded RU is tracked so
        # `consumed` can be audited against the serving registry
        self.settlements = 0
        self.refunded = 0.0

    def request(self, ru: float) -> float:
        """Consume `ru`; returns seconds of throttle delay incurred."""
        delay = 0.0
        while ru > self.available:
            deficit = ru - self.available
            wait = deficit / self.provisioned
            delay += wait
            self.clock_s += wait
            self.available += wait * self.provisioned
            self.throttle_events += 1
        self.available -= ru
        self.consumed += ru
        return delay

    def advance(self, seconds: float):
        self.clock_s += seconds
        self.available = min(
            self.available + seconds * self.provisioned, self.provisioned
        )

    # ------------------------------------------------------------------
    # non-blocking API (serving-layer admission control)
    # ------------------------------------------------------------------
    def refill_to(self, now_s: float):
        """Advance to absolute simulated time `now_s`, refilling budget
        (burst capacity caps at one second of provisioned throughput)."""
        if now_s > self.clock_s:
            self.advance(now_s - self.clock_s)

    def try_admit(self, ru_estimate: float, now_s: Optional[float] = None) -> AdmissionDecision:
        """Would a request costing ~`ru_estimate` fit the current budget?
        Does NOT consume — pair with ``settle`` after execution."""
        if now_s is not None:
            self.refill_to(now_s)
        if self.available >= ru_estimate:
            return AdmissionDecision(admitted=True)
        self.throttle_events += 1
        deficit = ru_estimate - self.available
        return AdmissionDecision(
            admitted=False, retry_after_s=deficit / self.provisioned
        )

    def settle(self, ru: float, now_s: Optional[float] = None):
        """Record the actual cost of an admitted request. `available` may go
        negative (the estimate was low); the debt pays down on refill."""
        if now_s is not None:
            self.refill_to(now_s)
        self.available -= ru
        self.consumed += ru
        self.settlements += 1

    def refund(self, ru: float, now_s: Optional[float] = None):
        """Hand back an unused admission reservation (failed dispatches,
        throttled page chains): the budget returns and the reservation no
        longer counts as consumption."""
        self.refunded += ru
        self.settle(-ru, now_s=now_s)
