"""Adaptive serving control plane — closed-loop actuation of engine knobs.

The paper's serving economics hinge on knobs this repo used to pin at
build time: beam width trades RU for latency (§3.2), background ingest
catch-up yields to query latency (§3.4, Fig 12/13), and sustained
overload is answered by partition split / replica scale-out rather than
unbounded queueing (§ partitioning). This module closes the loop: a
``ControlPolicy`` is ticked once per ``pump()`` on SimClock time with
signals derived from ``engine.observability_summary()`` — the rollup
read-out, never raw counters — and returns one ``PolicyDecision`` the
engine actuates for the next micro-batch.

Design constraints the default ``AdaptivePolicy`` honors:

  * **windowed signals** — the observability histograms are cumulative
    (they never decay), so cumulative percentiles go sticky under
    changing load. The policy differences each stage's (count, total_ms)
    rollup between ticks (``obs.RollupWindow``): count/sum deltas window
    exactly where percentiles can't. A shrinking cumulative value means
    a metrics-epoch reset (``reset_metrics`` at a warmup boundary) and
    re-bases instead of producing a negative delta.
  * **compiled-signature confinement** — W decisions come from the fixed
    ``widths`` ladder and the engine clamps them into
    ``EngineConfig.policy_widths``; after warmup compiles every
    (bucket, L, W) signature once, steady-state recompiles stay at zero.
  * **hysteresis everywhere** — W moves one ladder step per tick inside
    a hold band (wide/narrow thresholds never overlap); topology actions
    require the overload predicate to hold for ``window_s`` of SimClock
    time and are rate-limited by ``cooldown_s``, so a single burst never
    flaps a split/scale-out.
  * **determinism** — every input is derived from the deterministic
    clock/rollups, so the same seed + arrival schedule reproduces the
    same ``decision_log`` bit for bit.

``StaticPolicy`` (the default, ``EngineConfig.policy="static"``) is
disabled: the engine short-circuits before signal collection and behaves
bit-identically to the pre-policy code.

The port's own copy of ``repro.serve.policy`` (no JAX there, but importing
it through ``repro`` loads JAX): the same rules and the same decisions. In
the port a "compiled signature" is a launch signature
(``vector_engine.serving_jit_cache_size``).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Protocol, runtime_checkable

from .obs import RollupWindow


@dataclasses.dataclass(frozen=True)
class PolicySignals:
    """One tick's view of the serving plane, derived from
    ``observability_summary()`` plus queue/topology state. ``stages``
    carries each stage's cumulative (count, total_ms) rollup; the policy
    windows them itself (see ``RollupWindow``)."""

    now_s: float
    queue_depth: int
    ingest_backlog_chunks: int
    ingest_backlog_ops: int
    slo_ms: Optional[float]
    stages: Mapping[str, tuple[int, float]]
    ru_total: float  # cumulative settled RU across tenants (query+page+hedge+ingest)
    lanes_busy_s: float  # cumulative busy time summed over lanes
    lane_occupancy: float  # cumulative busy/elapsed mean (display only)
    lanes: int
    partitions: int
    # paged vector tier. Cumulative page-cache touch counters
    # summed over partitions (epoch-independent: read from the stores, not
    # the registry) plus current residency; ``tiered`` is False when every
    # partition is fully resident — the cache knob stays dormant then.
    tier_hits: float = 0.0
    tier_misses: float = 0.0
    tier_resident_frac: float = 1.0
    tiered: bool = False


@dataclasses.dataclass(frozen=True)
class PolicyDecision:
    """What the engine actuates until the next tick. ``idle_ingest`` is
    the chunk allowance of an idle pump (min 1 — the drain loop must
    always make progress); ``scale`` fires at most one topology action."""

    beam_width: int
    ingest_interleave: int
    idle_ingest: int = 1
    # page-cache impulse: +1 grow / -1 shrink the paged tier's budget by
    # one step (engine clamps into [min_frac, 1.0]); 0 = hold. Only ever
    # nonzero when the signals say some partition runs a finite budget.
    cache_step: int = 0
    scale: Optional[str] = None  # "split" | "scale_out"
    reason: str = ""


@runtime_checkable
class ControlPolicy(Protocol):
    """The engine's control-plane contract. ``enabled=False`` policies
    are never ticked — the engine keeps its static fast path."""

    enabled: bool

    def initial(self) -> PolicyDecision: ...

    def tick(self, sig: PolicySignals) -> PolicyDecision: ...

    def reset_epoch(self) -> None: ...


class StaticPolicy:
    """The knobs as configured, forever — bit-identical to the
    pre-policy engine (the engine never even collects signals)."""

    enabled = False

    def __init__(self, cfg):
        self._decision = PolicyDecision(
            beam_width=cfg.beam_width,
            ingest_interleave=cfg.ingest_interleave,
            idle_ingest=1,
        )

    def initial(self) -> PolicyDecision:
        return self._decision

    def tick(self, sig: PolicySignals) -> PolicyDecision:
        return self._decision

    def reset_epoch(self) -> None:
        pass


class AdaptivePolicy:
    """Default closed-loop policy: W ladder + ingest yield + topology
    hysteresis, all on windowed rollup deltas.

    Knob (a) — beam width: a ladder over ``widths``. Deep backlog
    (``queue_depth >= wide_backlog``) or windowed queue wait above
    ``wide_wait_frac * slo`` steps one rung wider; a near-empty queue
    (``<= narrow_backlog``) with low wait steps one rung narrower; the
    band between holds. Idle traffic therefore settles at ``widths[0]``
    (W=1, the lowest-RU point) and bursts climb to ``widths[-1]``.

    Knob (b) — ingest yield: under latency pressure (windowed e2e above
    ``yield_latency_frac * slo``, or deep backlog) the per-batch
    interleave drops to 0 (queries stop paying for catch-up); with an
    empty queue it rises to ``catchup_chunks`` so the deferred debt
    drains during idle. Idle pumps always drain at least 1 chunk so the
    backlog is never starved forever.

    Knob (c) — topology: when overload (deep backlog + busy lanes +
    windowed wait at/over SLO) persists for ``window_s`` of SimClock
    time (or ``window_s`` of per-lane service booked while overloaded —
    the replica plane commits a backlog at one instant) AND
    ``cooldown_s`` has passed since the last action, fire ONE
    action: a replica-lane scale-out when the dispatch plane is
    ``replica`` and under ``max_lanes``, else a partition split (up to
    ``max_partitions``). The persistence window plus cooldown is the
    hysteresis: a single burst shorter than ``window_s`` fires nothing.
    """

    enabled = True

    def __init__(self, cfg, *, widths: Optional[tuple] = None,
                 wide_backlog: Optional[int] = None,
                 narrow_backlog: Optional[int] = None,
                 wide_wait_frac: float = 0.5,
                 narrow_wait_frac: float = 0.2,
                 yield_latency_frac: float = 0.5,
                 catchup_chunks: int = 4,
                 overload_backlog: Optional[int] = None,
                 overload_occupancy: float = 0.5,
                 window_s: float = 0.05,
                 cooldown_s: float = 0.5,
                 max_lanes: int = 8,
                 max_partitions: int = 8,
                 topology: bool = True,
                 cache_grow_miss: float = 0.5,
                 cache_shrink_miss: float = 0.05,
                 cache_cooldown_s: float = 0.25,
                 cache_min_frac: float = 0.1):
        self.widths = tuple(sorted(set(
            widths if widths is not None else cfg.policy_widths
        ))) or (cfg.beam_width,)
        self.wide_backlog = (wide_backlog if wide_backlog is not None
                             else cfg.max_batch)
        self.narrow_backlog = (narrow_backlog if narrow_backlog is not None
                               else max(1, cfg.max_batch // 4))
        assert self.narrow_backlog < self.wide_backlog, (
            "hold band is empty: narrow_backlog must sit below wide_backlog")
        self.wide_wait_frac = wide_wait_frac
        self.narrow_wait_frac = narrow_wait_frac
        self.yield_latency_frac = yield_latency_frac
        self.base_interleave = cfg.ingest_interleave
        self.catchup_chunks = max(1, int(catchup_chunks))
        self.overload_backlog = (overload_backlog if overload_backlog is not None
                                 else 4 * cfg.max_batch)
        self.overload_occupancy = overload_occupancy
        self.window_s = window_s
        self.cooldown_s = cooldown_s
        self.max_lanes = max_lanes
        self.max_partitions = max_partitions
        self.topology = topology
        # knob (d) — page-cache sizing. Grow when the windowed
        # miss RATE says rerank keeps faulting pages in; shrink only when
        # the cache is demonstrably oversized (near-zero misses) AND the
        # queue is idle. Its own cooldown so the cache never flaps with W.
        self.cache_grow_miss = cache_grow_miss
        self.cache_shrink_miss = cache_shrink_miss
        assert cache_shrink_miss < cache_grow_miss, (
            "cache hold band is empty: shrink threshold must sit below grow")
        self.cache_cooldown_s = cache_cooldown_s
        self.cache_min_frac = cache_min_frac
        self._last_cache_s = -float("inf")
        self.dispatch_mode = cfg.dispatch_mode
        self._slo_ms = cfg.trace_slo_ms if cfg.trace_slo_ms else 50.0
        # idle engines start at the cheapest point of the ladder; the
        # first backlogged tick climbs from there
        self._idx = 0
        # benchmark warmup hook: pin W to compile each (bucket, L, W)
        # signature in turn, then unpin before the measured epoch
        self.pinned_width: Optional[int] = None
        self._win = RollupWindow()
        self._last_tick_s: Optional[float] = None
        self._occ = 0.0  # windowed occupancy, held across dt==0 ticks
        self._over_since: Optional[float] = None
        self._over_booked = 0.0  # lane service booked while overloaded
        self._last_action_s = -float("inf")
        self._last: Optional[PolicyDecision] = None
        self.ticks = 0
        # (t_s, W, interleave, idle_ingest, scale) appended on every
        # decision CHANGE and every scale action — the determinism test
        # compares two runs' logs bit for bit
        self.decision_log: list[tuple] = []

    def initial(self) -> PolicyDecision:
        return PolicyDecision(beam_width=self.widths[self._idx],
                              ingest_interleave=self.base_interleave,
                              idle_ingest=1)

    def reset_epoch(self) -> None:
        """Metrics-epoch boundary (``engine.reset_metrics``): drop the
        rollup window and telemetry; actuation state (current W rung,
        cooldown clock) persists — the plant didn't reset."""
        self._win.reset()
        self._last_tick_s = None
        self._occ = 0.0
        self._over_since = None
        self._over_booked = 0.0
        self.ticks = 0
        self.decision_log = []

    # ------------------------------------------------------------------
    def tick(self, sig: PolicySignals) -> PolicyDecision:
        self.ticks += 1
        slo = sig.slo_ms if sig.slo_ms is not None else self._slo_ms

        # windowed rollup deltas (cumulative → per-window)
        qc, qt = sig.stages.get("queue", (0, 0.0))
        _lc, lt = sig.stages.get("lane", (0, 0.0))
        d_n = self._win.delta("queue_count", float(qc))
        d_wait = self._win.delta("queue_total_ms", qt)
        d_lane = self._win.delta("lane_total_ms", lt)
        d_busy = self._win.delta("lanes_busy_s", sig.lanes_busy_s)
        wait_ms = d_wait / d_n if d_n else 0.0
        e2e_ms = (d_wait + d_lane) / d_n if d_n else 0.0
        dt = (sig.now_s - self._last_tick_s
              if self._last_tick_s is not None else 0.0)
        self._last_tick_s = sig.now_s
        if dt > 0:
            # replica lanes book service into the future, so clamp
            self._occ = min(d_busy / (max(sig.lanes, 1) * dt), 1.0)
        elif d_busy > 0:
            # the replica plane dispatched a whole backlog at one
            # simulated instant: busy time grew while no time passed —
            # saturation by definition
            self._occ = 1.0
        occ = self._occ

        # (a) beam width: one ladder step per tick inside a hold band
        if self.pinned_width is not None:
            self._idx = min(range(len(self.widths)),
                            key=lambda i: abs(self.widths[i]
                                              - self.pinned_width))
        elif (sig.queue_depth >= self.wide_backlog
                or wait_ms >= self.wide_wait_frac * slo):
            self._idx = min(self._idx + 1, len(self.widths) - 1)
        elif (sig.queue_depth <= self.narrow_backlog
                and wait_ms <= self.narrow_wait_frac * slo):
            self._idx = max(self._idx - 1, 0)
        W = self.widths[self._idx]

        # (b) ingest yield
        pressure = (e2e_ms >= self.yield_latency_frac * slo
                    or sig.queue_depth >= self.wide_backlog)
        if pressure:
            inter, idle = 0, 1
        elif sig.queue_depth == 0 and sig.ingest_backlog_chunks:
            inter, idle = self.catchup_chunks, self.catchup_chunks
        else:
            inter, idle = self.base_interleave, 1

        # (c) topology: persistence window + cooldown hysteresis. The
        # window is satisfied by SimClock time elapsed while overloaded
        # OR by window_s of per-lane service booked while overloaded —
        # the replica plane dispatches a backlog at one instant, so its
        # persistence is measured in committed lane work, not wall time.
        scale = None
        overloaded = (self.topology
                      and sig.queue_depth >= self.overload_backlog
                      and occ >= self.overload_occupancy
                      and wait_ms >= slo)
        if overloaded:
            if self._over_since is None:
                self._over_since = sig.now_s
                self._over_booked = 0.0
            self._over_booked += d_busy
            sustained = (sig.now_s - self._over_since >= self.window_s
                         or self._over_booked
                         >= self.window_s * max(sig.lanes, 1))
            if (sustained
                    and sig.now_s - self._last_action_s >= self.cooldown_s):
                if (self.dispatch_mode == "replica"
                        and sig.lanes < self.max_lanes):
                    scale = "scale_out"
                elif sig.partitions < self.max_partitions:
                    scale = "split"
                if scale is not None:
                    self._last_action_s = sig.now_s
                    self._over_since = None
        else:
            self._over_since = None

        # (d) page-cache sizing: DORMANT unless some partition actually
        # runs a finite budget — an untiered engine's decisions (and its
        # idle-RU profile) must be unchanged by this knob existing
        cache = 0
        if sig.tiered:
            d_hit = self._win.delta("tier_hits", sig.tier_hits)
            d_miss = self._win.delta("tier_misses", sig.tier_misses)
            touches = d_hit + d_miss
            miss_rate = d_miss / touches if touches else 0.0
            if (touches
                    and sig.now_s - self._last_cache_s
                    >= self.cache_cooldown_s):
                if (miss_rate >= self.cache_grow_miss
                        and sig.tier_resident_frac < 1.0):
                    cache = 1
                elif (miss_rate <= self.cache_shrink_miss
                        and sig.queue_depth == 0
                        and sig.tier_resident_frac > self.cache_min_frac):
                    cache = -1
                if cache:
                    self._last_cache_s = sig.now_s

        dec = PolicyDecision(
            beam_width=W, ingest_interleave=inter, idle_ingest=idle,
            cache_step=cache, scale=scale,
            reason=(f"depth={sig.queue_depth} wait={wait_ms:.3f}ms "
                    f"e2e={e2e_ms:.3f}ms occ={occ:.3f} "
                    f"backlog={sig.ingest_backlog_chunks}"),
        )
        prev = self._last
        if (scale is not None or cache or prev is None
                or dec.beam_width != prev.beam_width
                or dec.ingest_interleave != prev.ingest_interleave
                or dec.idle_ingest != prev.idle_ingest):
            self.decision_log.append(
                (round(sig.now_s, 9), W, inter, idle, scale or "", cache))
        self._last = dec
        return dec


def make_policy(cfg) -> ControlPolicy:
    """EngineConfig.policy → a policy instance. Unknown names raise —
    a typo'd "adative" must not silently serve static."""
    if cfg.policy == "static":
        return StaticPolicy(cfg)
    if cfg.policy == "adaptive":
        return AdaptivePolicy(cfg)
    raise ValueError(
        f"unknown EngineConfig.policy {cfg.policy!r} (want static|adaptive)")
