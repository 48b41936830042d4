"""The dispatch plane: replica-concurrent lanes under simulated time.

The engine used to execute every micro-batch inline — one simulated
executor, so offered load beyond one lane's service rate piled up as
queue wait no matter how many replicas the topology declared. This
module models the server's dispatch plane instead: ``LaneExecutor``
owns N replica lanes, each a busy-interval timeline under the shared
``SimClock``. Dispatching a batch books the earliest-free healthy lane
(FIFO within a lane, earliest-finish across lanes), so independent
micro-batches genuinely overlap in simulated time and queue wait shows
up in the latency percentiles instead of disappearing.

Straggler hedging lives here now (lifted from ``fanout_search``): when
a lane's jittered service time trips ``hedge_at_ms``, a second healthy
lane runs a duplicate and the earliest finisher wins — the duplicate's
RU is billed, never free (§4.4 tail-tolerance, paid for in RU).

Lane health: an injected fault marks the lane down and the scheduler
retries the dispatch on another lane; a down lane is re-probed after a
cooldown and revived (callbacks let the engine mirror this into
``ReplicaSet`` kill / rebuild / read routing).

Modes:
  * ``serial``  — one lane, clock advanced inline: byte-identical to
    the pre-dispatch-plane engine.
  * ``replica`` — N lanes, future-scheduled: the clock does NOT advance
    on dispatch; lane timelines run ahead of it and ``quiesce`` brings
    the clock to the horizon on drain.
  * ``spmd``    — one lane (the whole mesh is one executor); the
    parallelism lives inside the jitted program, not the lane plane.

The port's own copy of ``repro.serve.executor`` (numpy only, but importing
it through ``repro`` loads JAX): the same lanes, draws and outcomes. In the
port's ``spmd`` mode the one lane is one stacked search on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np

from .metrics import SimClock

DISPATCH_MODES = ("serial", "replica", "spmd")


@dataclasses.dataclass
class LaneState:
    """One replica lane's timeline: busy horizon + health."""

    lane_id: int
    busy_until_s: float = 0.0
    down: bool = False
    down_since_s: float = 0.0
    dispatches: int = 0
    busy_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class DispatchOutcome:
    """Where and when a dispatch ran on the lane plane."""

    payload: Any
    lane: int
    start_s: float
    end_s: float
    ru: float
    hedged: bool = False
    hedge_ru: float = 0.0
    hedge_lane: int = -1
    hedge_won: bool = False
    retried_lanes: tuple = ()
    # trace-plane detail: the hedge duplicate's own lane interval, and
    # whether the primary's service time was straggler-inflated
    hedge_start_s: float = 0.0
    hedge_end_s: float = 0.0
    straggled: bool = False


class LaneExecutor:
    """N replica lanes scheduling work on a shared simulated clock.

    ``run`` thunks passed to :meth:`dispatch` return
    ``(payload, service_ms, ru)``; the executor decides *where* and
    *when* that service time is spent, never *what* runs.
    """

    def __init__(self, clock: SimClock, lanes: int = 1, mode: str = "serial",
                 hedge_at_ms: Optional[float] = None,
                 straggler_p: float = 0.0, straggler_factor: float = 4.0,
                 reprobe_after_s: float = 5.0, seed: int = 0,
                 on_lane_down: Optional[Callable[[int, float], None]] = None,
                 on_lane_up: Optional[Callable[[int, float], None]] = None,
                 on_lane_read: Optional[Callable[[int], None]] = None):
        if mode not in DISPATCH_MODES:
            raise ValueError(f"dispatch mode {mode!r} not in {DISPATCH_MODES}")
        self.mode = mode
        self.clock = clock
        n = max(1, int(lanes)) if mode == "replica" else 1
        self.lanes = [LaneState(i) for i in range(n)]
        self.hedge_at_ms = hedge_at_ms
        self.straggler_p = float(straggler_p)
        self.straggler_factor = float(straggler_factor)
        self.reprobe_after_s = float(reprobe_after_s)
        self.on_lane_down = on_lane_down
        self.on_lane_up = on_lane_up
        self.on_lane_read = on_lane_read
        self._rng = np.random.RandomState(seed)
        self._armed_faults: dict[int, int] = {}
        self.hedges = 0
        self.hedges_won = 0
        self.hedge_ru_total = 0.0
        self.faults = 0
        self.recoveries = 0
        self.retries = 0
        self._born_s = clock.now()

    # ------------------------------------------------------------------
    # health
    # ------------------------------------------------------------------
    def inject_fault(self, lane_id: int, count: int = 1):
        """Arm the lane to fail its next `count` selections (test hook /
        fault model): the failure fires on selection, BEFORE the work
        runs, so a retried dispatch executes exactly once."""
        self._armed_faults[lane_id] = self._armed_faults.get(lane_id, 0) + count

    def healthy_lanes(self) -> list:
        return [ln for ln in self.lanes if not ln.down]

    def add_lane(self) -> int:
        """Scale-out actuation (serve.policy): a new healthy lane joins
        the plane and starts taking dispatches immediately — its empty
        timeline makes it the earliest-free pick, so it absorbs the
        backlog first. Returns the new lane id. Only meaningful under
        ``replica`` dispatch (serial/spmd planes are one lane by
        construction)."""
        ln = LaneState(len(self.lanes))
        self.lanes.append(ln)
        return ln.lane_id

    def _probe(self, now_s: float):
        """Revive lanes whose down-cooldown has elapsed (the re-probe
        path: a dead lane is not dead forever)."""
        for ln in self.lanes:
            if ln.down and now_s - ln.down_since_s >= self.reprobe_after_s:
                ln.down = False
                self.recoveries += 1
                if self.on_lane_up is not None:
                    self.on_lane_up(ln.lane_id, now_s)

    def _mark_down(self, ln: LaneState, now_s: float):
        ln.down = True
        ln.down_since_s = now_s
        self.faults += 1
        if self.on_lane_down is not None:
            self.on_lane_down(ln.lane_id, now_s)

    def _pick(self, now_s: float, exclude: Sequence[int] = ()) -> Optional[LaneState]:
        """Earliest-free healthy lane; ties break to the lowest id."""
        cands = [ln for ln in self.healthy_lanes() if ln.lane_id not in exclude]
        if not cands:
            return None
        return min(cands, key=lambda ln: (max(ln.busy_until_s, now_s), ln.lane_id))

    def _select(self, now_s: float) -> LaneState:
        """Pick a lane, burning armed faults (each fires once, marks the
        lane down, and the scheduler retries elsewhere)."""
        retried: list[int] = []
        while True:
            ln = self._pick(now_s, exclude=retried)
            if ln is None:
                raise RuntimeError(
                    "dispatch failed: no healthy lanes"
                    + (f" (faulted: {retried})" if retried else "")
                )
            if self._armed_faults.get(ln.lane_id, 0) > 0:
                self._armed_faults[ln.lane_id] -= 1
                self._mark_down(ln, now_s)
                self.retries += 1
                retried.append(ln.lane_id)
                continue
            ln._retried = tuple(retried)  # stashed for the outcome
            return ln

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------
    def _jitter_ms(self, service_ms: float) -> float:
        if self.straggler_p > 0.0 and self._rng.random_sample() < self.straggler_p:
            return service_ms * self.straggler_factor
        return service_ms

    def _book(self, ln: LaneState, start_s: float, dur_s: float) -> float:
        end_s = start_s + dur_s
        ln.busy_until_s = end_s
        ln.busy_s += dur_s
        ln.dispatches += 1
        if self.on_lane_read is not None:
            self.on_lane_read(ln.lane_id)
        return end_s

    def dispatch(self, run: Callable[[], tuple], occupy: bool = True) -> DispatchOutcome:
        """Run a unit of work on the lane plane.

        ``run() -> (payload, service_ms, ru)``. With ``occupy=False`` no
        lane is booked (host-path work whose internals already schedule
        their own lane rounds); otherwise the earliest-free healthy lane
        hosts the work, hedging a duplicate when the (jittered) service
        time trips ``hedge_at_ms``. Serial mode advances the clock to
        the finish, preserving the inline-execution timeline exactly.
        """
        now = self.clock.now()
        self._probe(now)
        if not occupy:
            payload, service_ms, ru = run()
            end = now + service_ms / 1000.0
            if self.mode == "serial":
                self.clock.advance(service_ms / 1000.0)
            return DispatchOutcome(payload, -1, now, end, ru)

        ln = self._select(now)
        retried = ln._retried
        payload, service_ms, ru = run()
        start = max(now, ln.busy_until_s)
        eff_ms = self._jitter_ms(service_ms)
        end = self._book(ln, start, eff_ms / 1000.0)

        hedged = hedge_won = False
        hedge_ru = 0.0
        hedge_lane = -1
        hedge_start = hedge_end = 0.0
        if (self.mode == "replica" and self.hedge_at_ms is not None
                and eff_ms > self.hedge_at_ms):
            ln2 = self._pick(now, exclude=(ln.lane_id,))
            if ln2 is not None:
                hedged = True
                self.hedges += 1
                hedge_ru = ru  # the duplicate execution bills in full
                self.hedge_ru_total += ru
                hedge_lane = ln2.lane_id
                start2 = max(start + self.hedge_at_ms / 1000.0,
                             ln2.busy_until_s, now)
                end2 = self._book(ln2, start2, self._jitter_ms(service_ms) / 1000.0)
                hedge_start, hedge_end = start2, end2
                if end2 < end:  # earliest finisher answers the client
                    hedge_won = True
                    self.hedges_won += 1
                    end = end2

        if self.mode == "serial":
            self.clock.advance(end - now)
        return DispatchOutcome(payload, ln.lane_id, start, end, ru,
                               hedged, hedge_ru, hedge_lane, hedge_won,
                               retried, hedge_start, hedge_end,
                               eff_ms > service_ms)

    def schedule_round(self, durations_ms: Sequence[float]) -> float:
        """Book one multi-cursor round — each duration on the earliest-
        free healthy lane — and return the round's makespan in ms.

        This is how a page refill's per-partition ``next_page`` fetches
        become ONE dispatch: with ≥ P lanes the round costs the max
        fetch, with 1 lane it degenerates to the host-loop sum.
        """
        now = self.clock.now()
        self._probe(now)
        end_max = now
        for ms in durations_ms:
            ln = self._select(now)
            start = max(now, ln.busy_until_s)
            end_max = max(end_max, self._book(ln, start, ms / 1000.0))
        return (end_max - now) * 1000.0

    def quiesce(self):
        """Advance the clock to the lane horizon (drain semantics)."""
        horizon = max((ln.busy_until_s for ln in self.lanes), default=0.0)
        now = self.clock.now()
        if horizon > now:
            self.clock.advance(horizon - now)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        now = self.clock.now()
        horizon = max([ln.busy_until_s for ln in self.lanes] + [now])
        elapsed = max(horizon - self._born_s, 1e-9)
        return {
            "mode": self.mode,
            "lanes": len(self.lanes),
            "lane_busy_s": [round(ln.busy_s, 6) for ln in self.lanes],
            "lane_dispatches": [ln.dispatches for ln in self.lanes],
            "lane_down": [ln.down for ln in self.lanes],
            "lane_occupancy": [round(ln.busy_s / elapsed, 4) for ln in self.lanes],
            "hedges": self.hedges,
            "hedges_won": self.hedges_won,
            "hedge_ru_total": round(self.hedge_ru_total, 3),
            "faults": self.faults,
            "recoveries": self.recoveries,
            "retries": self.retries,
        }
