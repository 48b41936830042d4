"""VectorServeEngine — batched, admission-controlled vector-query serving.

The paper's headline numbers are *service-level*: <20 ms query latency over
10M vectors under sustained multi-tenant traffic, with RU-based resource
governance deciding who gets served (§2.2, §4). This engine models that
serving layer in front of the collection/partition stack:

  * **dynamic micro-batching** — independent client requests accumulate up
    to ``max_batch`` / ``max_wait_s`` and dispatch as ONE fixed-shape
    batched search (`partition.fanout.batched_fanout_search`), turning many
    small host calls into dense device work;
  * **shape bucketing** — batches pad to a small set of static
    (batch, L, k) signatures (`core.search.BATCH_BUCKETS`) so steady-state
    traffic triggers zero recompiles; the jit cache size is exported as a
    metric precisely because compile stalls are the tail-latency failure
    mode this design removes;
  * **dispatch plane** — micro-batches route through a ``LaneExecutor``
    (`serve.executor`): N replica lanes running concurrently under the
    simulated clock (``dispatch_mode="replica"``), straggler hedging with
    RU billed for duplicates, lane-health → replica routing; or ONE
    stacked search driving every partition's lanes together on the card
    (``dispatch_mode="spmd"``, `partition.fanout.SpmdFanout`);
  * **RU-based admission control** — each tenant owns a
    ``store.ru.ResourceGovernor``; over-budget tenants get a 429-style
    `Throttled` rejection with a retry-after instead of degrading everyone
    (the paper's resource-governance story). Estimates come from an EMA of
    observed per-query RU and are settled against actuals post-execution;
  * **interleaved ingest** — upserts/deletes flow through a background
    mini-batch queue that alternates with query batches, so recall stays
    stable and query latency bounded *during* updates (§3.4, Fig 12/13);
  * **deterministic simulated clock + metrics** — service time comes from
    the calibrated §4.4 access-time model, arrivals from the workload
    generator, so p50/p95/p99, QPS, RU/s, batch occupancy and recompile
    counts are all reproducible offline (`serve.metrics`).

`VectorCollectionService` is a thin façade over this engine; later scale
work (caching, replication pressure, multi-backend) plugs in here.

The port of ``repro.serve.vector_engine``, line for line but in three places:

  * the exact plan scans each partition's device mirror
    (``providers.materialize``), never a fresh host-to-device copy of its
    vectors, and its page-tier mask stays a host array;
  * ``dispatch_mode="spmd"`` runs the port's ``SpmdFanout``: every
    partition in one stacked search on the collection's device (``device``
    takes the place of the reference's ``spmd_mesh``);
  * the port compiles nothing per shape, so where the reference counts
    compiled signatures (``serving_jit_cache_size``, the batch's
    ``jit_cache_trajectory``, "a compile stall" in the comments below), the
    port counts the distinct launch signatures its serving entry points
    have run. The count moves where the reference's does: flat in steady
    state, up by one for each new (bucket, L, W, ...) signature.

Every time the engine reports is modelled on its ``SimClock`` (the §4.4
access-time model), never measured on the card.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Optional, Sequence

import numpy as np

from ..core import flat as fmod
from ..core import search as smod
from ..partition.fanout import (AllPartitionsFailed, SpmdFanout,
                                batched_fanout_search,
                                batched_filtered_fanout_search,
                                compile_partition_filter, merge_topk,
                                spmd_jit_cache_size)
from ..store.faults import CrashError
from ..device import DeviceLike
from ..store.ru import OpCounters, ResourceGovernor
from .executor import LaneExecutor
from .metrics import EngineMetrics, SimClock
from .obs import MetricsRegistry
from .policy import ControlPolicy, PolicySignals, make_policy
from .predicate import Predicate
from .trace import ANOMALY_DEGRADED, Tracer


def serving_jit_cache_size() -> int:
    """Total launch-signature count across the serving hot path (graph
    search + re-rank + brute force + the stacked fan-out), the counterpart
    of the reference's compiled-signature count. Flat trajectory == no new
    shape in steady state."""
    return smod.jit_cache_size() + fmod.jit_cache_size() + spmd_jit_cache_size()


class Throttled(Exception):
    """429-style rejection: the tenant is over its provisioned RU budget."""

    def __init__(self, tenant: Any, retry_after_s: float):
        super().__init__(
            f"tenant {tenant!r} over RU budget; retry after {retry_after_s:.3f}s"
        )
        self.tenant = tenant
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 16  # micro-batch dispatch threshold
    max_wait_s: float = 0.002  # oldest request never waits longer than this
    batch_buckets: tuple[int, ...] = smod.BATCH_BUCKETS
    beam_width: int = 4  # W-way frontier expansion per search round (§3.2
    #   beamWidth): ~W× fewer sequential rounds on the lockstep hot path
    search_list_multiplier: float = 5.0  # L = multiplier * k when unset
    dispatch_overhead_ms: float = 0.1  # host-side per-batch overhead
    tenant_ru_s: float = 10_000.0  # default per-tenant provisioned budget
    admission_control: bool = True
    admission_estimate_ru: float = 20.0  # prior until an EMA exists
    ru_ema_alpha: float = 0.25
    ingest_chunk: int = 64  # docs per interleaved ingest mini-batch
    ingest_interleave: int = 1  # ingest chunks drained per query batch
    ingest_ms_per_ru: float = 0.4  # §4.4: ~65 RU, ~25 ms per insert
    # ---- dispatch plane (serve.executor) ----
    dispatch_mode: str = "serial"  # serial | replica | spmd
    lanes: int = 4  # replica lanes when dispatch_mode == "replica"
    hedge_at_ms: Optional[float] = None  # straggler hedge threshold (replica)
    straggler_p: float = 0.0  # per-dispatch straggler probability
    straggler_factor: float = 4.0  # service-time inflation when straggling
    lane_reprobe_after_s: float = 5.0  # down-lane re-probe cooldown
    dispatch_seed: int = 0  # lane-plane RNG seed (straggler draws)
    # ---- observability (serve.trace / serve.obs) ----
    trace: bool = True  # per-request lifecycle traces; off = zero overhead
    flight_recorder: int = 256  # trace records retained (ring + anomaly ring)
    trace_slo_ms: Optional[float] = 50.0  # SLO-violating traces always captured
    # ---- fault tolerance ----
    # engine-wide deadline bound: every request's effective deadline is
    # min(request deadline, this). None → unbounded unless the request
    # sets one. Deadlines are *queue-abandonment* budgets: a request whose
    # deadline expires while still queued is answered 408 with its RU
    # reservation refunded, before any lane work is spent on it.
    default_deadline_ms: Optional[float] = None
    # ---- adaptive control plane (serve.policy) ----
    # "static" keeps every knob at its configured value (bit-identical to
    # the pre-policy engine); "adaptive" closes the loop: beam width,
    # ingest yield and topology actuate per ``pump()`` tick from the
    # observability rollups (see serve/policy.py for the decision rules)
    policy: str = "static"
    # the W decision ladder. Warmup must compile every (bucket, L, W)
    # signature in this set once — the engine clamps every policy W into
    # it, so steady-state adaptive traffic never recompiles
    policy_widths: tuple[int, ...] = (1, 2, 4)


@dataclasses.dataclass
class ServeRequest:
    rid: int
    vector: np.ndarray  # (D,)
    k: int = 10
    L: Optional[int] = None  # search list size; None → multiplier * k
    tenant: Any = "default"
    exact: bool = False
    shard_key: Any = None
    # declarative WHERE clause (serve.predicate). Predicates are hashable
    # by canonical key, so same-predicate requests coalesce into one
    # micro-batch sharing one compiled bitmap per partition — filtered
    # queries ride the batched path instead of falling off to host code.
    predicate: Optional[Predicate] = None
    # offered arrival time; < 0 → stamped with the clock at submit(). A
    # workload generator passes the true arrival so queueing delay under
    # overload is charged to latency even when the engine is running behind.
    arrival_s: float = -1.0
    reserved_ru: float = 0.0  # admission reservation, reconciled at dispatch
    admit_s: float = -1.0  # when the admission decision was made (trace plane)
    # queue-abandonment budget (ms from arrival). None → engine default.
    # A request still queued past its deadline is abandoned with a 408
    # and its reservation refunded; a request already dispatched runs to
    # completion (its answer may arrive "late" but is still a 200).
    deadline_ms: Optional[float] = None
    deadline_s: float = np.inf  # absolute expiry, stamped at submit()


@dataclasses.dataclass
class ServeResponse:
    rid: int
    status: int  # 200 served, 408 deadline-abandoned, 429 throttled
    ids: Optional[np.ndarray] = None  # (k,)
    dists: Optional[np.ndarray] = None
    ru: float = 0.0
    plan: str = ""
    latency_ms: float = 0.0  # queue wait + modelled service time
    wait_ms: float = 0.0
    retry_after_s: float = 0.0
    batch_size: int = 0  # true lanes in the dispatching micro-batch
    # False → degraded: one or more partitions were down/faulted and the
    # results merge only the survivors (the plan carries a
    # ``+degraded[pids]`` marker naming the missing partitions)
    complete: bool = True


class VectorServeEngine:
    """Batched, admission-controlled serving in front of a Collection."""

    def __init__(
        self,
        collection,  # partition.Collection
        cfg: EngineConfig = EngineConfig(),
        clock: Optional[SimClock] = None,
        resolver: Optional[Callable[[Any], Sequence]] = None,
        replica_sets: Optional[Sequence] = None,  # partition.ReplicaSet list
        device: DeviceLike = None,  # dispatch_mode="spmd"; None → the collection's
        policy: Optional[ControlPolicy] = None,  # None → from cfg.policy
    ):
        self.collection = collection
        self.cfg = cfg
        self.clock = clock or SimClock()
        # shard_key → partition list (the service wires tenant collections in)
        self._resolve = resolver or (lambda _sk: collection.partitions)
        # lane health mirrors into replica health: a down lane kills its
        # replica in every set (reads stop routing there), a re-probed lane
        # rebuilds it through the real snapshot+WAL recovery path
        self.replica_sets = list(replica_sets) if replica_sets else []
        # partition → its replica set, for per-partition health checks at
        # dispatch time (degradation: a partition whose replica set is
        # entirely down is skipped, not fatal)
        self._rs_by_partition = {id(rs.partition): rs
                                 for rs in self.replica_sets}
        on_down = on_up = on_read = None
        if self.replica_sets:
            def on_down(lane: int, now_s: float):
                for rs in self.replica_sets:
                    rs.kill(lane % len(rs.replicas), now_s=now_s)

            def on_up(lane: int, now_s: float):
                for rs in self.replica_sets:
                    rs.probe_dead(now_s)

            def on_read(lane: int):
                for rs in self.replica_sets:
                    rs.note_read(lane % len(rs.replicas))
        self.executor = LaneExecutor(
            self.clock, lanes=cfg.lanes, mode=cfg.dispatch_mode,
            hedge_at_ms=cfg.hedge_at_ms, straggler_p=cfg.straggler_p,
            straggler_factor=cfg.straggler_factor,
            reprobe_after_s=cfg.lane_reprobe_after_s, seed=cfg.dispatch_seed,
            on_lane_down=on_down, on_lane_up=on_up, on_lane_read=on_read,
        )
        self._spmd_device = device if device is not None else collection.device
        self._spmd_fanout: Optional[SpmdFanout] = None
        self.queue: list[ServeRequest] = []
        self._ingest_q: deque[tuple[str, Callable[[], float], int, Any]] = deque()
        self.responses: dict[int, ServeResponse] = {}
        self.tenants: dict[Any, ResourceGovernor] = {}
        self._ru_ema: dict[Any, float] = {}
        self._next_rid = 0
        self.metrics = EngineMetrics(started_s=self.clock.now())
        # observability plane: always-on labeled registry (cheap), plus the
        # lifecycle tracer (zero-cost when cfg.trace is off — begin()
        # returns None and every emission site guards on it)
        self.obs = MetricsRegistry()
        self.tracer = Tracer(self.clock, enabled=cfg.trace,
                             capacity=cfg.flight_recorder,
                             slo_ms=cfg.trace_slo_ms)
        # control plane (serve.policy): disabled policies short-circuit
        # before signal collection — the static path never pays for them
        self.policy = policy if policy is not None else make_policy(cfg)
        self._allowed_widths = tuple(sorted(set(cfg.policy_widths))) \
            or (cfg.beam_width,)
        self._decision = self.policy.initial()
        self._last_scale: Optional[dict] = None

    def reset_metrics(self):
        """Metrics epoch boundary (benchmark warmup): fresh aggregates,
        fresh labeled registry, fresh flight recorder. Tenant governors
        keep their budgets — only the telemetry resets. The policy's
        rollup window re-bases with the registry (its deltas would
        otherwise go negative against the fresh epoch)."""
        self.metrics = EngineMetrics(started_s=self.clock.now())
        self.obs = MetricsRegistry()
        self.tracer.reset()
        self.policy.reset_epoch()

    # ------------------------------------------------------------------
    # admission control
    # ------------------------------------------------------------------
    def tenant_governor(self, tenant: Any) -> ResourceGovernor:
        if tenant not in self.tenants:
            self.tenants[tenant] = ResourceGovernor(self.cfg.tenant_ru_s)
            self.tenants[tenant].clock_s = self.clock.now()
        return self.tenants[tenant]

    def set_tenant_budget(self, tenant: Any, provisioned_ru_s: float):
        gov = ResourceGovernor(provisioned_ru_s)
        gov.clock_s = self.clock.now()
        self.tenants[tenant] = gov

    def _admit(self, tenant: Any) -> tuple[Optional[ServeResponse], float]:
        """(None, reserved_ru) when admitted — the estimate is consumed
        upfront so a burst of submits can't all pass against the same
        untouched balance; (429-response, 0) when throttled."""
        if not self.cfg.admission_control:
            return None, 0.0
        gov = self.tenant_governor(tenant)
        est = self._ru_ema.get(tenant, self.cfg.admission_estimate_ru)
        decision = gov.try_admit(est, now_s=self.clock.now())
        if decision.admitted:
            gov.settle(est, now_s=self.clock.now())  # reserve; reconciled later
            return None, est
        self.metrics.queries_throttled += 1
        return ServeResponse(
            rid=-1, status=429, retry_after_s=decision.retry_after_s
        ), 0.0

    def _settle(self, tenant: Any, actual_ru: float, reserved_ru: float):
        """Reconcile the upfront reservation against the actual cost and
        fold the actual into the tenant's admission estimate (EMA)."""
        self.tenant_governor(tenant).settle(
            actual_ru - reserved_ru, now_s=self.clock.now()
        )
        a = self.cfg.ru_ema_alpha
        prev = self._ru_ema.get(tenant, actual_ru)
        self._ru_ema[tenant] = (1 - a) * prev + a * actual_ru

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, req: ServeRequest) -> Optional[ServeResponse]:
        """Enqueue a query. Returns a 429 response immediately when the
        tenant is over budget, else None (the answer arrives at dispatch)."""
        rejected, reserved = self._admit(req.tenant)
        if rejected is not None:
            resp = dataclasses.replace(rejected, rid=req.rid)
            self.responses[req.rid] = resp
            self._note_throttle("query", req.rid, req.tenant,
                                resp.retry_after_s)
            return resp
        req.reserved_ru = reserved
        req.admit_s = self.clock.now()
        if req.arrival_s < 0:
            req.arrival_s = self.clock.now()
        dl = req.deadline_ms
        if self.cfg.default_deadline_ms is not None:
            dl = (self.cfg.default_deadline_ms if dl is None
                  else min(dl, self.cfg.default_deadline_ms))
        if dl is not None:
            req.deadline_s = req.arrival_s + dl / 1000.0
        self.queue.append(req)
        return None

    def submit_query(self, vector: np.ndarray, k: int = 10,
                     L: Optional[int] = None, tenant: Any = "default",
                     exact: bool = False, shard_key: Any = None,
                     arrival_s: float = -1.0,
                     predicate: Optional[Predicate] = None,
                     deadline_ms: Optional[float] = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.submit(ServeRequest(rid=rid, vector=np.asarray(vector, np.float32),
                                 k=k, L=L, tenant=tenant, exact=exact,
                                 shard_key=shard_key, arrival_s=arrival_s,
                                 predicate=predicate, deadline_ms=deadline_ms))
        return rid

    def submit_ingest(self, kind: str, apply_fn: Callable[[], float],
                      n_ops: int, tenant: Any = "default"):
        """Enqueue one pre-chunked ingest thunk (returns its RU charge).
        The service layer slices upserts/deletes into ``ingest_chunk``-sized
        thunks; the engine alternates them with query batches. ``tenant``
        attributes the write RU in the observability registry."""
        self._ingest_q.append((kind, apply_fn, n_ops, tenant))

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------
    def _group_key(self, r: ServeRequest):
        L = r.L or max(r.k, int(round(self.cfg.search_list_multiplier * r.k)))
        pk = r.predicate.key() if r.predicate is not None else None
        return (r.shard_key, r.k, L, r.exact, pk)

    def _due_groups(self, force: bool) -> list[tuple]:
        groups: dict[tuple, list[ServeRequest]] = {}
        for r in self.queue:
            groups.setdefault(self._group_key(r), []).append(r)
        now = self.clock.now()
        due = []
        for key, reqs in groups.items():
            oldest = min(r.arrival_s for r in reqs)
            if force or len(reqs) >= self.cfg.max_batch \
                    or now - oldest >= self.cfg.max_wait_s:
                due.append((oldest, key, reqs))
        due.sort(key=lambda t: t[0])  # oldest group first
        return [(key, reqs) for _, key, reqs in due]

    def pump(self, force: bool = False) -> int:
        """Dispatch due micro-batches (and interleave ingest). Returns the
        number of queries served this pump. With an enabled control
        policy every loop iteration opens with a policy tick — the
        beam-width / ingest-yield decision is PER MICRO-BATCH, re-read
        from the rollups as the backlog drains, and a tick may fire a
        topology action (split / lane scale-out)."""
        served = 0
        progressed = True
        while progressed:
            progressed = False
            self._policy_tick()
            for key, reqs in self._due_groups(force):
                batch = reqs[: self.cfg.max_batch]
                self._dispatch(key, batch)
                served += len(batch)
                self._interleave_ingest()
                progressed = True
                break  # re-derive groups: the clock moved
        if not served:
            self._idle_ingest()
        return served

    def drain(self) -> dict[int, ServeResponse]:
        """Run to quiescence: every queued query answered, ingest applied."""
        while self.queue or self._ingest_q:
            if not self.pump(force=False) and self.queue:
                self.pump(force=True)
        # replica lanes are future-scheduled: bring the clock to the lane
        # horizon so drained == everything actually finished
        self.executor.quiesce()
        return self.responses

    def query_sync(self, req: ServeRequest) -> ServeResponse:
        """Submit + force a flush — the façade path for blocking callers.
        Anything already queued for the same signature rides along (so even
        'synchronous' traffic coalesces under concurrency). The response is
        collected (popped), so sustained façade traffic doesn't accumulate
        state in ``responses``."""
        rejected = self.submit(req)
        if rejected is not None:
            self.responses.pop(req.rid, None)
            return rejected
        while req.rid not in self.responses:
            self.pump(force=True)
        return self.responses.pop(req.rid)

    def pop_response(self, rid: int) -> Optional[ServeResponse]:
        """Collect (and free) a response. Async submitters should prefer
        this over reading ``responses`` directly — uncollected responses
        are retained for the engine's lifetime."""
        return self.responses.pop(rid, None)

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def _dispatch(self, key: tuple, batch: list[ServeRequest]):
        in_batch = set(id(r) for r in batch)
        self.queue = [r for r in self.queue if id(r) not in in_batch]
        # deadline sweep: a request whose budget expired while it queued is
        # abandoned HERE — before any lane work is spent on it — with its
        # admission reservation refunded (the 408 path)
        now = self.clock.now()
        expired = [r for r in batch if r.deadline_s <= now]
        if expired:
            batch = [r for r in batch if r.deadline_s > now]
            for r in expired:
                self._expire(r, now)
            if not batch:
                return
        # a batch beyond the largest bucket is split into top-bucket chunks
        # instead of minting a new padded shape (each extra shape is a
        # compile stall — the tail-latency failure mode bucketing removes)
        top = max(self.cfg.batch_buckets)
        chunks = [batch[lo : lo + top] for lo in range(0, len(batch), top)]
        for i, chunk in enumerate(chunks):
            try:
                self._dispatch_chunk(key, chunk)
            except Exception:
                # the failing chunk refunds itself (below); the undispatched
                # remainder was already pulled off the queue, so hand its
                # admission reservations back too before propagating
                for r in (q for c in chunks[i + 1 :] for q in c):
                    self.tenant_governor(r.tenant).refund(r.reserved_ru)
                raise

    def _partition_health(self, p) -> bool:
        """False when the partition's entire replica set is down (degrade:
        skip it); partitions without a replica set are always healthy."""
        rs = self._rs_by_partition.get(id(p))
        return rs is None or bool(rs.healthy())

    def _expire(self, r: ServeRequest, now_s: float):
        """Abandon one deadline-expired queued request: refund the
        admission reservation (no work was done on the tenant's dime),
        answer 408, and emit a trace whose root spans — admission point,
        queue [arrival → expiry], deadline point — tile the waited
        interval exactly like a served request's do."""
        self.tenant_governor(r.tenant).refund(r.reserved_ru)
        waited_ms = (now_s - r.arrival_s) * 1000.0
        assert r.rid not in self.responses
        self.responses[r.rid] = ServeResponse(
            rid=r.rid, status=408, latency_ms=waited_ms, wait_ms=waited_ms,
        )
        self.metrics.queries_deadline += 1
        ts = str(r.tenant)
        self.obs.inc("serve_requests_total", tenant=ts, kind="query",
                     status="408")
        self.obs.inc("serve_deadline_total", tenant=ts)
        tr = self.tracer.begin("query", r.tenant, r.rid)
        if tr is None:
            return
        tr.span("admission", "admission", r.admit_s, r.admit_s,
                reserved_ru=r.reserved_ru, refunded=True)
        tr.span("queue", "queue", r.arrival_s, now_s)
        tr.span("deadline", "deadline", now_s, now_s,
                deadline_ms=(r.deadline_s - r.arrival_s) * 1000.0,
                waited_ms=waited_ms)
        self.tracer.finish(tr, status=408, ru=0.0, latency_ms=waited_ms,
                           t0_s=r.arrival_s, t1_s=now_s)

    def _dispatch_chunk(self, key: tuple, batch: list[ServeRequest]):
        shard_key, k, L, exact, _pred_key = key
        predicate = batch[0].predicate  # whole group shares one canonical key
        queries = np.stack([r.vector for r in batch]).astype(np.float32)
        health = self._partition_health if self.replica_sets else None
        # ONE resolved chunk-plan beam width: every search flavor below
        # shares it, and the control policy may move it per micro-batch
        # (clamped into the compiled policy_widths signature set)
        beam_width = self._chunk_beam_width()

        def run():
            # the plan body: the executor decides WHERE/WHEN this service
            # time is spent, never what runs
            partitions = self._resolve(shard_key)
            if exact:
                ids, dists, ru_total, service_ms, plan, pspans, failed = \
                    self._exact_scan(partitions, queries, k,
                                     predicate=predicate, health=health)
            else:
                if predicate is not None:
                    ids, dists, info = batched_filtered_fanout_search(
                        partitions, queries, k, predicate, L=L,
                        batch_buckets=self.cfg.batch_buckets,
                        beam_width=beam_width, health=health,
                    )
                    plan = info["plan"]
                elif self.cfg.dispatch_mode == "spmd":
                    ids, dists, info = self._spmd().search(
                        partitions, queries, k, L=L,
                        batch_buckets=self.cfg.batch_buckets,
                        beam_width=beam_width,
                        rerank_multiplier=self.cfg.search_list_multiplier,
                        health=health,
                    )
                    plan = "graph-spmd"
                else:
                    ids, dists, info = batched_fanout_search(
                        partitions, queries, k, L=L,
                        batch_buckets=self.cfg.batch_buckets,
                        beam_width=beam_width, health=health,
                    )
                    plan = "graph"
                ru_total = info["ru_total"]
                service_ms = info["service_latency_ms"]
                pspans = self._partition_spans(info)
                failed = list(info.get("failed_partitions", ()))
                pstats = info["stats_per_partition"]
                if pstats:
                    self.metrics.note_hops(
                        float(np.mean([s.hops for s in pstats])), len(batch)
                    )
            # degraded fan-out: the survivors answered; record each missing
            # partition as a zero-duration failure span under the lane
            for pid, err in failed:
                pspans.append((0.0, dict(pid=int(pid), failed=True,
                                         error=str(err), ru=0.0)))
            service_ms += self.cfg.dispatch_overhead_ms
            return (ids, dists, plan, pspans, failed), service_ms, ru_total

        try:
            out = self.executor.dispatch(run)
        except Exception:
            # hand the admission reservations back — a failed dispatch must
            # not bleed the tenants' budgets
            for r in batch:
                self.tenant_governor(r.tenant).refund(r.reserved_ru)
            raise

        ids, dists, plan, pspans, failed = out.payload
        complete = not failed
        if failed:
            plan += "+degraded[" + ",".join(str(p) for p, _ in failed) + "]"
        # paged-tier accounting: per-query hit/miss shares from
        # the partition stats, surfaced as metrics + rerank child spans
        tier_h, tier_m = self._tier_totals(pspans)
        rerank_spans = self._rerank_spans(pspans)
        ru_work = out.ru  # the batch's search work, hedge surcharge apart
        ru_total = out.ru + out.hedge_ru  # hedged duplicates bill in full
        service_ms = (out.end_s - out.start_s) * 1000.0
        if out.hedged:
            self.metrics.note_hedge(out.hedge_won, out.hedge_ru)

        B = len(batch)
        bucket = smod.next_bucket(B, self.cfg.batch_buckets)
        self.metrics.note_batch(B, bucket, service_ms, ru_work,
                                serving_jit_cache_size())
        ru_q = ru_total / B  # what the client is billed (hedge included)
        work_q = ru_work / B
        hedge_q = out.hedge_ru / B
        for i, r in enumerate(batch):
            # start_s includes lane queue wait: under replica dispatch a
            # batch that finds every lane busy pays that wait in its
            # latency percentiles, exactly like a real executor pool
            wait_ms = (out.start_s - r.arrival_s) * 1000.0
            lat_ms = (out.end_s - r.arrival_s) * 1000.0
            assert r.rid not in self.responses, (
                f"rid {r.rid} already answered: one admitted request must "
                f"produce exactly one response/latency sample (hedge and "
                f"retry duplicates are lane-plane internals)"
            )
            self.responses[r.rid] = ServeResponse(
                rid=r.rid, status=200, ids=ids[i], dists=dists[i], ru=ru_q,
                plan=plan, latency_ms=lat_ms, wait_ms=wait_ms, batch_size=B,
                complete=complete,
            )
            self.metrics.queries_ok += 1
            if not complete:
                self.metrics.queries_degraded += 1
                self.obs.inc("serve_degraded_total", tenant=str(r.tenant))
            self.metrics.latency_ms.observe(lat_ms)
            self.metrics.wait_ms.observe(wait_ms)
            self._settle(r.tenant, ru_q, r.reserved_ru)
            ts = str(r.tenant)
            self.obs.inc("serve_requests_total", tenant=ts, kind="query",
                         status="200")
            self.obs.inc("serve_ru_total", work_q, tenant=ts, op="query")
            if out.hedge_ru:
                self.obs.inc("serve_ru_total", hedge_q, tenant=ts, op="hedge")
            self.obs.observe("serve_latency_ms", lat_ms, tenant=ts)
            self.obs.observe("serve_stage_ms", wait_ms, stage="queue")
            self.obs.observe("serve_stage_ms", lat_ms - wait_ms, stage="lane")
            if tier_h or tier_m:
                self.obs.inc("serve_tier_total", tier_h, tenant=ts,
                             tier="vector", outcome="hit")
                self.obs.inc("serve_tier_total", tier_m, tenant=ts,
                             tier="vector", outcome="miss")
            self._emit_trace("query", r.rid, r.tenant, r.arrival_s,
                             r.admit_s, r.reserved_ru, out, plan, B, bucket,
                             ru_q, lat_ms, pspans=pspans,
                             extra_spans=rerank_spans,
                             anomalies=() if complete
                             else (ANOMALY_DEGRADED,),
                             beam_width=beam_width)

    # ------------------------------------------------------------------
    # trace plane
    # ------------------------------------------------------------------
    @staticmethod
    def _partition_spans(info: dict) -> list:
        """(latency_ms, attrs) per searched partition from a fan-out info
        dict — the RU plus the hop/expansion/cmps counters the RU/latency
        split is computed from (store.ru.counters_for_ru /
        counters_for_latency)."""
        pids = info.get("partition_ids", ())
        stats = info.get("stats_per_partition") or [None] * len(pids)
        out = []
        for pid, ru_i, lat_i, st in zip(pids, info["ru_per_partition"],
                                        info["server_latencies_ms"], stats):
            attrs = dict(pid=int(pid), ru=float(ru_i))
            if st is not None:
                attrs.update(hops=float(st.hops),
                             expansions=float(st.expansions),
                             cmps=float(st.cmps), plan=st.plan,
                             tier_hits=float(getattr(st, "tier_hits", 0.0)),
                             tier_misses=float(
                                 getattr(st, "tier_misses", 0.0)))
            out.append((float(lat_i), attrs))
        return out

    def _tier_totals(self, pspans: Sequence) -> tuple[float, float]:
        """Per-query paged-tier touches summed over the fan-out (partition
        stats carry per-query means, so the sum IS the per-request
        share)."""
        h = sum(float(a.get("tier_hits", 0.0)) for _, a in pspans)
        m = sum(float(a.get("tier_misses", 0.0)) for _, a in pspans)
        return h, m

    def _rerank_spans(self, pspans: Sequence) -> list:
        """One rerank child span per partition that touched the paged
        vector tier: duration = the modelled miss-fetch time, attrs carry
        the hit/miss counts (the trace-plane face of the paged tier)."""
        us_pp = 0.0
        parts = self.collection.partitions
        if parts:
            us_pp = parts[0].providers.meter.cfg.us_per_vector_page
        out = []
        for _, a in pspans:
            if "tier_hits" not in a:
                continue
            th, tm = a["tier_hits"], a["tier_misses"]
            if th == 0.0 and tm == 0.0:
                continue
            out.append(dict(
                name=f"rerank[p{a['pid']}]", stage="rerank",
                dur_ms=tm * us_pp / 1000.0,
                attrs=dict(pid=a["pid"], tier_hits=th, tier_misses=tm),
            ))
        return out

    def _note_throttle(self, kind: str, rid: int, tenant: Any,
                       retry_after_s: float):
        """Registry + trace bookkeeping for a 429 rejection."""
        ts = str(tenant)
        self.obs.inc("serve_requests_total", tenant=ts, kind=kind,
                     status="429")
        self.obs.inc("serve_throttled_total", tenant=ts)
        tr = self.tracer.begin(kind, tenant, rid)
        if tr is None:
            return
        now = self.clock.now()
        tr.span("admission", "admission", now, now, throttled=True,
                retry_after_s=retry_after_s)
        self.tracer.finish(tr, status=429, ru=0.0, latency_ms=0.0,
                           t0_s=now, t1_s=now)

    def _emit_trace(self, kind: str, rid: int, tenant: Any, arrival_s: float,
                    admit_s: float, reserved_ru: float, out, plan: str,
                    batch_size: int, bucket: int, ru: float, lat_ms: float,
                    pspans: Sequence = (), extra_spans: Sequence = (),
                    anomalies: tuple = (),
                    beam_width: Optional[int] = None):
        """Record one served request's lifecycle trace from its dispatch
        outcome. The root spans — queue [arrival → lane start] and lane
        [lane start → completion] — tile the request interval, so their
        summed duration equals the recorded latency (the reconciliation
        invariant ``trace.validate_trace_record`` enforces). admission and
        batch_form are point events on the root; partition fan-out, the
        hedge duplicate, fault retries and the merge hang off the lane
        span as its parallel decomposition."""
        tr = self.tracer.begin(kind, tenant, rid)
        if tr is None:
            return
        start, end = out.start_s, out.end_s
        q1 = min(max(start, arrival_s), end)  # tiling-safe lane boundary
        tr.span("admission", "admission", admit_s, admit_s,
                reserved_ru=reserved_ru)
        tr.span("queue", "queue", arrival_s, q1)
        attrs = dict(batch_size=batch_size, bucket=bucket, plan=plan)
        if beam_width is not None:  # the resolved chunk-plan W (policy-set)
            attrs["beam_width"] = beam_width
        tr.span("batch_form", "batch_form", q1, q1, **attrs)
        lane = tr.span("lane", "lane", q1, end, lane=out.lane,
                       hedged=out.hedged, straggled=out.straggled,
                       retried_lanes=list(out.retried_lanes), ru=ru)
        for lat_i, attrs in pspans:
            tr.span(f"partition[p{attrs['pid']}]", "partition",
                    start, start + lat_i / 1000.0, parent=lane, **attrs)
        for sp in extra_spans:
            tr.span(sp["name"], sp["stage"], start,
                    start + sp["dur_ms"] / 1000.0, parent=lane,
                    **sp.get("attrs", {}))
        for lid in out.retried_lanes:
            tr.span(f"retry[lane{lid}]", "retry", start, start, parent=lane,
                    lane=lid)
        if out.hedged:
            tr.span("hedge", "hedge", out.hedge_start_s, out.hedge_end_s,
                    parent=lane, lane=out.hedge_lane, won=out.hedge_won,
                    ru=out.hedge_ru)
        ov = min(self.cfg.dispatch_overhead_ms / 1000.0, end - start)
        tr.span("merge", "merge", end - max(ov, 0.0), end, parent=lane)
        self.tracer.finish(tr, status=200, ru=ru, latency_ms=lat_ms,
                           t0_s=arrival_s, t1_s=end, anomalies=anomalies)

    def _spmd(self) -> SpmdFanout:
        if self._spmd_fanout is None:
            self._spmd_fanout = SpmdFanout(self._spmd_device)
        return self._spmd_fanout

    def _exact_scan(self, partitions, queries: np.ndarray, k: int,
                    predicate: Optional[Predicate] = None, health=None):
        """Batched VectorDistance(..., true): bucketed brute force per
        partition + merge (the paper's full-scan plan, RU-costed as a
        quantized-ish scan). With ``predicate`` the flat scan runs over
        the FILTERED subset — the compiled bitmap masks the scan, so
        ``WHERE`` + ``VectorDistance(..., true)`` brute-forces exactly the
        matching documents instead of silently ignoring the filter.
        ``health``-failed or faulting partitions degrade (skipped, listed
        in the returned ``failed``); only every partition failing raises
        ``AllPartitionsFailed``.

        Each partition is scanned on its device mirror (``materialize``):
        only the bucket of queries and, under a predicate, the scan mask go
        to the device per call."""
        B = len(queries)
        plan = "exact" if predicate is None else "exact-filtered"
        failed: list = []  # (pid, error) per unreachable partition
        if not partitions:  # empty tenant collection: nothing to scan
            return (np.full((B, k), -1, np.int64), np.full((B, k), np.inf),
                    0.0, 0.0, plan, [], failed)
        padded = smod.pad_batch_np(
            queries, smod.next_bucket(B, self.cfg.batch_buckets)
        )
        ids_l, d_l, ru, service_ms = [], [], 0.0, 0.0
        pspans: list = []  # (latency_ms, attrs) per scanned partition
        answered = 0
        for p in partitions:
            if health is not None and not health(p):
                failed.append((p.pid, "replica set down"))
                continue
            try:
                pv = p.providers
                scan_mask = pv.live
                n_scan = p.num_docs
                ru_p = 0.0
                if predicate is not None:
                    if p.num_docs == 0:
                        answered += 1
                        continue
                    mask, _words, nreads = compile_partition_filter(p, predicate)
                    # bill the compile's posting lookups even when the
                    # partition is then skipped as a no-match
                    ru_p += nreads * pv.meter.cfg.ru_per_prop_read
                    if mask is None:
                        ru += ru_p
                        answered += 1
                        continue
                    scan_mask = mask & pv.live
                    n_scan = int(scan_mask.sum())
                _, _, _, live_t, vectors_t = pv.materialize(p.index.ctx)
                mask_t = (live_t if predicate is None
                          else p.index._t(scan_mask))
                ids, dists = fmod.brute_force(
                    p.index._t(padded), vectors_t, mask_t, k=k,
                    metric=p.index.cfg.metric,
                )
            except CrashError:
                raise  # injected process kill: never degrade past it
            except Exception as e:  # noqa: BLE001 — degrade, don't fail
                failed.append((p.pid, f"{type(e).__name__}: {e}"))
                continue
            answered += 1
            ids_l.append(p.index._to_doc_ids(ids.cpu().numpy())[:B])
            d_l.append(dists.cpu().numpy()[:B])
            # every lane scans the (filtered) subset: full scan at
            # quantized-ish cost, PER QUERY (RU must not deflate with
            # batch size)
            ru_p += 0.5 * n_scan * 0.0125 * B
            # paged-tier touch: an exact scan streams every
            # scanned vector through once, so non-resident pages bill one
            # fetch for the whole batch (shared stream, NOT ×B) and the
            # sequential sweep must not evict the working set (admit=False
            # scan resistance)
            th = tm = 0
            pages = getattr(pv, "pages", None)
            if pages is not None and n_scan:
                th, tm, _ = pages.touch(np.nonzero(np.asarray(scan_mask))[0],
                                        admit=False)
                ru_p += tm * pv.meter.cfg.ru_per_vector_page
            ru += ru_p
            # partitions scan in parallel — client latency tracks the worst
            # partition (§4.3), same model as the graph path
            lat_p = pv.meter.latency_ms(OpCounters(quant_reads=n_scan,
                                                   vector_page_misses=tm))
            service_ms = max(service_ms, lat_p)
            pspans.append((lat_p, dict(pid=int(p.pid), ru=ru_p,
                                       n_scan=n_scan, plan=plan,
                                       tier_hits=float(th) / max(B, 1),
                                       tier_misses=float(tm) / max(B, 1))))
        if failed and answered == 0:
            raise AllPartitionsFailed(
                f"exact scan: all partitions failed: {failed}"
            )
        if not ids_l:  # predicate matched nothing anywhere
            return (np.full((B, k), -1, np.int64), np.full((B, k), np.inf),
                    ru, service_ms, plan, pspans, failed)
        ids, dists = merge_topk(ids_l, d_l, k)
        return ids, dists, ru, service_ms, plan, pspans, failed

    # ------------------------------------------------------------------
    # host-path execution (filtered plans need the document store; the
    # service builds the per-partition masks, the engine still owns
    # admission, clock, RU settlement and metrics)
    # ------------------------------------------------------------------
    def execute_host(self, tenant: Any, plan: str,
                     fn: Callable[[], tuple],
                     is_page: bool = False) -> ServeResponse:
        """Run one host-side plan body under engine accounting: admission
        (raises ``Throttled`` with the reservation untouched), clock, RU
        settlement + EMA, and metrics. ``fn`` returns (ids, dists, ru,
        service_ms) or (ids, dists, ru, service_ms, plan) — the 5-tuple
        form lets the body report the plan it actually executed (e.g. the
        per-partition aggregate of a filtered query). A 6th element may
        carry trace child spans — dicts of (name, stage, dur_ms, attrs) —
        which land under the request's lane span (e.g. a page's
        per-partition fetch rounds from ``paged_fanout_search``)."""
        kind = "page" if is_page else "query"
        rejected, reserved = self._admit(tenant)
        if rejected is not None:
            self._note_throttle(kind, -1, tenant, rejected.retry_after_s)
            raise Throttled(tenant, rejected.retry_after_s)
        submit_s = self.clock.now()

        def run():
            out = fn()
            ids, dists, ru, service_ms = out[:4]
            body_plan = out[4] if len(out) > 4 else plan
            extra_spans = out[5] if len(out) > 5 else ()
            return ((ids, dists, body_plan, extra_spans),
                    service_ms + self.cfg.dispatch_overhead_ms, ru)

        # page bodies schedule their own multi-cursor refill rounds on the
        # lanes (paged_fanout_search), so they must not also book a lane
        try:
            out = self.executor.dispatch(run, occupy=not is_page)
        except Exception:
            # e.g. a user filter predicate raising: refund the reservation
            self.tenant_governor(tenant).refund(reserved)
            raise
        ids, dists, plan_out, extra_spans = out.payload
        ru_work = out.ru
        ru = out.ru + out.hedge_ru
        if out.hedged:
            self.metrics.note_hedge(out.hedge_won, out.hedge_ru)
        service_ms = (out.end_s - out.start_s) * 1000.0
        wait_ms = (out.start_s - submit_s) * 1000.0
        lat_ms = (out.end_s - submit_s) * 1000.0
        self._settle(tenant, ru, reserved)
        self.metrics.queries_ok += 1
        if is_page:
            self.metrics.pages_served += 1
        self.metrics.latency_ms.observe(lat_ms)
        self.metrics.wait_ms.observe(wait_ms)
        self.metrics.note_batch(1, 1, service_ms, ru_work,
                                serving_jit_cache_size())
        ts = str(tenant)
        self.obs.inc("serve_requests_total", tenant=ts, kind=kind,
                     status="200")
        self.obs.inc("serve_ru_total", ru_work, tenant=ts, op=kind)
        if out.hedge_ru:
            self.obs.inc("serve_ru_total", out.hedge_ru, tenant=ts,
                         op="hedge")
        self.obs.observe("serve_latency_ms", lat_ms, tenant=ts)
        self.obs.observe("serve_stage_ms", wait_ms, stage="queue")
        self.obs.observe("serve_stage_ms", lat_ms - wait_ms, stage="lane")
        self._emit_trace(kind, -1, tenant, submit_s, submit_s, reserved,
                         out, plan_out, 1, 1, ru, lat_ms,
                         extra_spans=extra_spans)
        return ServeResponse(rid=-1, status=200, ids=ids, dists=dists, ru=ru,
                             plan=plan_out, latency_ms=lat_ms, wait_ms=wait_ms,
                             batch_size=1)

    # ------------------------------------------------------------------
    # control plane (serve.policy)
    # ------------------------------------------------------------------
    def _chunk_beam_width(self) -> int:
        """The resolved per-micro-batch W. Static policy → the config
        constant, untouched. Active policy → the current decision,
        clamped into ``policy_widths`` (the compiled signature set) so a
        policy bug can never mint a compile stall mid-traffic."""
        if not self.policy.enabled:
            return self.cfg.beam_width
        W = self._decision.beam_width
        if W in self._allowed_widths:
            return W
        return min(self._allowed_widths, key=lambda w: abs(w - W))

    def _policy_tick(self):
        """One control-loop evaluation at the top of ``pump()``: collect
        rollup signals, ask the policy, record knob moves in the
        ``serve_policy_total`` metric family, actuate topology."""
        if not self.policy.enabled:
            return
        prev = self._decision
        sig = self._policy_signals()
        dec = self.policy.tick(sig)
        self.metrics.policy_ticks += 1
        if dec.beam_width != prev.beam_width:
            self.metrics.policy_w_changes += 1
            self.obs.inc("serve_policy_total", knob="beam_width",
                         action=f"w{dec.beam_width}")
        if dec.ingest_interleave != prev.ingest_interleave:
            self.obs.inc("serve_policy_total", knob="ingest",
                         action=f"interleave{dec.ingest_interleave}")
        if dec.idle_ingest != prev.idle_ingest:
            self.obs.inc("serve_policy_total", knob="ingest",
                         action=f"idle{dec.idle_ingest}")
        self._decision = dec
        if dec.cache_step:
            self._apply_cache_step(dec.cache_step)
        if dec.scale is not None:
            self._apply_scale(dec, sig)

    def _policy_signals(self) -> PolicySignals:
        """The policy's view of the plane, derived from the same rollups
        operators read (``observability_summary``) — never raw counters."""
        summ = self.observability_summary()
        stages = {name: (int(row["count"]), float(row["total_ms"]))
                  for name, row in summ["stages"].items()}
        ru_total = sum(
            row["ru_query"] + row["ru_page"] + row["ru_hedge"]
            + row["ru_ingest"] for row in summ["per_tenant"].values()
        )
        disp = self.executor.snapshot()
        occ = disp["lane_occupancy"]
        mem = self.memory_snapshot()["vector_tier"]
        return PolicySignals(
            now_s=self.clock.now(),
            queue_depth=len(self.queue),
            ingest_backlog_chunks=len(self._ingest_q),
            ingest_backlog_ops=self.ingest_backlog,
            slo_ms=self.cfg.trace_slo_ms,
            stages=stages,
            ru_total=float(ru_total),
            lanes_busy_s=float(sum(disp["lane_busy_s"])),
            lane_occupancy=float(sum(occ) / len(occ)) if occ else 0.0,
            lanes=len(self.executor.lanes),
            partitions=len(self.collection.partitions),
            # cumulative page-cache counters straight off the stores (NOT
            # the registry: they survive metrics-epoch resets, so the
            # policy's windowed deltas never go negative at a warmup
            # boundary)
            tier_hits=float(mem["hits"]),
            tier_misses=float(mem["misses"]),
            tier_resident_frac=float(mem["resident_frac"]),
            tiered=bool(mem["tiered"]),
        )

    def _apply_cache_step(self, step: int):
        """Actuate one page-cache sizing impulse: every finite-budget
        partition's paged tier grows/shrinks by ~10% of its page count,
        clamped into [10%, 100%] residency. Fully-resident (budget=None)
        partitions are NEVER touched — the policy may only resize a tier
        the operator already opted into."""
        moved = False
        for p in self.collection.partitions:
            pages = getattr(p.providers, "pages", None)
            if pages is None or pages.budget_pages is None:
                continue
            delta = max(1, pages.n_pages // 10)
            lo = max(1, int(round(0.1 * pages.n_pages)))
            new = int(np.clip(pages.budget_pages + step * delta,
                              lo, pages.n_pages))
            if new != pages.budget_pages:
                pages.resize_budget(new)
                moved = True
        if moved:
            self.metrics.policy_cache_resizes += 1
            self.obs.inc("serve_policy_total", knob="cache",
                         action="grow" if step > 0 else "shrink")

    def _apply_scale(self, dec, sig: PolicySignals):
        """Actuate one topology decision: a replica-lane scale-out (the
        executor grows a lane and every replica set gains a member) or a
        partition split (the fullest partition halves). The action is
        attributable: a ``policy``-kind trace records the triggering
        signals, and ``serve_policy_total{knob="topology"}`` counts it."""
        now = self.clock.now()
        detail = ""
        if dec.scale == "scale_out" and self.cfg.dispatch_mode == "replica":
            lane_id = self.executor.add_lane()
            for rs in self.replica_sets:
                rs.add_replica()
            self.metrics.policy_lanes_added += 1
            detail = f"lane{lane_id}"
        elif dec.scale in ("split", "scale_out"):
            # scale_out outside the replica plane degrades to a split —
            # the only topology lever the serial/spmd planes have
            j, (left, right) = self.collection.split_hottest()
            self.metrics.policy_splits += 1
            detail = f"j{j}->p{left.pid},p{right.pid}"
        else:
            raise ValueError(f"unknown scale action {dec.scale!r}")
        self._last_scale = dict(action=dec.scale, t_s=now, detail=detail,
                                reason=dec.reason)
        self.obs.inc("serve_policy_total", knob="topology", action=dec.scale)
        tr = self.tracer.begin("policy", "engine", -1)
        if tr is not None:
            tr.span(f"policy[{dec.scale}]", "policy", now, now,
                    action=dec.scale, detail=detail, reason=dec.reason,
                    queue_depth=sig.queue_depth, lanes=sig.lanes,
                    partitions=sig.partitions)
            self.tracer.finish(tr, status=200, ru=0.0, latency_ms=0.0,
                               t0_s=now, t1_s=now)

    def _interleave_ingest(self):
        """Post-batch ingest drain. Static policy: exactly the configured
        interleave (the pre-policy behavior). Active policy: the current
        yield decision — 0 under latency pressure (the deferral is
        recorded as catch-up debt), ``catchup_chunks`` when the queue is
        empty."""
        if not self.policy.enabled:
            self._drain_ingest(self.cfg.ingest_interleave)
            return
        n = self._decision.ingest_interleave
        if self._ingest_q and n < self.cfg.ingest_interleave:
            self.metrics.ingest_deferred_chunks += min(
                self.cfg.ingest_interleave - n, len(self._ingest_q))
        self._drain_ingest(n)

    def _idle_ingest(self):
        """Idle-pump ingest drain. Static policy: the 1-chunk trickle.
        Active policy: the decision's idle allowance (≥ 1 — deferral
        must never starve the backlog forever); chunks beyond the
        trickle count as repaid catch-up debt."""
        if not self._ingest_q:
            return
        if not self.policy.enabled:
            self._drain_ingest(1)
            return
        drained = self._drain_ingest(max(1, self._decision.idle_ingest))
        if drained > 1:
            self.metrics.ingest_catchup_chunks += drained - 1

    def policy_state(self) -> dict:
        """The control plane's externally visible state (also under
        ``snapshot()["policy"]``): current knob positions, decision
        counters, the ingest catch-up debt ledger, and the last topology
        action with the signals that triggered it."""
        m = self.metrics
        return dict(
            mode="adaptive" if self.policy.enabled else "static",
            enabled=self.policy.enabled,
            beam_width=self._chunk_beam_width(),
            ingest_interleave=(self._decision.ingest_interleave
                               if self.policy.enabled
                               else self.cfg.ingest_interleave),
            idle_ingest=(self._decision.idle_ingest
                         if self.policy.enabled else 1),
            widths=list(self._allowed_widths),
            ticks=m.policy_ticks,
            w_changes=m.policy_w_changes,
            splits=m.policy_splits,
            lanes_added=m.policy_lanes_added,
            cache_resizes=m.policy_cache_resizes,
            last_scale=self._last_scale,
            ingest_debt=dict(
                backlog_chunks=len(self._ingest_q),
                backlog_ops=self.ingest_backlog,
                deferred_chunks=m.ingest_deferred_chunks,
                catchup_chunks=m.ingest_catchup_chunks,
            ),
        )

    # ------------------------------------------------------------------
    # interleaved ingest
    # ------------------------------------------------------------------
    def _drain_ingest(self, n_chunks: int) -> int:
        """Apply up to ``n_chunks`` queued ingest mini-batches; returns
        how many actually drained."""
        drained = 0
        for _ in range(n_chunks):
            if not self._ingest_q:
                return drained
            kind, apply_fn, n_ops, tenant = self._ingest_q.popleft()
            drained += 1
            t0 = self.clock.now()
            ru = float(apply_fn())
            t1 = self.clock.advance(ru * self.cfg.ingest_ms_per_ru / 1000.0)
            self.metrics.ingest_ops += n_ops
            self.metrics.ingest_batches += 1
            self.metrics.ru_ingest_total += ru
            ts = str(tenant)
            self.obs.inc("serve_requests_total", tenant=ts, kind="ingest",
                         status="200")
            self.obs.inc("serve_ru_total", ru, tenant=ts, op="ingest")
            tr = self.tracer.begin("ingest", tenant, -1)
            if tr is not None:
                tr.span(f"ingest[{kind}]", "ingest", t0, t1, op=kind,
                        n_ops=n_ops, ru=ru)
                self.tracer.finish(tr, status=200, ru=ru,
                                   latency_ms=(t1 - t0) * 1000.0,
                                   t0_s=t0, t1_s=t1)
        return drained

    def flush_ingest(self):
        """Apply every queued ingest mini-batch now (synchronous ingest)."""
        self._drain_ingest(len(self._ingest_q))

    @property
    def ingest_backlog(self) -> int:
        return sum(n for _, _, n, _ in self._ingest_q)

    def next_rid(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        return rid

    # ------------------------------------------------------------------
    def memory_snapshot(self) -> dict:
        """Per-tier residency accounting: what is pinned in
        memory per partition (PQ codes, adjacency, postings metadata) vs
        what lives in the paged full-precision tier, plus the page cache's
        capacity/occupancy and cumulative hit/miss counters."""
        resident = dict(pq_codes_bytes=0, adjacency_bytes=0,
                        tombstone_bytes=0)
        per_partition = []
        agg = dict(total_bytes=0, resident_bytes=0, capacity_pages=0,
                   resident_pages=0, hits=0, misses=0, evictions=0)
        tiered = False
        for p in self.collection.partitions:
            pv = p.providers
            resident["pq_codes_bytes"] += int(pv.codes.nbytes
                                              + pv.versions.nbytes)
            resident["adjacency_bytes"] += int(pv.neighbors.nbytes)
            resident["tombstone_bytes"] += int(pv.live.nbytes)
            pages = getattr(pv, "pages", None)
            if pages is None:
                continue
            st = pages.state()
            st["pid"] = int(p.pid)
            per_partition.append(st)
            cap = st["budget_pages"]
            if cap is None:
                cap = st["n_pages"]
            else:
                tiered = True
            agg["total_bytes"] += st["total_bytes"]
            agg["resident_bytes"] += st["resident_bytes"]
            agg["capacity_pages"] += cap
            agg["resident_pages"] += st["resident_pages"]
            agg["hits"] += st["hits"]
            agg["misses"] += st["misses"]
            agg["evictions"] += st["evictions"]
        touches = agg["hits"] + agg["misses"]
        return dict(
            resident=resident,
            vector_tier=dict(
                tiered=tiered,
                hit_rate=agg["hits"] / touches if touches else 1.0,
                resident_frac=(agg["resident_bytes"] / agg["total_bytes"]
                               if agg["total_bytes"] else 1.0),
                **agg,
            ),
            per_partition=per_partition,
        )

    def snapshot(self) -> dict:
        snap = self.metrics.snapshot(self.clock.now())
        snap["queue_depth"] = len(self.queue)
        snap["ingest_backlog"] = self.ingest_backlog
        snap["dispatch"] = self.executor.snapshot()
        snap["policy"] = self.policy_state()
        snap["memory"] = self.memory_snapshot()
        snap["tenants"] = {
            t: dict(available_ru=g.available, consumed_ru=g.consumed,
                    throttle_events=g.throttle_events,
                    settlements=g.settlements, refunded_ru=g.refunded)
            for t, g in self.tenants.items()
        }
        snap["observability"] = self.observability_summary()
        return snap

    def observability_summary(self) -> dict:
        """The cost-attribution read-out: per-stage latency decomposition,
        per-tenant RU/QPS/throttle/p95 breakdown, tracer health."""
        elapsed = max(self.clock.now() - self.metrics.started_s, 1e-9)
        stages = {}
        for labels, h in self.obs.series("serve_stage_ms"):
            stages[labels["stage"]] = dict(
                count=h.count, total_ms=h.sum, mean_ms=h.mean(),
                p95_ms=h.percentile(95))
        per_tenant = {}
        for t in self.obs.label_values("serve_requests_total", "tenant"):
            lat = self.obs.histogram("serve_latency_ms", tenant=t)
            served = self.obs.total("serve_requests_total", tenant=t,
                                    status="200")
            per_tenant[t] = dict(
                requests=served,
                qps=served / elapsed,
                throttled=self.obs.counter_value("serve_throttled_total",
                                                 tenant=t),
                deadline_exceeded=self.obs.counter_value(
                    "serve_deadline_total", tenant=t),
                degraded=self.obs.counter_value("serve_degraded_total",
                                                tenant=t),
                ru_query=self.obs.counter_value("serve_ru_total", tenant=t,
                                                op="query"),
                ru_page=self.obs.counter_value("serve_ru_total", tenant=t,
                                               op="page"),
                ru_hedge=self.obs.counter_value("serve_ru_total", tenant=t,
                                                op="hedge"),
                ru_ingest=self.obs.counter_value("serve_ru_total", tenant=t,
                                                 op="ingest"),
                p95_ms=lat.percentile(95) if lat is not None else 0.0,
            )
        return dict(stages=stages, per_tenant=per_tenant,
                    tracer=self.tracer.stats())
