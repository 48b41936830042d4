"""Request-lifecycle tracing on simulated time — the serving sensor layer.

The paper's headline claims are *observability* claims: <20 ms query
latency, stable recall over updates, ~43×/12× lower query cost (§4,
Figs 10-13). Verifying them per request needs a stage-level decomposition
of where each millisecond and each RU goes — admission, queue wait,
batch formation, lane dispatch (hedge duplicates, fault retries),
per-partition fan-out, merge. This module provides that decomposition:

  * ``Span`` / ``Trace`` — one trace per query / page / ingest op, with
    child spans per lifecycle stage. All timestamps are **SimClock
    seconds** (the engine's deterministic simulated timeline), so traces
    are bit-reproducible offline and stage durations reconcile *exactly*
    with the latency the engine records: the root-level stage spans of a
    served request tile its [arrival, completion] interval, so
    ``sum(root span durations) == latency_ms`` (asserted by
    ``validate_trace_record`` and the tier-1 tests). Child spans under
    ``lane`` model the *parallel* structure (per-partition fan-out, the
    hedge duplicate) and deliberately overlap.

  * ``Tracer`` — the factory the engine owns. ``enabled=False`` makes
    ``begin`` return ``None`` and every hot path guards on that, so a
    disabled tracer costs one attribute read per request — nothing is
    allocated, nothing is retained.

  * ``FlightRecorder`` — a bounded ring buffer of recent trace records
    plus a *separate* bounded ring for anomalous traces (throttles,
    faults, hedges, SLO violations), so a burst of healthy traffic can
    never evict the interesting evidence.

  * Exporters — ``Tracer.dump_jsonl`` writes the retained records as
    JSON lines; ``validate_trace_record`` is the schema contract the
    benchmark gate re-checks on every emitted line.

Stage taxonomy (``STAGES``):

  admission   point event: the RU-governance decision (reserved estimate)
  queue       [arrival → lane start]: batching + lane queue wait
  batch_form  point event at dispatch: batch size / bucket / plan
  lane        [lane start → completion]: the dispatch-plane service
  partition   child of lane: one span per physical partition searched,
              carrying that partition's RU and the search counters the
              RU/latency split is computed from (hops / expansions /
              cmps — see ``store.ru.counters_for_ru`` /
              ``counters_for_latency``)
  hedge       child of lane: the straggler duplicate (RU billed in full)
  retry       child of lane: a lane fault burned before the work ran
  merge       child of lane: host-side merge / dispatch overhead
  ingest      root span of an ingest mini-batch trace
  deadline    point event: the request's deadline expired while it was
              still queued; the engine abandoned it (status 408) and
              refunded the admission reservation
  policy      point event: a control-plane action (serve/policy.py) —
              a topology split / replica scale-out with the signals
              that triggered it, so scaling is attributable in traces

The port's own copy of ``repro.serve.trace`` (no JAX there, but importing
it through ``repro`` loads JAX); the records and their schema are the
reference's.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Any, Optional

from .metrics import SimClock

STAGES = ("admission", "queue", "batch_form", "lane", "partition", "hedge",
          "retry", "merge", "ingest", "deadline", "policy", "rerank")

TRACE_KINDS = ("query", "page", "ingest", "policy")

# anomaly tags the flight recorder always captures
ANOMALY_THROTTLE = "throttle"
ANOMALY_HEDGE = "hedge"
ANOMALY_FAULT = "fault_retry"
ANOMALY_SLO = "slo_violation"
ANOMALY_DEADLINE = "deadline_exceeded"
ANOMALY_DEGRADED = "degraded"


@dataclasses.dataclass
class Span:
    """One lifecycle stage of one request, on SimClock time."""

    name: str
    stage: str
    t0_s: float
    t1_s: float
    parent: int = -1  # index into the owning trace's span list
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def dur_ms(self) -> float:
        return (self.t1_s - self.t0_s) * 1000.0


@dataclasses.dataclass
class Trace:
    """One request's lifecycle: a flat span list with parent links."""

    trace_id: int
    kind: str  # query | page | ingest
    tenant: Any
    rid: int
    t0_s: float = 0.0
    t1_s: float = 0.0
    status: int = 0
    ru: float = 0.0
    latency_ms: float = 0.0
    anomalies: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)

    def span(self, name: str, stage: str, t0_s: float, t1_s: float,
             parent: int = -1, **attrs) -> int:
        """Append a span; returns its index (usable as a parent link)."""
        self.spans.append(Span(name, stage, float(t0_s), float(t1_s),
                               parent, attrs))
        return len(self.spans) - 1

    def stage_totals(self) -> dict:
        """Root-span duration per stage (ms). Root spans are sequential —
        they tile [t0, t1] — so their sum reconciles with latency_ms;
        children (partition fan-out, hedge) model parallel structure and
        are excluded."""
        out: dict[str, float] = {}
        for s in self.spans:
            if s.parent == -1:
                out[s.stage] = out.get(s.stage, 0.0) + s.dur_ms
        return out

    def has_stage(self, stage: str) -> bool:
        return any(s.stage == stage for s in self.spans)

    def to_record(self) -> dict:
        """The JSON-lines export shape (see ``validate_trace_record``)."""
        return dict(
            trace_id=self.trace_id,
            kind=self.kind,
            tenant=str(self.tenant),
            rid=self.rid,
            status=self.status,
            t0_s=self.t0_s,
            t1_s=self.t1_s,
            latency_ms=self.latency_ms,
            ru=self.ru,
            anomalies=list(self.anomalies),
            spans=[
                dict(name=s.name, stage=s.stage, t0_s=s.t0_s, t1_s=s.t1_s,
                     dur_ms=s.dur_ms, parent=s.parent, attrs=s.attrs)
                for s in self.spans
            ],
        )


class FlightRecorder:
    """Bounded retention of recent + anomalous traces.

    ``ring`` holds the last ``capacity`` traces of *any* outcome;
    ``anomalous`` is a separate ring that only anomalous traces enter, so
    throttles / faults / hedges / SLO violations survive arbitrarily long
    bursts of healthy traffic (they fall out only to newer anomalies).

    Retained entries are live ``Trace`` objects — serialization to the
    record dict happens lazily in ``records()`` (the export/read path),
    never on the per-request hot path.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self.ring: deque = deque(maxlen=self.capacity)
        self.anomalous: deque = deque(maxlen=self.capacity)
        self.recorded = 0
        self.anomalies_seen = 0

    def record(self, tr: "Trace"):
        self.recorded += 1
        self.ring.append(tr)
        if tr.anomalies:
            self.anomalies_seen += 1
            self.anomalous.append(tr)

    def records(self) -> list:
        """Every retained record dict, dedup'd by trace id (ring ∪
        anomalous), serialized on demand."""
        seen = set()
        out = []
        for tr in list(self.ring) + list(self.anomalous):
            if tr.trace_id in seen:
                continue
            seen.add(tr.trace_id)
            out.append(tr.to_record())
        out.sort(key=lambda r: r["trace_id"])
        return out


class Tracer:
    """The engine's trace factory on the shared SimClock.

    Zero-overhead when disabled: ``begin`` returns ``None`` and callers
    guard span emission on that — no allocation, no retention. When
    enabled, ``finish`` derives anomaly tags (throttle / hedge / fault /
    SLO) and hands the record to the flight recorder.
    """

    def __init__(self, clock: SimClock, enabled: bool = True,
                 capacity: int = 256, slo_ms: Optional[float] = None):
        self.clock = clock
        self.enabled = bool(enabled)
        self.slo_ms = slo_ms
        self._capacity = int(capacity)
        self.recorder = FlightRecorder(capacity)
        self.started = 0
        self.finished = 0
        self._next_id = 0

    def reset(self):
        """Fresh recorder + counters (benchmark warmup boundary)."""
        self.recorder = FlightRecorder(self._capacity)
        self.started = 0
        self.finished = 0
        self._next_id = 0

    def begin(self, kind: str, tenant: Any, rid: int) -> Optional[Trace]:
        if not self.enabled:
            return None
        self.started += 1
        tid = self._next_id
        self._next_id += 1
        return Trace(trace_id=tid, kind=kind, tenant=tenant, rid=rid,
                     t0_s=self.clock.now())

    def finish(self, tr: Trace, status: int, ru: float, latency_ms: float,
               t0_s: Optional[float] = None, t1_s: Optional[float] = None,
               anomalies: tuple = ()):
        tr.status = int(status)
        tr.ru = float(ru)
        tr.latency_ms = float(latency_ms)
        if t0_s is not None:
            tr.t0_s = float(t0_s)
        tr.t1_s = float(t1_s) if t1_s is not None else self.clock.now()
        tags = list(anomalies)
        if status == 429 and ANOMALY_THROTTLE not in tags:
            tags.append(ANOMALY_THROTTLE)
        if status == 408 and ANOMALY_DEADLINE not in tags:
            tags.append(ANOMALY_DEADLINE)
        stages = {s.stage for s in tr.spans}
        if "hedge" in stages:
            tags.append(ANOMALY_HEDGE)
        if "retry" in stages:
            tags.append(ANOMALY_FAULT)
        if (self.slo_ms is not None and tr.kind != "ingest"
                and latency_ms > self.slo_ms):
            tags.append(ANOMALY_SLO)
        tr.anomalies = tags
        self.finished += 1
        self.recorder.record(tr)

    # ------------------------------------------------------------------
    # exporters
    # ------------------------------------------------------------------
    def dump_jsonl(self, path) -> int:
        """Write every retained trace record as one JSON object per line.
        Returns the number of records written."""
        recs = self.recorder.records()
        with open(path, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
        return len(recs)

    def stats(self) -> dict:
        return dict(
            enabled=self.enabled,
            started=self.started,
            finished=self.finished,
            recorded=self.recorder.recorded,
            retained=len(self.recorder.ring),
            anomalies_seen=self.recorder.anomalies_seen,
            anomalies_retained=len(self.recorder.anomalous),
            slo_ms=self.slo_ms,
        )


# ---------------------------------------------------------------------------
# schema contract (the benchmark gate re-validates every exported line)
# ---------------------------------------------------------------------------

_REQUIRED = {
    "trace_id": int, "kind": str, "tenant": str, "rid": int, "status": int,
    "t0_s": (int, float), "t1_s": (int, float),
    "latency_ms": (int, float), "ru": (int, float),
    "anomalies": list, "spans": list,
}

_SPAN_REQUIRED = {
    "name": str, "stage": str, "t0_s": (int, float), "t1_s": (int, float),
    "dur_ms": (int, float), "parent": int, "attrs": dict,
}


def validate_trace_record(rec: dict) -> None:
    """Raise ``ValueError`` unless ``rec`` is a well-formed trace record.

    Beyond structural checks (keys, types, stage taxonomy, parent links),
    this enforces the cost-attribution contract: for a served (status
    200) or deadline-abandoned (status 408) request, the root-level
    stage spans tile the request interval, so their summed duration
    equals ``latency_ms`` within clock resolution. That is the
    invariant that makes per-stage dashboards trustworthy — stages can
    never silently leak time, even for requests that never reached a
    lane.
    """
    if not isinstance(rec, dict):
        raise ValueError("trace record must be a dict")
    for key, typ in _REQUIRED.items():
        if key not in rec:
            raise ValueError(f"trace record missing key {key!r}")
        if not isinstance(rec[key], typ):
            raise ValueError(f"trace record key {key!r} has wrong type "
                             f"{type(rec[key]).__name__}")
    if rec["kind"] not in TRACE_KINDS:
        raise ValueError(f"unknown trace kind {rec['kind']!r}")
    if rec["t1_s"] < rec["t0_s"]:
        raise ValueError("trace t1_s < t0_s")
    spans = rec["spans"]
    if rec["status"] in (200, 408) and not spans:
        raise ValueError("served trace has no spans")
    for i, s in enumerate(spans):
        if not isinstance(s, dict):
            raise ValueError(f"span {i} is not a dict")
        for key, typ in _SPAN_REQUIRED.items():
            if key not in s:
                raise ValueError(f"span {i} missing key {key!r}")
            if not isinstance(s[key], typ):
                raise ValueError(f"span {i} key {key!r} has wrong type")
        if s["stage"] not in STAGES:
            raise ValueError(f"span {i} stage {s['stage']!r} not in taxonomy")
        if s["t1_s"] < s["t0_s"]:
            raise ValueError(f"span {i} t1_s < t0_s")
        if not -1 <= s["parent"] < i:
            raise ValueError(f"span {i} parent {s['parent']} must point at "
                             f"an earlier span (or -1)")
    if rec["status"] in (200, 408):
        root_ms = sum(s["dur_ms"] for s in spans if s["parent"] == -1)
        tol = 1e-6 + 1e-9 * abs(rec["latency_ms"])
        if abs(root_ms - rec["latency_ms"]) > tol:
            raise ValueError(
                f"stage decomposition leaks time: root spans sum to "
                f"{root_ms:.9f} ms but latency_ms is "
                f"{rec['latency_ms']:.9f} ms"
            )
