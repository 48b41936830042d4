"""The port's copies of the serving planes and its continuation codec, against
the JAX reference's, on the CPU.

``metrics``, ``obs``, ``trace``, ``executor`` and ``policy`` are copies: the
same scripted inputs, made from a seed, go through each package's module and
must give identical results (quantiles, lane outcomes, policy decisions,
trace records, the Prometheus text). Continuation tokens must be the same
bytes in both packages, decode in the other package, and a corrupted token
must raise ``ContinuationError`` in both."""
import dataclasses
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as rserve
import repro_torch.serve as tserve
from repro.core import paginate as rpg
from repro.partition import fanout as rfan
from repro_torch.core import graph as tgraph
from repro_torch.core import paginate as tpg
from repro_torch.partition import fanout as tfan

PERCENTILES = (0, 1, 25, 50, 90, 95, 99, 99.9, 100)


def _both(fn):
    """fn(package) for each package: (reference's result, port's result)."""
    return fn(rserve), fn(tserve)


# ---------------------------------------------------------------------------
# metrics: histograms, arrivals, EngineMetrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["Histogram", "ExactHistogram"])
def test_histogram_quantiles_identical(kind):
    sample = np.random.RandomState(3).lognormal(1.0, 1.2, 5000)
    sample[:7] = [0.0, 1e-4, 1e-3, 5e9, 3.0, 3.0, 2.5e-3]  # underflow / overflow bins

    def run(mod):
        h = getattr(mod, kind)()
        for v in sample:
            h.observe(v)
        return [h.percentile(p) for p in PERCENTILES] + [h.count, h.sum, h.mean()]

    ref, port = _both(run)
    assert ref == port


def test_arrivals_and_engine_metrics_identical():
    def run(mod):
        arr = mod.poisson_arrivals(np.random.RandomState(5), 200, 400.0, t0=1.5)
        m = mod.EngineMetrics(started_s=0.0)
        rng = np.random.RandomState(6)
        for i in range(40):
            B = int(rng.randint(1, 17))
            m.note_batch(B, 16, float(rng.exponential(3.0)), float(rng.uniform(5, 50)),
                         3 + i // 10)
            m.note_hops(float(rng.uniform(5, 30)), B)
            m.latency_ms.observe(float(rng.exponential(4.0)))
            m.queries_ok += B
        m.note_hedge(True, 12.5)
        return arr.tolist(), m.snapshot(float(arr[-1])), m.recompiles_since(5)

    ref, port = _both(run)
    assert ref == port


# ---------------------------------------------------------------------------
# executor: one seeded straggler schedule through each dispatch mode
# ---------------------------------------------------------------------------

EXECUTOR_CASES = {
    "serial": dict(mode="serial"),
    "replica_hedged": dict(mode="replica", lanes=4, hedge_at_ms=6.0, straggler_p=0.3,
                           straggler_factor=4.0, seed=7),
    "spmd": dict(mode="spmd", lanes=4, straggler_p=0.2, seed=2),
}


@pytest.mark.parametrize("case", sorted(EXECUTOR_CASES))
def test_lane_executor_outcomes_identical(case):
    def run(mod):
        clock = mod.SimClock()
        downs, ups = [], []
        ex = mod.executor.LaneExecutor(
            clock, on_lane_down=lambda ln, t: downs.append((ln, t)),
            on_lane_up=lambda ln, t: ups.append((ln, t)), reprobe_after_s=0.02,
            **EXECUTOR_CASES[case])
        rng = np.random.RandomState(11)
        outcomes, rounds = [], []
        for i in range(60):
            ms, ru = float(rng.exponential(4.0)), float(rng.uniform(1, 30))
            if i == 20 and len(ex.lanes) > 1:  # a one-lane plane has no lane to retry on
                ex.inject_fault(len(ex.lanes) - 1, count=2)
            if i % 7 == 3:
                rounds.append(ex.schedule_round(rng.exponential(2.0, 4).tolist()))
            out = ex.dispatch(lambda ms=ms, ru=ru: (i, ms, ru), occupy=i % 9 != 4)
            outcomes.append(dataclasses.asdict(out))
            clock.advance(float(rng.exponential(0.002)))
        ex.quiesce()
        return outcomes, rounds, downs, ups, ex.snapshot(), clock.now()

    ref, port = _both(run)
    assert ref == port
    if case == "replica_hedged":
        assert ref[4]["hedges"] > 0 and ref[4]["faults"] > 0


# ---------------------------------------------------------------------------
# policy: one signal sequence
# ---------------------------------------------------------------------------


def _signals(mod, n: int) -> list:
    """A load ramp up and back down, with a tiered page cache and growing
    lane busy time, as the engine's rollups would report it."""
    rng = np.random.RandomState(21)
    out, count, total, busy, hits, misses = [], 0, 0.0, 0.0, 0.0, 0.0
    for i in range(n):
        depth = int(max(0, 80 * np.sin(np.pi * i / n) + rng.randint(-4, 5)))
        served = int(rng.randint(1, 17))
        count += served
        total += served * (8.0 + 2 * depth) * float(rng.uniform(0.8, 1.2))
        busy += float(rng.uniform(0.03, 0.05))
        hits += float(rng.randint(0, 50))
        misses += float(rng.randint(0, 60 if i < n // 2 else 2))
        out.append(mod.PolicySignals(
            now_s=0.01 * i, queue_depth=depth, ingest_backlog_chunks=int(rng.randint(0, 6)),
            ingest_backlog_ops=int(rng.randint(0, 400)), slo_ms=50.0,
            stages={"queue": (count, total * 0.6), "lane": (count, total * 0.4)},
            ru_total=30.0 * count, lanes_busy_s=busy, lane_occupancy=0.5, lanes=4,
            partitions=3, tier_hits=hits, tier_misses=misses, tier_resident_frac=0.25,
            tiered=True))
    return out


@pytest.mark.parametrize("mode", ["serial", "replica"])
def test_adaptive_policy_decisions_identical(mode):
    def run(mod):
        cfg = mod.EngineConfig(max_batch=8, policy="adaptive", dispatch_mode=mode)
        pol = mod.make_policy(cfg)
        assert isinstance(pol, mod.AdaptivePolicy)
        decisions = [pol.initial()] + [pol.tick(s) for s in _signals(mod, 120)]
        pol.reset_epoch()
        decisions.append(pol.tick(_signals(mod, 1)[0]))
        return [dataclasses.asdict(d) for d in decisions], pol.decision_log

    ref, port = _both(run)
    assert ref == port
    assert len({d["beam_width"] for d in ref[0]}) > 1  # the ladder moved
    assert any(d["scale"] for d in ref[0]) and any(d["cache_step"] for d in ref[0])


def test_static_policy_identical():
    ref, port = _both(lambda mod: dataclasses.asdict(
        mod.make_policy(mod.EngineConfig(beam_width=2)).initial()))
    assert ref == port


# ---------------------------------------------------------------------------
# trace and obs: records, recorder, Prometheus text
# ---------------------------------------------------------------------------


def _drive_planes(mod):
    """Traces of every kind and status, and the registry families the engine
    writes, on a SimClock."""
    clock = mod.SimClock()
    tracer = mod.Tracer(clock, capacity=8, slo_ms=5.0)
    reg = mod.MetricsRegistry()
    rng = np.random.RandomState(9)
    for i in range(24):
        kind = ("query", "page", "ingest")[i % 3]
        tenant = f"t{i % 4}"
        status = 429 if i % 11 == 5 else 408 if i % 13 == 7 else 200
        t0 = clock.now()
        tr = tracer.begin(kind, tenant, i)
        wait, lane = float(rng.exponential(0.004)), float(rng.exponential(0.012))
        tr.span("admission", "admission", t0, t0, reserved_ru=20.0)
        tr.span("queue", "queue", t0, t0 + wait)
        if status == 200:
            ln = tr.span("lane", "lane", t0 + wait, t0 + wait + lane, lane=i % 2, ru=7.5)
            for pid in range(3):
                tr.span(f"partition[p{pid}]", "partition", t0 + wait,
                        t0 + wait + lane * rng.uniform(0.3, 1.0), parent=ln, pid=pid)
            if i % 5 == 0:
                tr.span("hedge", "hedge", t0 + wait, t0 + wait + lane, parent=ln, won=True)
            if i % 6 == 0:
                tr.span("retry[lane1]", "retry", t0 + wait, t0 + wait, parent=ln, lane=1)
            end = t0 + wait + lane
        else:
            end = t0 + wait
            tr.spans = tr.spans[:1] if status == 429 else tr.spans
            if status == 408:
                tr.span("deadline", "deadline", end, end, waited_ms=wait * 1e3)
        lat = (end - t0) * 1e3 if status != 429 else 0.0
        if status == 429:
            end = t0
        tracer.finish(tr, status=status, ru=7.5 if status == 200 else 0.0, latency_ms=lat,
                      t0_s=t0, t1_s=end)
        reg.inc("serve_requests_total", tenant=tenant, kind=kind, status=str(status))
        reg.inc("serve_ru_total", float(rng.uniform(1, 40)), tenant=tenant, op=kind)
        reg.observe("serve_latency_ms", lat, tenant=tenant)
        reg.observe("serve_stage_ms", wait * 1e3, stage="queue")
        clock.advance(float(rng.exponential(0.01)))
    win = mod.RollupWindow()
    deltas = [win.delta("q", v) for v in (3.0, 5.0, 2.0, 9.0)]
    return (tracer.recorder.records(), tracer.stats(), reg.to_prometheus_text(),
            reg.summary(), deltas)


def test_trace_records_identical_and_valid():
    ref, port = _both(_drive_planes)
    assert ref[0] == port[0] and ref[1] == port[1]
    assert len(ref[0]) > 8  # the anomaly ring kept more than the ring's capacity
    for rec in port[0]:
        tserve.validate_trace_record(rec)
        rserve.validate_trace_record(rec)
    assert {a for r in port[0] for a in r["anomalies"]} == {
        "throttle", "hedge", "slo_violation", "fault_retry", "deadline_exceeded"}


def test_registry_exposition_identical():
    ref, port = _both(_drive_planes)
    assert ref[2] == port[2] and ref[2].count("serve_requests_total{") >= 8
    assert ref[3] == port[3] and ref[4] == port[4]


# ---------------------------------------------------------------------------
# continuation tokens: the same bytes both ways
# ---------------------------------------------------------------------------

L_PAGE, BACKUP, WORDS = 12, 16, 5


def _plain_cursors(seed: int) -> list[dict]:
    """Cursor fields as numpy: one live cursor with search state, one
    exhausted with a buffer left, one exhausted and drained."""
    rng = np.random.RandomState(seed)
    out = []
    for pid, live, nbuf in ((4, True, 3), (7, False, 2), (9, False, 0)):
        d = np.sort(rng.uniform(0, 5, nbuf)).astype(np.float32)
        cur = dict(pid=pid, exhausted=not live, fetch_hwm=float(d[-1]) if nbuf else -np.inf,
                   buf_ids=rng.randint(0, 999, nbuf).astype(np.int64), buf_dists=d, state=None)
        if live:
            cur["state"] = dict(
                best_ids=rng.randint(-1, 500, L_PAGE).astype(np.int32),
                best_dists=rng.uniform(0, 9, L_PAGE).astype(np.float32),
                best_expanded=rng.rand(L_PAGE) < 0.5,
                backup_ids=rng.randint(-1, 500, BACKUP).astype(np.int32),
                backup_dists=rng.uniform(0, 9, BACKUP).astype(np.float32),
                backup_expanded=rng.rand(BACKUP) < 0.5,
                bitmap=rng.randint(0, 2**32, WORDS, dtype=np.uint64).astype(np.uint32),
                hops=np.int32(3), cmps=np.int32(77), exp=np.int32(12), dropped=np.int32(2))
        out.append(cur)
    return out


def _ref_state(cursors) -> rfan.PagedQueryState:
    curs = [rfan.PartitionPageCursor(
        pid=c["pid"], buf_ids=c["buf_ids"], buf_dists=c["buf_dists"], fetch_hwm=c["fetch_hwm"],
        exhausted=c["exhausted"],
        state=None if c["state"] is None else rpg.PageState(
            **{k: jnp.asarray(v) for k, v in c["state"].items()})) for c in cursors]
    return rfan.PagedQueryState(shard_fp=123456789, emit_hwm=1.25, pages=2, cursors=curs)


def _port_state(cursors) -> tfan.PagedQueryState:
    def tensor(k, v):
        return tgraph.bitmap_from_numpy(v) if k == "bitmap" else torch.from_numpy(np.asarray(v))

    curs = [tfan.PartitionPageCursor(
        pid=c["pid"], buf_ids=c["buf_ids"], buf_dists=c["buf_dists"], fetch_hwm=c["fetch_hwm"],
        exhausted=c["exhausted"],
        state=None if c["state"] is None else tpg.PageState(
            **{k: tensor(k, v) for k, v in c["state"].items()})) for c in cursors]
    return tfan.PagedQueryState(shard_fp=123456789, emit_hwm=1.25, pages=2, cursors=curs)


def _plain(pstate) -> tuple:
    """A PagedQueryState of either package as comparable plain data."""
    def arr(k, v):
        if isinstance(v, torch.Tensor):
            return tgraph.bitmap_to_numpy(v) if k == "bitmap" else v.numpy()
        return np.asarray(v)

    curs = []
    for c in pstate.cursors:
        st = None if c.state is None else {k: arr(k, v).tolist()
                                           for k, v in c.state._asdict().items()}
        curs.append((c.pid, c.exhausted, c.fetch_hwm, c.buf_ids.tolist(),
                     c.buf_dists.tolist(), st))
    return pstate.shard_fp, pstate.emit_hwm, pstate.pages, curs


def test_tokens_equal_bytes_both_ways():
    cursors = _plain_cursors(0)
    ref_tok = rserve.encode_continuation(_ref_state(cursors))
    port_tok = tserve.encode_continuation(_port_state(cursors))
    assert ref_tok == port_tok
    in_port = tserve.decode_continuation(ref_tok, device="cpu")
    in_ref = rserve.decode_continuation(port_tok)
    assert _plain(in_port) == _plain(in_ref) == _plain(_ref_state(cursors))
    assert tserve.encode_continuation(in_port) == rserve.encode_continuation(in_ref) == ref_tok
    st = in_port.cursors[0].state
    assert st.bitmap.dtype == torch.int64 and st.best_ids.dtype == torch.int32


def _corrupt(tok: bytes, how: str) -> bytes:
    recrc = lambda body: body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)
    if how == "flipped_byte":
        return tok[:40] + bytes([tok[40] ^ 0x55]) + tok[41:]
    if how == "truncated":
        return tok[:-9]
    if how == "bad_magic":
        return recrc(b"XPGT" + tok[4:-4])
    if how == "future_version":
        return recrc(tok[:4] + struct.pack("<H", 99) + tok[6:-4])
    if how == "trailing_bytes":
        return recrc(tok[:-4] + b"\0")
    if how == "not_bytes":
        return "CPGT"
    raise ValueError(how)


@pytest.mark.parametrize("how", ["flipped_byte", "truncated", "bad_magic", "future_version",
                                 "trailing_bytes", "not_bytes"])
def test_corrupted_token_raises_in_both(how):
    bad = _corrupt(rserve.encode_continuation(_ref_state(_plain_cursors(1))), how)
    with pytest.raises(rserve.ContinuationError):
        rserve.decode_continuation(bad)
    with pytest.raises(tserve.ContinuationError):
        tserve.decode_continuation(bad, device="cpu")


_FIELDS = {"shard_fp": np.int64(1), "emit_hwm": np.float32(0.0), "pages": np.int32(0),
           "n_parts": np.int32(1), "p0/pid": np.int32(0), "p0/exhausted": np.uint8(1),
           "p0/fetch_hwm": np.float32(3.0), "p0/buf_ids": np.arange(2, dtype=np.int64),
           "p0/buf_dists": np.array([1.0, 2.0], np.float32)}
SCHEMA_VIOLATIONS = {
    "live_cursor_without_state": {**_FIELDS, "p0/exhausted": np.uint8(0)},
    "buffer_not_ascending": {**_FIELDS, "p0/buf_dists": np.array([2.0, 1.0], np.float32)},
    "hwm_below_buffer": {**_FIELDS, "p0/fetch_hwm": np.float32(0.5)},
    "nan_emit_hwm": {**_FIELDS, "emit_hwm": np.float32(np.nan)},
    "unexpected_field": {**_FIELDS, "p0/extra": np.int32(0)},
}


@pytest.mark.parametrize("case", sorted(SCHEMA_VIOLATIONS))
def test_schema_violations_raise_in_both(case):
    """Well-formed bytes, the same in both packages, whose fields break the
    state schema."""
    tok = tserve.continuation.encode_arrays(SCHEMA_VIOLATIONS[case])
    assert tok == rserve.continuation.encode_arrays(SCHEMA_VIOLATIONS[case])
    with pytest.raises(rserve.ContinuationError):
        rserve.decode_continuation(tok)
    with pytest.raises(tserve.ContinuationError):
        tserve.decode_continuation(tok, device="cpu")


def test_well_formed_plain_token_decodes_in_both():
    tok = tserve.continuation.encode_arrays(_FIELDS)
    assert _plain(tserve.decode_continuation(tok, device="cpu")) == _plain(
        rserve.decode_continuation(tok))
