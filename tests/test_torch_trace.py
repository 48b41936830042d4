"""The port's host-clock spans (``repro_torch.spans``) on the CPU: the spans a
search, an insert and a served micro-batch record and their parent links,
the counts they carry, nothing recorded while recording is off, the same
spans on a ``torch.profiler`` timeline, and the span report's readings
(``scripts/torch_span_report.py``) on hand-built spans and profiles."""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import DiskANNIndex, GraphConfig
from repro_torch.core import search as smod
from repro_torch.serve import EngineConfig, VectorCollectionService

ROOT = Path(__file__).resolve().parents[1]
D = 32
GCFG = dict(R=16, slack=1.25, L_build=40, L_search=40, M=8, bootstrap_sample=200,
            refine_sample=10**9, batch_size=100, beam_width=4)

SEARCH = {"search.luts", "search.beam", "search.rerank", "search.answer"}
INSERT = {"insert.full_write", "insert.term_write", "insert.materialize",
          "insert.candidates", "insert.prune", "insert.edges"}


def _report():
    spec = importlib.util.spec_from_file_location(
        "torch_span_report", ROOT / "scripts" / "torch_span_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    centers = rng.randn(20, D) * 3
    x = (centers[rng.randint(0, 20, 900)] + rng.randn(900, D)).astype(np.float32)
    return x, (x[rng.choice(800, 16, replace=False)] + 0.1 * rng.randn(16, D)).astype(
        np.float32)


def _index(x):
    idx = DiskANNIndex(GraphConfig(capacity=1200, **GCFG), D, seed=0, device="cpu")
    idx.insert(list(range(800)), x[:800])
    return idx


def _children(rec, i):
    return {s.name for s in rec.spans if s.parent == i}


def test_search_and_insert_spans_and_parents(data):
    x, q = data
    idx = _index(x)
    with spans.recording() as rec:
        ids, _, st = idx.search(q, k=10)
        idx.insert(list(range(800, 900)), x[800:])
    names = [s.name for s in rec.spans]
    search, insert = names.index("index.search"), names.index("index.insert")
    assert rec.spans[search].parent == -1 and rec.spans[insert].parent == -1
    assert _children(rec, search) == SEARCH
    assert rec.spans[search].attrs["queries"] == 16
    # an insert's own beam search sits under insert.candidates, so no search
    # metric counts it
    kids = _children(rec, insert)
    assert INSERT <= kids <= INSERT | {"insert.overflow_prune"}
    cand = names.index("insert.candidates")
    beams = [s for s in rec.spans if s.name == "search.beam"]
    assert [names[b.parent] for b in beams] == ["index.search", "insert.candidates"]
    assert beams[1].parent == cand and beams[1].attrs["queries"] == 100
    # every span closed, each inside its parent, the stage its layer
    for s in rec.spans:
        assert s.t1_s >= s.t0_s and s.stage == s.name.split(".")[0]
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.t0_s <= s.t0_s and s.t1_s <= p.t1_s
    assert rec.dropped == 0 and not rec._open and not rec._marks


def test_beam_counts_its_rounds_and_syncs(data):
    x, q = data
    idx = _index(x)
    neighbors, codes, versions, live, _ = idx.pv.materialize(idx.ctx)
    luts = idx._luts(torch.from_numpy(q))
    with spans.recording() as rec:
        res = smod.batch_greedy_search(neighbors, codes, versions, live, luts, idx.medoid,
                                       L=40, beam_width=4)
    (beam,) = rec.spans
    assert beam.attrs["rounds"] == int(res.n_hops.max())
    assert beam.attrs["syncs"] == beam.attrs["rounds"] + 1  # one test a round, and the last
    # the search's calls carry the syncs of their whole call
    with spans.recording() as rec:
        idx.search(q, k=10)
    top = rec.spans[0]
    beam = next(s for s in rec.spans if s.name == "search.beam")
    assert top.attrs["syncs"] == beam.attrs["syncs"] + 1 + 5  # the tier's slots, stats, answers
    assert rec.syncs == top.attrs["syncs"]


def test_nothing_recorded_while_off(data):
    x, q = data
    idx = _index(x)
    with spans.recording() as rec:
        pass
    assert spans.ACTIVE is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.search(q, k=10)
        idx.insert([900], x[:1] + 1.0)
    assert not rec.spans and rec.syncs == 0 and spans.ACTIVE is None
    named = {"index", "search", "insert", "fanout", "engine"}
    assert not [e.name for e in prof.events() if e.name.split(".")[0] in named]


def test_spans_on_the_profiler_timeline(data):
    """Under a profiler each span has one range of its name, nested as the
    spans are, and the two clocks agree on its length."""
    x, q = data
    idx = _index(x)
    with spans.recording(), profile(activities=[ProfilerActivity.CPU]):
        idx.search(q, k=10)  # the first ranges' one-off set-up, outside the comparison
    with spans.recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.search(q, k=10)
        idx.insert(list(range(800, 900)), x[800:])
    names = {s.name for s in rec.spans}
    events = sorted((e for e in prof.events() if e.name in names
                     and e.device_type == DeviceType.CPU), key=lambda e: e.time_range.start)
    assert len(events) == len(rec.spans)
    by_name: dict = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e)
    ev_of = {}
    for i, s in enumerate(rec.spans):  # the k-th span of a name is its k-th range
        ev_of[i] = by_name[s.name][sum(t.name == s.name for t in rec.spans[:i])]
    for i, s in enumerate(rec.spans):
        e = ev_of[i]
        us = e.time_range.end - e.time_range.start
        assert abs(us - s.dur_ms * 1e3) <= max(0.1 * us, 50.0), (s.name, us, s.dur_ms)
        if s.parent >= 0:
            p = ev_of[s.parent]
            assert p.time_range.start <= e.time_range.start
            assert e.time_range.end <= p.time_range.end
            # no other span's range lies between the two
            mid = [o for o in ev_of.values() if o is not p and o is not e
                   and p.time_range.start <= o.time_range.start <= e.time_range.start
                   and e.time_range.end <= o.time_range.end <= p.time_range.end]
            assert not mid, (s.name, [o.name for o in mid])


def test_served_micro_batches_record_queue_batch_and_fanout(data):
    x, q = data
    g = GraphConfig(capacity=1200, **dict(GCFG, bootstrap_sample=64))
    svc = VectorCollectionService(
        dim=D, graph=g, max_vectors_per_partition=700, initial_partitions=4,
        engine_cfg=EngineConfig(max_batch=8, dispatch_mode="spmd", ingest_chunk=400),
        device="cpu")
    svc.upsert([{"id": i} for i in range(800)], x[:800],
               partition_keys=[f"pk{i % 64}" for i in range(800)])
    eng = svc.engine
    with spans.recording() as rec:
        rids = [eng.submit_query(v, k=10) for v in q]
        eng.drain()
    assert all(eng.pop_response(r).status == 200 for r in rids)
    by = lambda n: [s for s in rec.spans if s.name == n]
    queued, batches, fans = by("engine.queue"), by("engine.batch"), by("fanout.search")
    assert sorted(s.attrs["rid"] for s in queued) == rids
    assert len(batches) == len(fans) == 2 and [b.attrs["queries"] for b in batches] == [8, 8]
    ib = [rec.spans.index(b) for b in batches]
    assert [f.parent for f in fans] == ib
    assert {f.attrs["partitions"] for f in fans} == {4}
    assert all(f.attrs["syncs"] > 0 for f in fans)
    # a query waits from its submission until its micro-batch starts
    first = batches[0].t0_s
    assert sum(s.t1_s <= first for s in queued) == 8
    assert all(s.t1_s <= batches[1].t0_s for s in queued)
    assert {s.name for s in rec.spans if s.parent in ib} == {"fanout.search"}
    fan = rec.spans.index(fans[0])
    assert {"fanout.stack", "search.beam", "fanout.rerank", "fanout.meter",
            "fanout.merge"} == _children(rec, fan)


def test_an_exception_closes_what_it_left_open():
    rec = spans.Recorder(capacity=3)
    a = rec.begin("index.search")
    rec.begin("search.beam")
    rec.syncs += 2
    rec.end(a, syncs=rec.syncs_since(a))
    assert not rec._open and all(s.t1_s >= s.t0_s for s in rec.spans)
    assert rec.spans[0].attrs["syncs"] == 2 and rec.spans[1].t1_s == rec.spans[0].t1_s
    b = rec.begin("index.search")
    assert rec.spans[b].parent == -1
    assert rec.begin("index.search") == -1 and rec.dropped == 1  # full
    rec.end(-1)


# ---------------------------------------------------------------------------
# the span report's readings
# ---------------------------------------------------------------------------


def _span(name, t0, t1, parent=-1, **attrs):
    return spans.Span(name, name.split(".")[0], t0, t1, parent, attrs)


def test_layer_metrics_and_self_time_by_hand():
    rep = _report()
    ss = [
        _span("engine.queue", 0.0, 0.3, rid=0),
        _span("engine.queue", 0.1, 0.2, rid=1),
        _span("engine.batch", 0.3, 0.4, queries=2),
        _span("fanout.search", 0.31, 0.39, 2, queries=2, syncs=10),
        _span("search.beam", 0.32, 0.36, 3, syncs=8, rounds=7),
        _span("index.search", 0.33, 0.34, 3, queries=2, syncs=3),  # the host fallback
        _span("index.insert", 1.0, 1.2, docs=100),
        _span("insert.candidates", 1.0, 1.1, 6),
        _span("search.beam", 1.0, 1.1, 7, syncs=40, rounds=39),
        _span("insert.edges", 1.1, 1.15, 6),
        _span("insert.overflow_prune", 1.15, 1.17, 6),
    ]
    m = rep.layer_metrics(ss, list(range(len(ss))))
    assert m["engine.queue_ms"] == pytest.approx(200.0)
    assert m["engine.self_ms_per_batch"] == pytest.approx(20.0)  # 100 ms less the fan-out's 80
    assert m["search.beam_ms_per_call"] == pytest.approx(40.0)  # not the insert's beam
    assert m["search.syncs_per_query"] == pytest.approx(5.0)  # the outer call's alone
    assert m["insert.edges_ms_per_batch"] == pytest.approx(70.0)
    own = rep.self_s(ss)
    assert own[3] == pytest.approx(0.08 - 0.04)  # the beam and the fallback overlap
    assert own[0] == pytest.approx(0.3)  # a queue holds no child
    # nothing to read: None, never 0
    none = rep.layer_metrics(ss, [])
    assert set(none.values()) == {None}
    assert rep.by_name(ss, [2, 3])["engine.batch"] == [1, pytest.approx(100.0),
                                                       pytest.approx(20.0)]


def _ev(name, start, end, dev=False, user=False):
    return types.SimpleNamespace(name=name, is_user_annotation=user,
                                 device_type=DeviceType.CUDA if dev else DeviceType.CPU,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_idle_by_span_on_synthetic_events():
    rep = _report()
    mark = "vbench.traced"
    events = [
        _ev(mark, 0, 1000, user=True),
        _ev("index.search", 100, 900, user=True),
        _ev("search.beam", 200, 600, user=True),
        _ev("engine.queue", 0, 1000, user=True),  # waits: holds no gap
        _ev("aten::item", 300, 500),  # an operator: not a program span
        _ev("adc_staged_kernel", 50, 250, dev=True),
        _ev("topk_bitonic_kernel", 400, 450, dev=True),
        _ev("index.search", 120, 880, dev=True, user=True),  # a range's device side
        _ev("late_kernel", 950, 1100, dev=True),
    ]
    prof = types.SimpleNamespace(events=lambda: events)
    r = rep.idle_by_span(prof, mark)
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx((200 + 50 + 50) / 1e6)
    idle = r["idle_by_span"]
    # gaps 0-50 (mid 25: outside), 250-400 (mid 325: the beam), 450-950
    # (mid 700: index.search)
    assert idle == {rep.OUTSIDE: pytest.approx(50e-6), "search.beam": pytest.approx(150e-6),
                    "index.search": pytest.approx(500e-6)}
    assert r["idle_s"] == pytest.approx(r["window_s"] - r["busy_s"])
