"""The port's vector service and serving engine against the JAX reference, on
the CPU.

A reference ``VectorCollectionService`` of three partitions, sharded by
tenant, is carried into the port with
``VectorCollectionService.from_reference_state``. Both then serve the same
requests through fresh engines of the same configuration. Held as the
fan-out is held in ``test_torch_fanout.py``: ids equal in 99 % of the
(query, rank) slots, recall within 0.01, RU and the modelled latency within
1 %. Statuses (200, 408, 429), plans, ``complete`` and the degraded marker
are equal exactly. The port's spmd mode is held bit for bit against its own
serial mode, and its launch-signature counters move where the reference's
compiled-signature counters do."""
from collections import Counter

import numpy as np
import pytest
import torch

import repro.core.flat as ref_flat
import repro.serve as rserve
import repro_torch.core.flat as port_flat
import repro_torch.serve as tserve
from conftest import clustered_data
from repro.core import GraphConfig as RefGraphConfig
from repro.core import recall as rrec
from repro.partition.fanout import spmd_jit_cache_size as ref_spmd_count
from repro.serve.vector_engine import serving_jit_cache_size as ref_count
from repro_torch.core import GraphConfig
from repro_torch.partition import CollectionConfig
from repro_torch.partition.fanout import spmd_jit_cache_size as port_spmd_count
from repro_torch.serve.vector_engine import serving_jit_cache_size as port_count

N, D, K = 1200, 24, 5
GKW = dict(capacity=1500, R=16, M=8, L_build=40, L_search=48, bootstrap_sample=128,
           refine_sample=10**9, batch_size=64)
SKW = dict(max_vectors_per_partition=1400, initial_partitions=3, shard_key_path="tenant")
SAME_SLOTS, RECALL_TOL, RU_REL = 0.99, 0.01, 0.01


def _doc(i: int) -> dict:
    return {"id": i, "tenant": f"t{i % 4}", "category": i % 7}


def _collection_state(col) -> dict:
    """The plain state (arrays, bytes, dicts) of a reference collection."""
    parts = []
    for p in col.partitions:
        snap = {k: ([np.asarray(c) for c in v] if k == "schemas" else
                    np.asarray(v) if hasattr(v, "shape") else v)
                for k, v in p.index.snapshot().items()}
        parts.append(dict(lo=p.lo, hi=p.hi, pid=p.pid, index=snap,
                          snapshot=p.providers.snapshot_bytes(), wal=p.providers.wal_bytes(),
                          doc_pk=dict(p.doc_pk), doc_props=dict(p.doc_props)))
    return dict(partitions=parts, next_pid=col._next_pid, splits=col.splits,
                merges=col.merges)


@pytest.fixture(scope="module")
def pair():
    data = clustered_data(np.random.RandomState(42), N, D)
    ref = rserve.VectorCollectionService(dim=D, graph=RefGraphConfig(**GKW), **SKW)
    ref.upsert([_doc(i) for i in range(N)], data)
    state = _collection_state(ref.collection)
    state["tenants"] = {key: _collection_state(c) for key, c in ref._tenant_collections.items()}
    port = tserve.VectorCollectionService.from_reference_state(
        state, ref.docs, CollectionConfig(dim=D, graph=GraphConfig(**GKW), **SKW), device="cpu")
    pick = np.random.RandomState(5).choice(N, 16, replace=False)
    q = (data[pick] + 0.05 * np.random.RandomState(6).randn(16, D)).astype(np.float32)
    return ref, port, data, q


def _fresh_engines(pair, **cfg) -> dict:
    """A fresh engine of one configuration on each service (same clock
    origin, no tenant history), as ``VectorServeEngine`` is built in the
    reference's own engine tests."""
    ref, port, _, _ = pair
    out = {}
    for name, pkg, svc in (("reference", rserve, ref), ("port", tserve, port)):
        svc.engine = pkg.VectorServeEngine(svc.collection, cfg=pkg.EngineConfig(**cfg),
                                           resolver=svc._partitions_for,
                                           replica_sets=svc.replica_sets)
        out[name] = svc.engine
    return out


def _held(got, want, truth, k=K):
    same = float((got == want).mean())
    assert same >= SAME_SLOTS, f"ids equal in {same:.4f} of slots"
    r_got, r_want = rrec.recall_at_k(got, truth, k), rrec.recall_at_k(want, truth, k)
    assert abs(r_got - r_want) <= RECALL_TOL, (r_got, r_want)


def _close(got, want):
    assert np.allclose(got, want, rtol=RU_REL, atol=0), (got, want)


def _match(data_mask_fn) -> np.ndarray:
    return np.array([data_mask_fn(_doc(i)) for i in range(N)])


@pytest.fixture
def low_thresholds(monkeypatch):
    """Planner thresholds scaled to partitions of ~400 documents, so a ~14 %
    predicate takes Q-Flat and a ~86 % one beta (as in test_torch_fanout)."""
    for mod in (ref_flat, port_flat):
        monkeypatch.setattr(mod, "BRUTE_FORCE_MAX_DOCS", 100)
        monkeypatch.setattr(mod, "QFLAT_MAX_MATCHES", 100)


# ---------------------------------------------------------------------------
# svc.query: each plan
# ---------------------------------------------------------------------------

QUERY_CASES = {
    # name: (VectorQuery kwargs of each package, documents it may return, plan)
    "graph": (lambda P: {}, lambda d: True, "graph"),
    "exact": (lambda P: dict(exact=True), lambda d: True, "exact"),
    "filtered_eq": (lambda P: dict(filter=P.F.eq("category", 3)),
                    lambda d: d["category"] == 3, "filtered-batched[qflat×3]"),
    "filtered_in": (lambda P: dict(filter=P.F.in_("category", [0, 1, 2, 4, 5, 6])),
                    lambda d: d["category"] != 3, "filtered-batched[beta×3]"),
    "exact_filtered": (lambda P: dict(exact=True, filter=P.F.eq("category", 3)),
                       lambda d: d["category"] == 3, "exact-filtered"),
    "tenant": (lambda P: dict(shard_key="t1"), lambda d: d["tenant"] == "t1", "graph"),
}


@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_query_matches_reference(pair, case, low_thresholds):
    _, _, data, q = pair
    kwargs, allowed, plan = QUERY_CASES[case]
    engines = _fresh_engines(pair)
    got = {}
    for name, pkg, svc in (("reference", rserve, pair[0]), ("port", tserve, pair[1])):
        res = [svc.query(pkg.VectorQuery(vector=qi, k=K, **kwargs(pkg))) for qi in q]
        got[name] = res
        assert engines[name].metrics.queries_ok == len(q)
    want, port = got["reference"], got["port"]
    assert [r.plan for r in port] == [r.plan for r in want] == [plan] * len(q)
    assert all(r.complete for r in port + want)
    match = _match(allowed)
    truth = rrec.ground_truth(q, data, match, K)
    ids = np.stack([r.ids for r in port])
    _held(ids, np.stack([r.ids for r in want]), truth)
    assert match[ids[ids >= 0]].all()
    if case.startswith("exact"):
        assert [set(r) for r in ids] == [set(t) for t in truth]
    _close([r.ru for r in port], [r.ru for r in want])
    _close([r.latency_ms for r in port], [r.latency_ms for r in want])


def test_exact_plan_reads_the_device_mirror(pair, monkeypatch):
    """The exact scan reads each partition's mirror (``materialize``): the
    mirror's storage is the same before and after, and nothing of a
    partition's size goes to the device per call (only the queries)."""
    _, port, data, q = pair
    parts = port.collection.partitions
    ptrs = lambda: [p.providers.materialize(p.index.ctx)[4].data_ptr() for p in parts]
    before = ptrs()
    uploads, reads = [], []
    for p in parts:
        to_device, mirror = p.index._t, p.providers.materialize
        monkeypatch.setattr(p.index, "_t", lambda a, f=to_device: uploads.append(
            np.shape(a)) or f(a))
        monkeypatch.setattr(p.providers, "materialize", lambda ctx=None, f=mirror: reads.append(
            1) or f(ctx))
    for qi in q[:4]:
        res = port.query(tserve.VectorQuery(vector=qi, k=K, exact=True))
        assert res.plan == "exact"
    assert len(reads) == 4 * len(parts)
    assert set(uploads) == {(1, D)}, uploads  # bucket 1 of queries, per partition
    monkeypatch.undo()
    assert ptrs() == before


# ---------------------------------------------------------------------------
# micro-batched serving: each dispatch plane
# ---------------------------------------------------------------------------

MODES = {
    "serial": dict(dispatch_mode="serial"),
    "replica_hedged": dict(dispatch_mode="replica", lanes=4, hedge_at_ms=2.0,
                           straggler_p=0.3, straggler_factor=4.0, dispatch_seed=3),
    "spmd": dict(dispatch_mode="spmd"),
}


def _serve(engine, q, arrivals, k=K, **kw) -> list:
    rids = [engine.submit_query(qi, k=k, arrival_s=float(t), **kw)
            for qi, t in zip(q, arrivals)]
    engine.drain()
    return [engine.pop_response(r) for r in rids]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_microbatched_matches_reference(pair, mode):
    _, _, data, q = pair
    qs = np.concatenate([q, q[::-1] + 0.01]).astype(np.float32)
    arrivals = rserve.poisson_arrivals(np.random.RandomState(8), len(qs), 2000.0)
    engines = _fresh_engines(pair, max_batch=8, **MODES[mode])
    got = {name: _serve(eng, qs, arrivals) for name, eng in engines.items()}
    want, port = got["reference"], got["port"]
    for field in ("status", "plan", "complete", "batch_size"):
        assert [getattr(r, field) for r in port] == [getattr(r, field) for r in want], field
    assert {r.plan for r in port} == {"graph-spmd" if mode == "spmd" else "graph"}
    truth = rrec.ground_truth(qs, data, np.ones(N, bool), K)
    _held(np.stack([r.ids for r in port]), np.stack([r.ids for r in want]), truth)
    _close([r.ru for r in port], [r.ru for r in want])
    _close([r.latency_ms for r in port], [r.latency_ms for r in want])
    snaps = {name: eng.snapshot() for name, eng in engines.items()}
    for key in ("queries_ok", "batches", "queries_throttled"):
        assert snaps["port"][key] == snaps["reference"][key], key
    if mode == "replica_hedged":
        assert snaps["port"]["dispatch"]["hedges"] == snaps["reference"]["dispatch"]["hedges"] > 0


def test_port_spmd_bit_equal_to_serial(pair):
    """The stacked plane against the port's serial one: the same ids and
    dists bit for bit, RU and modelled latency equal, the plan but for its
    suffix."""
    _, port, _, q = pair
    arrivals = rserve.poisson_arrivals(np.random.RandomState(9), len(q), 1500.0)
    out = {}
    for mode in ("serial", "spmd"):
        eng = tserve.VectorServeEngine(port.collection, cfg=tserve.EngineConfig(
            max_batch=8, dispatch_mode=mode), resolver=port._partitions_for)
        out[mode] = _serve(eng, q, arrivals)
    for a, b in zip(out["serial"], out["spmd"]):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists.view(np.int32), b.dists.view(np.int32))
        assert (a.ru, a.latency_ms, a.plan, a.status) == (
            b.ru, b.latency_ms, b.plan.removesuffix("-spmd"), b.status)


# ---------------------------------------------------------------------------
# governance and faults: statuses, plans and markers equal exactly
# ---------------------------------------------------------------------------


def _statuses(svc, pkg, engine, q) -> list:
    out = []
    engine.set_tenant_budget("poor", 0.5 * engine.cfg.admission_estimate_ru)
    rid = engine.next_rid()
    resp = engine.submit(pkg.ServeRequest(rid=rid, vector=q[0], k=K, tenant="poor"))
    out.append((resp.status, resp.retry_after_s))
    with pytest.raises(pkg.Throttled):
        svc.query(pkg.VectorQuery(vector=q[0], k=K, tenant="poor"))
    rid = engine.submit_query(q[1], k=K, deadline_ms=0.0)
    engine.drain()
    out.append((engine.pop_response(rid).status,))
    with pytest.raises(pkg.DeadlineExceeded):
        svc.query(pkg.VectorQuery(vector=q[1], k=K, deadline_ms=0.0))
    victim = svc.replica_sets[1]
    try:
        for rep in victim.replicas:
            rep.alive = False
        res = svc.query(pkg.VectorQuery(vector=q[2], k=K))
        exact = svc.query(pkg.VectorQuery(vector=q[2], k=K, exact=True))
    finally:
        for rep in victim.replicas:
            rep.alive = True
    out.append((res.plan, res.complete, exact.plan, exact.complete))
    snap = engine.snapshot()
    out.append((snap["queries_throttled"], snap["queries_deadline"], snap["queries_degraded"]))
    return out, res.ids


def test_statuses_plans_and_markers_equal(pair):
    ref, port, _, q = pair
    engines = _fresh_engines(pair)
    want, want_ids = _statuses(ref, rserve, engines["reference"], q)
    got, got_ids = _statuses(port, tserve, engines["port"], q)
    assert got == want
    assert got[0][0] == 429 and got[1] == (408,)
    pid = ref.collection.partitions[1].pid
    assert got[2] == (f"graph+degraded[{pid}]", False, f"exact+degraded[{pid}]", False)
    assert float((got_ids == want_ids).mean()) >= 0.8  # k=5 slots of one query


# ---------------------------------------------------------------------------
# pagination through the service: 5 pages, tokens through bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("filtered", [False, True], ids=["plain", "filtered"])
def test_query_page_matches_reference(pair, filtered):
    ref, port, data, q = pair
    _fresh_engines(pair)
    pages = {}
    for name, pkg, svc in (("reference", rserve, ref), ("port", tserve, port)):
        pages[name] = []
        for qi in q[:3]:
            vq = pkg.VectorQuery(vector=qi, filter=pkg.F.eq("category", 3) if filtered else None)
            tok, seen = None, []
            for _ in range(5):
                res = svc.query_page(vq, continuation=tok, page_size=10)
                assert res.plan == ("paginated-filtered" if filtered else "paginated")
                assert res.continuation is not None
                tok = bytes(res.continuation)
                got = res.ids[res.ids >= 0].tolist()
                assert not set(got) & set(seen), "a page repeated a result"
                seen += got
                pages[name].append((res.ids, res.ru))
    got_ids = np.stack([p[0] for p in pages["port"]])
    want_ids = np.stack([p[0] for p in pages["reference"]])
    assert float((got_ids == want_ids).mean()) >= SAME_SLOTS
    _close([p[1] for p in pages["port"]], [p[1] for p in pages["reference"]])
    if filtered:
        assert all(_doc(int(i))["category"] == 3 for i in got_ids[got_ids >= 0])


def test_port_token_resumes_and_mismatch_raises(pair):
    """A port token decodes onto the CPU (the service's device) and resumes;
    the reference decodes the same bytes; a token used under another shard
    key raises ``ContinuationError``."""
    _, port, _, q = pair
    first = port.query_page(tserve.VectorQuery(vector=q[0]), page_size=10)
    state = tserve.decode_continuation(first.continuation, device="cpu")
    assert all(c.state is None or c.state.best_ids.device.type == "cpu" for c in state.cursors)
    assert rserve.encode_continuation(rserve.decode_continuation(first.continuation)) \
        == first.continuation
    nxt = port.query_page(tserve.VectorQuery(vector=q[0]), continuation=first.continuation,
                          page_size=10)
    assert not set(nxt.ids.tolist()) & set(first.ids.tolist())
    with pytest.raises(tserve.ContinuationError):
        port.query_page(tserve.VectorQuery(vector=q[0], shard_key="t2"),
                        continuation=first.continuation)


def test_decode_continuation_needs_a_card_unless_asked(pair, monkeypatch):
    _, port, _, q = pair
    tok = port.query_page(tserve.VectorQuery(vector=q[0]), page_size=10).continuation
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.decode_continuation(tok)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.VectorCollectionService(dim=D, graph=GraphConfig(**GKW))
    st = tserve.decode_continuation(tok, device="cpu")
    assert {c.state.bitmap.device.type for c in st.cursors if c.state is not None} == {"cpu"}


# ---------------------------------------------------------------------------
# signature counters: where the reference's compiled-signature count moves
# ---------------------------------------------------------------------------


def _deltas(traj: list) -> list:
    return [t - traj[0] for t in traj]


def test_signatures_flat_in_steady_state(pair):
    """Batch sizes that vary within one bucket mint no new signature (the
    reference's ``test_bucketing_zero_recompiles_steady_state``)."""
    _, _, data, _ = pair
    engines = _fresh_engines(pair, max_batch=16)
    sizes = [16, 9, 12, 16, 10, 13, 15, 11]
    for name, eng in engines.items():
        rng = np.random.RandomState(11)
        for B in sizes:
            for qi in data[rng.choice(N, B, replace=False)]:
                eng.submit_query(qi + 0.01, k=7)
            eng.drain()
    traj = {name: eng.metrics.jit_cache_trajectory for name, eng in engines.items()}
    assert len(traj["port"]) == len(sizes)
    assert _deltas(traj["port"]) == _deltas(traj["reference"]) == [0] * len(sizes)
    assert engines["port"].metrics.recompiles_since(0) == 0


def test_new_bucket_adds_signatures_like_reference(pair):
    """A fresh (bucket, L) signature moves the count once, as far as the
    reference's moves; the same bucket again does not (the reference's
    ``test_cross_bucket_batch_compiles_once_each``)."""
    _, _, data, _ = pair
    engines = _fresh_engines(pair, max_batch=4)
    counts = {}
    for name, eng in engines.items():
        count = ref_count if name == "reference" else port_count
        base = count()
        for qi in data[:3]:
            eng.submit_query(qi, k=9)
        eng.drain()
        first = count()
        for qi in data[:4]:
            eng.submit_query(qi + 0.02, k=9)
        eng.drain()
        counts[name] = (first - base, count() - first)
    assert counts["port"] == counts["reference"]
    assert counts["port"][0] > 0 and counts["port"][1] == 0


def test_spmd_signatures_like_reference(pair):
    """The stacked plane: one signature per bucket, flat in steady state
    (the reference's ``test_spmd_zero_recompiles_steady_state``)."""
    _, _, data, _ = pair
    engines = _fresh_engines(pair, dispatch_mode="spmd", max_batch=8)
    steps = {}
    for name, eng in engines.items():
        spmd = ref_spmd_count if name == "reference" else port_spmd_count
        rng = np.random.RandomState(31)
        marks = [spmd()]
        for B in (8, 8, 8, 8, 5, 1, 1):
            _serve(eng, data[rng.choice(N, B, replace=False)] + 0.01, np.zeros(B), k=6)
            marks.append(spmd())
        steps[name] = (np.diff(marks).tolist(), _deltas(eng.metrics.jit_cache_trajectory))
    assert steps["port"] == steps["reference"]
    assert steps["port"][0] == [1, 0, 0, 0, 0, 1, 0]


def test_beam_width_signatures_flat_after_warmup(pair):
    """A W=4 engine warmed on one signature stays flat (the reference's
    ``test_engine_beamwidth_config_recall``), and serves results held to
    the reference's."""
    _, _, data, _ = pair
    qs = data[np.random.RandomState(17).choice(N, 16, replace=False)] + 0.01
    engines = _fresh_engines(pair, max_batch=16, beam_width=4)
    ids = {}
    for name, eng in engines.items():
        _serve(eng, qs, np.zeros(len(qs)), k=4)
        cache0 = eng.metrics.jit_cache_trajectory[-1]
        resps = _serve(eng, qs, np.zeros(len(qs)), k=4)
        assert eng.metrics.jit_cache_trajectory[-1] == cache0, "a new signature"
        ids[name] = np.stack([r.ids for r in resps])
    truth = rrec.ground_truth(qs, data, np.ones(N, bool), 4)
    _held(ids["port"], ids["reference"], truth, k=4)


# ---------------------------------------------------------------------------
# ingest through the engine (the port alone: it changes the state)
# ---------------------------------------------------------------------------


def test_interleaved_ingest_on_a_carried_copy(pair):
    ref, port, data, q = pair
    state = _collection_state(ref.collection)
    state["tenants"] = {key: _collection_state(c) for key, c in ref._tenant_collections.items()}
    svc = tserve.VectorCollectionService.from_reference_state(
        state, ref.docs, port.cfg, engine_cfg=tserve.EngineConfig(ingest_chunk=16),
        device="cpu")
    new = (data[:40] + 0.5).astype(np.float32)
    tally = svc.upsert_async([_doc(N + i) for i in range(40)], new)
    rids = [svc.engine.submit_query(qi, k=K) for qi in q]
    svc.engine.drain()
    assert svc.engine.ingest_backlog == 0 and tally.value > 0
    assert all(svc.engine.pop_response(r).status == 200 for r in rids)
    assert svc.engine.metrics.ingest_ops == 40
    assert svc.query(tserve.VectorQuery(vector=new[3], k=K)).ids[0] == N + 3
    assert svc.query(tserve.VectorQuery(vector=new[5], k=K, shard_key=_doc(N + 5)["tenant"])
                     ).ids[0] == N + 5


# ---------------------------------------------------------------------------
# writes through the service on both packages (last: it changes both states)
# ---------------------------------------------------------------------------


def test_delete_and_tenant_move_match_reference(pair):
    """Deletes and a re-upsert under another tenant (the document moves:
    its old tenant's copy is tombstoned) through both services: the RU
    billed, the documents left, and the answers after."""
    ref, port, data, q = pair
    _fresh_engines(pair)
    gone = [int(i) for i in np.random.RandomState(12).choice(N, 30, replace=False)]
    mover = next(i for i in range(N) if i not in gone and _doc(i)["tenant"] == "t1")
    moved = dict(_doc(mover), tenant="t2")
    got = {}
    for name, pkg, svc in (("reference", rserve, ref), ("port", tserve, port)):
        ru_del = svc.delete(gone)
        ru_up = svc.upsert([moved], data[mover:mover + 1])
        res = [svc.query(pkg.VectorQuery(vector=data[i] + 0.01, k=K, **kw))
               for i in gone[:8] + [mover] for kw in ({}, dict(shard_key="t1"),
                                                       dict(shard_key="t2"))]
        got[name] = (ru_del, ru_up, res, svc.collection.num_docs,
                     {key: c.num_docs for key, c in svc._tenant_collections.items()})
    want, port_got = got["reference"], got["port"]
    _close(port_got[:2], want[:2])
    tenants = Counter(_doc(i)["tenant"] for i in range(N) if i not in gone)
    tenants.update({"t1": -1, "t2": 1})  # the mover
    assert port_got[3:] == want[3:] == (N - len(gone), dict(tenants))
    ids = np.stack([r.ids for r in port_got[2]])
    assert not set(ids.ravel().tolist()) & set(gone), "a deleted document was returned"
    assert float((ids == np.stack([r.ids for r in want[2]])).mean()) >= SAME_SLOTS
    found = {(i, kw): r.ids.tolist() for (i, kw), r in zip(
        [(i, kw) for i in gone[:8] + [mover] for kw in ("all", "t1", "t2")], port_got[2])}
    assert mover in found[(mover, "all")] and mover in found[(mover, "t2")]
    assert mover not in found[(mover, "t1")]
