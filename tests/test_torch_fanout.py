"""The port's cross-partition fan-out against the JAX reference, on the CPU.

A reference collection of three partitions (one past its ``refine_sample``,
so V=2 beside V=1) is carried across into the port through
``Collection.from_reference_state``; the serial, hedged, filtered and paged
fan-outs then run on both, held as a single index is held in
``test_torch_index.py``: ids equal in 99 % of the (query, rank) slots,
recall within 0.01, RU within 1 %. The port's stacked paths (``SpmdFanout``,
``distributed_search_fn``) are held bit for bit against the port's own
serial composition."""
import numpy as np
import pytest
import torch

import repro.core.flat as ref_flat
import repro_torch.core.flat as port_flat
from conftest import clustered_data
from repro.core import GraphConfig as RefGraphConfig
from repro.core import recall as rrec
from repro.partition import Collection as RefCollection
from repro.partition import CollectionConfig as RefCollectionConfig
from repro.partition import fanout as rfan
from repro.serve import predicate as rpred
from repro_torch.core import GraphConfig
from repro_torch.core import pq as tpq
from repro_torch.core import search as tsearch
from repro_torch.kernels.topk_select.ops import topk_select
from repro_torch.partition import Collection, CollectionConfig, PhysicalPartition, SpmdFanout
from repro_torch.partition import fanout as tfan
from repro_torch.serve import predicate as tpred

N, D, K = 900, 16, 10
GKW = dict(capacity=480, R=16, M=8, L_build=32, L_search=48, bootstrap_sample=64,
           refine_sample=300, batch_size=40)
CKW = dict(dim=D, max_vectors_per_partition=450, initial_partitions=3)
SAME_SLOTS, RECALL_TOL, RU_REL = 0.99, 0.01, 0.01
KEYS = [f"pk{i % 37}" for i in range(N)]


def _items(i):
    return {"cat": i % 10, "tier": i % 3, "key": KEYS[i]}


def _reference_state(col) -> dict:
    """The plain state (arrays, bytes, dicts) of a collection."""
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
    data = clustered_data(np.random.RandomState(0), N, D)
    ref = RefCollection(RefCollectionConfig(graph=RefGraphConfig(**GKW), **CKW))
    ref.insert(list(range(N)), KEYS, data,
               props=[rpred.property_items(_items(i)) for i in range(N)])
    assert sorted(len(p.index.schemas) for p in ref.partitions) == [1, 1, 2]
    port = Collection.from_reference_state(CollectionConfig(graph=GraphConfig(**GKW), **CKW),
                                           _reference_state(ref), device="cpu")
    pick = np.random.RandomState(5).choice(N, 32, replace=False)
    q = (data[pick] + 0.05 * np.random.RandomState(6).randn(32, D)).astype(np.float32)
    return ref, port, data, q


def _held(got, want, truth, k=K):
    same = float((got == want).mean())
    assert same >= SAME_SLOTS, f"ids equal in {same:.4f} of slots"
    r_got, r_want = rrec.recall_at_k(got, truth, k), rrec.recall_at_k(want, truth, k)
    assert abs(r_got - r_want) <= RECALL_TOL, (r_got, r_want)


def _ru_close(got, want):
    assert np.allclose(got, want, rtol=RU_REL, atol=0), (got, want)


def test_batched_fanout_matches_reference(pair):
    ref, port, data, q = pair
    want = rfan.batched_fanout_search(ref.partitions, q, K)
    got = tfan.batched_fanout_search(port.partitions, q, K)
    _held(got[0], want[0], rrec.ground_truth(q, data, np.ones(N, bool), K))
    ok = got[0] >= 0
    np.testing.assert_allclose(got[1][ok], want[1][ok], rtol=1e-4, atol=1e-4)
    _ru_close(got[2]["ru_per_partition"], want[2]["ru_per_partition"])
    assert got[2]["partition_ids"] == want[2]["partition_ids"] and got[2]["complete"]
    for g, w in zip(got[2]["stats_per_partition"], want[2]["stats_per_partition"]):
        assert abs(g.hops - w.hops) <= 0.5 and g.plan == w.plan == "graph"
    assert got[2]["service_latency_ms"] == pytest.approx(want[2]["service_latency_ms"], rel=RU_REL)


def test_hedged_fanout_matches_reference(pair):
    """The seeded log-normal latency model draws the same latencies in both,
    so the same partitions hedge; each hedge bills its duplicate's RU."""
    ref, port, data, q = pair
    slow = lambda p, rr: float(np.exp(rr.normal(np.log(10), 1.0)))
    want = rfan.fanout_search(ref.partitions, q[:4], K, latency_model=slow, hedge_at_ms=12.0,
                              rng=np.random.RandomState(3))
    got = tfan.fanout_search(port.partitions, q[:4], K, latency_model=slow, hedge_at_ms=12.0,
                             rng=np.random.RandomState(3))
    assert got[2]["hedges"] == want[2]["hedges"] >= 1
    assert got[2]["server_latencies_ms"] == want[2]["server_latencies_ms"]
    assert got[2]["client_latency_ms"] == want[2]["client_latency_ms"]
    _ru_close(got[2]["hedge_ru"], want[2]["hedge_ru"])
    _ru_close(got[2]["ru_total"], want[2]["ru_total"])
    _held(got[0], want[0], rrec.ground_truth(q[:4], data, np.ones(N, bool), K))


# predicates by the plan they exercise, at thresholds scaled to partitions of
# a few hundred documents: brute force up to 100 live documents, Q-Flat under
# 100 matches
PREDICATES = {
    "qflat": lambda P: P.F.eq("cat", 3),  # ~10 %
    "beta": lambda P: P.F.in_("cat", [0, 1, 2, 4, 5, 6]),  # ~60 %
    "one_partition": lambda P: P.F.eq("key", KEYS[4]),  # the others match nothing
}


@pytest.mark.parametrize("case", sorted(PREDICATES))
def test_filtered_fanout_matches_reference(pair, case, monkeypatch):
    ref, port, data, q = pair
    for mod in (ref_flat, port_flat):
        monkeypatch.setattr(mod, "BRUTE_FORCE_MAX_DOCS", 100)
        monkeypatch.setattr(mod, "QFLAT_MAX_MATCHES", 100)
    want = rfan.batched_filtered_fanout_search(ref.partitions, q, K, PREDICATES[case](rpred))
    got = tfan.batched_filtered_fanout_search(port.partitions, q, K, PREDICATES[case](tpred))
    assert got[2]["plan"] == want[2]["plan"]
    assert got[2]["plan"] == {"qflat": "filtered-batched[qflat×3]",
                              "beta": "filtered-batched[beta×3]",
                              "one_partition": "filtered-batched[qflat×1]"}[case]
    assert got[2]["compile_ru"] == want[2]["compile_ru"]
    assert (got[2]["compile_ru"] > 0) == (case == "one_partition")
    assert got[2]["partition_ids"] == want[2]["partition_ids"]
    _ru_close(got[2]["ru_per_partition"], want[2]["ru_per_partition"])
    match = np.zeros(N, bool)
    for p in port.partitions:
        for d, items in p.doc_props.items():
            match[d] = PREDICATES[case](tpred).matches(dict(items))
    _held(got[0], want[0], rrec.ground_truth(q, data, match, K))
    assert match[got[0][got[0] >= 0]].all()


def test_paged_fanout_matches_reference(pair):
    """Five merged pages of 10 for four queries: the same stream as the
    reference's, disjoint pages, the emitted high-water mark ascending
    across pages (a later page can hold a smaller exact distance: each
    partition's stream ascends in quantized space, and the rerank moves
    it)."""
    ref, port, data, q = pair
    got_all, want_all = [], []
    for qi in q[:4]:
        ws = rfan.start_paged_fanout(ref.partitions, qi)
        gs = tfan.start_paged_fanout(port.partitions, qi)
        assert gs.shard_fp == ws.shard_fp
        seen, prev_hwm = [], -np.inf
        for _ in range(5):
            w_ids, _, w_info = rfan.paged_fanout_search(ref.partitions, qi, ws, 10)
            g_ids, g_d, g_info = tfan.paged_fanout_search(port.partitions, qi, gs, 10)
            assert not set(g_ids.tolist()) & set(seen), "a page repeated a result"
            assert g_info["emit_hwm"] == max(prev_hwm, float(g_d.max())) >= prev_hwm
            prev_hwm = g_info["emit_hwm"]
            seen += g_ids.tolist()
            _ru_close(g_info["ru_total"], w_info["ru_total"])
            got_all.append(g_ids)
            want_all.append(w_ids)
    got_all, want_all = np.stack(got_all), np.stack(want_all)
    assert float((got_all == want_all).mean()) >= SAME_SLOTS


# -- the stacked paths, bit for bit against the port's serial composition ---


@pytest.fixture(scope="module")
def mixed(pair):
    """The carried partitions, one unbuilt (fewer documents than the
    bootstrap: the host fallback) and one empty."""
    _, port, data, _ = pair
    cc = port.cfg
    unbuilt = PhysicalPartition(cc, 0, 0, 90, device="cpu")
    unbuilt.insert(list(range(5000, 5020)), [0] * 20, data[:20] + 0.3)
    empty = PhysicalPartition(cc, 0, 0, 91, device="cpu")
    return port.partitions[:2] + [unbuilt] + port.partitions[2:] + [empty]


def _bit_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1].view(np.int32), b[1].view(np.int32))
    for key in ("ru_per_partition", "server_latencies_ms", "service_latency_ms",
                "failed_partitions", "complete", "partition_ids"):
        assert a[2][key] == b[2][key], key
    for s, t in zip(a[2]["stats_per_partition"], b[2]["stats_per_partition"]):
        assert (s.hops, s.cmps, s.expansions, s.full_reads, s.tier_hits, s.tier_misses) == (
            t.hops, t.cmps, t.expansions, t.full_reads, t.tier_hits, t.tier_misses)


@pytest.mark.parametrize("case", ["all", "dead_replica_set", "batch_not_a_bucket", "W=1 L=60"])
def test_spmd_fanout_bit_equal_to_serial(pair, mixed, case):
    _, _, _, q = pair
    dead = mixed[1].pid
    health = (lambda p: p.pid != dead) if case == "dead_replica_set" else None
    qb = q[:12] if case == "batch_not_a_bucket" else q
    kw = dict(beam_width=1, L=60) if case == "W=1 L=60" else {}
    spmd = SpmdFanout(device="cpu")
    for _ in range(2):  # the second call reads the cached stack
        serial = tfan.batched_fanout_search(mixed, qb, K, batch_buckets=tsearch.BATCH_BUCKETS,
                                            health=health, **kw)
        stacked = spmd.search(mixed, qb, K, health=health, **kw)
        _bit_equal(stacked, serial)
    assert stacked[2]["spmd"]["partitions_in_program"] == 3 - (case == "dead_replica_set")
    assert [s.plan for s in stacked[2]["stats_per_partition"]].count("graph-spmd") == (
        3 - (case == "dead_replica_set"))
    if case == "dead_replica_set":
        assert stacked[2]["failed_partitions"] == [(dead, "replica set down")]
        assert not stacked[2]["complete"]


def test_spmd_fanout_restacks_after_a_write(pair):
    """An insert advances the partition's write epoch: the next stacked call
    rebuilds the stack and still equals the serial loop."""
    _, port, data, q = pair
    # a copy of the carried partitions (the port's snapshot and store bytes
    # share the reference's layout)
    parts = Collection.from_reference_state(port.cfg, _reference_state(port),
                                            device="cpu").partitions
    spmd = SpmdFanout(device="cpu")
    spmd.search(parts, q, K)
    before = parts[0].providers.write_count
    parts[0].insert([7000], [parts[0].lo], data[:1] + 0.2)
    assert parts[0].providers.write_count > before
    serial = tfan.batched_fanout_search(parts, q, K, batch_buckets=tsearch.BATCH_BUCKETS)
    _bit_equal(spmd.search(parts, q, K), serial)
    assert 7000 in spmd.search(parts, data[:1] + 0.2, 1)[0]


def test_all_partitions_down_raises(pair):
    _, port, _, q = pair
    with pytest.raises(tfan.AllPartitionsFailed):
        SpmdFanout(device="cpu").search(port.partitions, q, K, health=lambda p: False)
    with pytest.raises(tfan.AllPartitionsFailed):
        tfan.batched_fanout_search(port.partitions, q, K, health=lambda p: False)


def _shard_stack(parts):
    """distributed_search_fn's arguments from built partitions."""
    idx = [p.index for p in parts]
    return (np.stack([i.pv.neighbors for i in idx]), np.stack([i.pv.codes for i in idx]),
            np.stack([i.pv.versions for i in idx]), np.stack([i.pv.live for i in idx]),
            np.stack([i.pv.vectors for i in idx]), np.stack([i.slot_to_doc for i in idx]),
            np.asarray([i.medoid for i in idx], np.int32),
            np.stack([i.snapshot()["schemas"][0] for i in idx]))


def _port_per_shard(args, q, L, k):
    """The port's per-shard composition: search, rerank on the beam's first
    2k, and one topk_select merge."""
    nb, codes, versions, live, vectors, docs, medoid, books = (torch.from_numpy(a) for a in args)
    qt = torch.from_numpy(q)
    out_i, out_d = [], []
    for s in range(nb.shape[0]):
        luts = tpq.adc_lut(tpq.PQSchema(books[s], 0), qt)[:, None].contiguous()
        res = tsearch.batch_greedy_search(nb[s], codes[s], versions[s], live[s], luts,
                                          int(medoid[s]), L=L)
        ids, d = port_flat.rerank(qt, res.beam_ids[:, :2 * k], vectors[s], k=k)
        out_i.append(torch.where(ids >= 0, docs[s][ids.long().clamp(min=0)], -1))
        out_d.append(torch.where(ids >= 0, d, float("inf")))
    vals, pos = topk_select(torch.cat(out_d, 1).contiguous(), k)
    return torch.cat(out_i, 1).gather(1, pos.long()).numpy(), vals.numpy()


def _reference_per_shard(args, q, L, k):
    """The reference's local_search, per shard through repro.core, merged
    with lax.top_k (the all_gather of one device per shard)."""
    import jax
    import jax.numpy as jnp
    from repro.core import flat as rf
    from repro.core import pq as rpq
    from repro.core import search as rs

    nb, codes, versions, live, vectors, docs, medoid, books = args
    out_i, out_d = [], []
    for s in range(nb.shape[0]):
        schema = rpq.PQSchema(codebooks=jnp.asarray(books[s]), version=jnp.int32(0))
        luts = jax.vmap(lambda x: rpq.adc_lut(schema, x, "l2"))(jnp.asarray(q))[:, None]
        res = rs.batch_greedy_search(jnp.asarray(nb[s]), jnp.asarray(codes[s]),
                                     jnp.asarray(versions[s]), jnp.asarray(live[s]), luts,
                                     jnp.int32(medoid[s]), L=L)
        ids, d = rf.rerank(jnp.asarray(q), res.beam_ids[:, :2 * k], jnp.asarray(vectors[s]), k=k)
        ids, d = np.asarray(ids), np.asarray(d)
        out_i.append(np.where(ids >= 0, docs[s][np.maximum(ids, 0)], -1))
        out_d.append(np.where(ids >= 0, d, np.inf))
    neg, pos = jax.lax.top_k(-jnp.asarray(np.concatenate(out_d, 1)), k)
    return np.take_along_axis(np.concatenate(out_i, 1), np.asarray(pos), 1), -np.asarray(neg)


def test_distributed_search_fn(pair):
    """Bit-equal to the port's per-shard composition; ids equal to the
    reference's per-shard composition in 99 % of slots. The V=2 shard is
    read through its version-0 codebooks only, as in the reference."""
    ref, port, data, q = pair
    L = 32
    args = _shard_stack(port.partitions)
    fn = tfan.distributed_search_fn(L=L, k=K, device="cpu")
    ids, dists = fn(*args, q)
    want_i, want_d = _port_per_shard(args, q, L, K)
    np.testing.assert_array_equal(ids.numpy(), want_i)
    np.testing.assert_array_equal(dists.numpy().view(np.int32), want_d.view(np.int32))
    ref_i, _ = _reference_per_shard(_shard_stack(ref.partitions), q, L, K)
    _held(ids.numpy(), ref_i, rrec.ground_truth(q, data, np.ones(N, bool), K))


def test_per_lane_start_equals_int_form(pair):
    """A (B,) start tensor equal to the int start gives the int form's
    result field for field; different starts per lane give each lane what
    a batch of that lane alone gives; the bucketed form pads the starts."""
    _, port, _, q = pair
    idx = port.partitions[0].index
    nb, codes, versions, live, _ = idx.pv.materialize()
    luts = idx._luts(torch.from_numpy(q[:6]))
    run = lambda lt, s, fn=tsearch.batch_greedy_search: fn(nb, codes, versions, live, lt, s, L=40,
                                                             beam_width=2)
    base = run(luts, idx.medoid)
    for got in (run(luts, torch.full((6,), idx.medoid, dtype=torch.int32)),
                run(luts, torch.full((6,), idx.medoid, dtype=torch.int32),
                    tsearch.bucketed_batch_greedy_search)):
        for a, b in zip(got, base):
            assert torch.equal(a, b)
    starts = torch.tensor([idx.medoid, 3, 7, 11, idx.medoid, 40], dtype=torch.int32)
    mixed_res = run(luts, starts)
    for lane in range(6):
        alone = run(luts[lane:lane + 1].contiguous(), int(starts[lane]))
        for a, b in zip(mixed_res, alone):
            assert torch.equal(a[lane:lane + 1], b)
    with pytest.raises(ValueError, match="start per lane"):
        run(luts, starts[:4])
