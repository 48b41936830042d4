"""The port's ``partition`` package against the JAX reference, on the CPU:
key hashing and routing, splits and merges (every document and its
properties preserved, hash ranges equal to the reference's after the same
inserts), partitions carried across from the reference's plain state, and
the reference's replica-set scenarios run on the port."""
import numpy as np
import pytest

from conftest import clustered_data
from repro.core import GraphConfig as RefGraphConfig
from repro.partition import Collection as RefCollection
from repro.partition import CollectionConfig as RefCollectionConfig
from repro.partition.partitioner import hash_key as ref_hash_key
from repro.serve.predicate import property_items as ref_property_items
from repro_torch.core import GraphConfig
from repro_torch.core import recall as rec
from repro_torch.partition import Collection, CollectionConfig, PhysicalPartition, ReplicaSet
from repro_torch.partition.fanout import fanout_search
from repro_torch.partition.partitioner import hash_key
from repro_torch.serve.predicate import F, property_items

D = 16
GKW = dict(R=16, M=8, L_build=32, L_search=48, bootstrap_sample=64, refine_sample=10**9,
           batch_size=40)


def _docs(n, seed):
    data = clustered_data(np.random.RandomState(seed), n, D)
    keys = [f"pk{i % 11}" for i in range(n)]
    items = [{"cat": i % 10, "tier": i % 3} for i in range(n)]
    return data, keys, items


def _port(n, max_per, parts, seed=11):
    data, keys, items = _docs(n, seed)
    cc = CollectionConfig(dim=D, graph=GraphConfig(capacity=max_per + 128, **GKW),
                          max_vectors_per_partition=max_per, initial_partitions=parts)
    col = Collection(cc, device="cpu")
    col.insert(list(range(n)), keys, data, props=[property_items(d) for d in items])
    return col, data


def _ref(n, max_per, parts, seed=11):
    data, keys, items = _docs(n, seed)
    cc = RefCollectionConfig(dim=D, graph=RefGraphConfig(capacity=max_per + 128, **GKW),
                             max_vectors_per_partition=max_per, initial_partitions=parts)
    col = RefCollection(cc)
    col.insert(list(range(n)), keys, data, props=[ref_property_items(d) for d in items])
    return col, data


@pytest.fixture(scope="module")
def split_pair():
    """700 documents into one partition of at most 300: the same splits in
    both packages (the k-means draws differ, the routing does not)."""
    return _ref(700, 300, 1), _port(700, 300, 1)


def _layout(col):
    return [(p.lo, p.hi, p.pid, dict(p.doc_pk), dict(p.doc_props)) for p in col.partitions]


@pytest.mark.parametrize("key", ["pk0", "pk17", 0, 12345, ("tenant", 3), None, 2.5, ""])
def test_hash_key_matches_reference(key):
    assert hash_key(key) == ref_hash_key(key)


def test_routing_and_doc_pk_match_reference():
    """Four initial ranges, keys spread unevenly: every document lands in
    the reference's partition under the reference's hash."""
    n = 240
    data, keys, items = _docs(n, 3)
    g = dict(GKW, bootstrap_sample=1000)  # no graph: routing alone
    ref = RefCollection(RefCollectionConfig(dim=D, graph=RefGraphConfig(capacity=256, **g),
                                            max_vectors_per_partition=256,
                                            initial_partitions=4))
    port = Collection(CollectionConfig(dim=D, graph=GraphConfig(capacity=256, **g),
                                       max_vectors_per_partition=256, initial_partitions=4),
                      device="cpu")
    ref.insert(list(range(n)), keys, data, props=[ref_property_items(d) for d in items])
    port.insert(list(range(n)), keys, data, props=[property_items(d) for d in items])
    assert _layout(port) == _layout(ref)
    for d in (0, 7, 239):
        assert port.owner_of(d).pid == ref.owner_of(d).pid
    assert port._route("pk3").pid == ref._route("pk3").pid
    # re-keying a document moves it, as in the reference
    ref.insert([5], ["elsewhere"], data[5:6], props=[ref_property_items({"cat": 1})])
    port.insert([5], ["elsewhere"], data[5:6], props=[property_items({"cat": 1})])
    assert _layout(port) == _layout(ref)


def test_split_preserves_documents_properties_and_ranges(split_pair):
    (ref, _), (port, data) = split_pair
    assert port.splits == ref.splits >= 1 and len(port.partitions) == len(ref.partitions)
    assert port.num_docs == 700
    assert _layout(port) == _layout(ref)
    # every document is live in its owner, its properties indexed there
    for p in port.partitions:
        live = p.index.slot_to_doc[p.providers.live]
        assert sorted(live.tolist()) == sorted(p.doc_pk)
        cat3 = p.props.mask(p.props.compile(F.eq("cat", 3)))
        assert sorted(p.index.slot_to_doc[cat3].tolist()) == [d for d in sorted(p.doc_pk)
                                                             if d % 10 == 3]
    q = data[np.random.RandomState(0).choice(700, 8)] + 0.02
    ids, _, _ = fanout_search(port.partitions, q, k=10)
    gt = rec.ground_truth(q, data, np.ones(700, bool), 10, device="cpu")
    assert rec.recall_at_k(ids, gt, 10) >= 0.8


def test_split_children_halve_the_range(split_pair):
    """The first split of [0, 2^32) gives [0, mid) and [mid, 2^32)."""
    (ref, _), (port, _) = split_pair
    bounds = [(p.lo, p.hi) for p in port.partitions]
    assert bounds[0][0] == 0 and bounds[-1][1] == 1 << 32
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert [p.pid for p in port.partitions] == [p.pid for p in ref.partitions]


def test_merge_roundtrip_matches_reference():
    (ref, _), (port, data) = _ref(360, 400, 2, seed=12), _port(360, 400, 2, seed=12)
    ref.merge(0)
    port.merge(0)
    assert port.merges == ref.merges == 1
    assert _layout(port) == _layout(ref)
    assert port.num_docs == 360
    ids, _, _ = fanout_search(port.partitions, data[:4] + 0.01, k=5)
    for i in range(4):
        assert i in ids[i].tolist()


def test_partition_from_reference_state():
    """A port partition carried across from a reference partition's plain
    state holds the same arrays, documents, postings and committed log."""
    ref, _ = _ref(300, 400, 1, seed=14)
    rp = ref.partitions[0]
    snap = rp.index.snapshot()
    state = dict(lo=rp.lo, hi=rp.hi, pid=rp.pid,
                 index={k: ([np.asarray(c) for c in v] if k == "schemas" else
                            np.asarray(v) if hasattr(v, "shape") else v)
                        for k, v in snap.items()},
                 snapshot=rp.providers.snapshot_bytes(), wal=rp.providers.wal_bytes(),
                 doc_pk=dict(rp.doc_pk), doc_props=dict(rp.doc_props))
    cc = CollectionConfig(dim=D, graph=GraphConfig(capacity=528, **GKW),
                          max_vectors_per_partition=400)
    p = PhysicalPartition.from_reference_state(cc, state, device="cpu")
    assert (p.lo, p.hi, p.pid, p.doc_pk, p.doc_props) == (rp.lo, rp.hi, rp.pid, rp.doc_pk,
                                                          rp.doc_props)
    for f in ("neighbors", "codes", "versions", "live", "vectors"):
        np.testing.assert_array_equal(getattr(p.providers, f), getattr(rp.providers, f))
    assert p.providers.committed == rp.providers.committed
    assert p.index.doc_to_slot == rp.index.doc_to_slot and p.index.medoid == rp.index.medoid
    for pred in (F.eq("cat", 3), F.in_("tier", [0, 2]), ~F.eq("cat", 1)):
        np.testing.assert_array_equal(p.props.compile(pred), rp.props.compile(pred))
    assert p.providers.snapshot_bytes() == rp.providers.snapshot_bytes()


# -- the reference's replica scenarios (tests/test_partition.py), on the port --


@pytest.fixture
def one_partition():
    return _port(200, 400, 1, seed=14)


def test_replica_failover_and_rebuild_on_the_partitions_device(one_partition):
    col, data = one_partition
    p = col.partitions[0]
    rs = ReplicaSet(p, num_replicas=4)
    rs.insert([10_000], [123], data[:1])
    primary = rs.primary
    rs.kill(primary)
    assert rs.primary != primary and rs.failovers == 1
    ids, _, _ = rs.search(data[:2], 5)
    assert ids.shape == (2, 5)
    dead = [r.rid for r in rs.replicas if not r.alive][0]
    fresh = rs.rebuild(dead)
    assert fresh.device == p.device == p.index.device
    np.testing.assert_array_equal(fresh.vectors, p.providers.vectors)
    assert rs.replicas[dead].alive and rs.replicas[dead].applied_lsn == rs.lsn


def test_replica_round_robin_spreads_reads(one_partition):
    col, data = one_partition
    rs = ReplicaSet(col.partitions[0], num_replicas=4)
    rs.kill(2)  # a secondary dies; primary stays
    for _ in range(9):
        rs.search(data[:1], 3)
    counts = rs.read_counts()
    assert counts[2] == 0, "dead replicas must receive no reads"
    healthy = [counts[r] for r in (0, 1, 3)]
    assert sum(healthy) == 9 and max(healthy) - min(healthy) <= 1, counts


def test_quorum_loss_raises(one_partition):
    col, _ = one_partition
    rs = ReplicaSet(col.partitions[0], num_replicas=4)
    for rid in range(3):
        rs.kill(rid)
    with pytest.raises(RuntimeError, match="quorum"):
        rs.insert([1], [1], np.zeros((1, D), np.float32))


def test_dead_replica_reprobe_revives_after_cooldown(one_partition):
    col, data = one_partition
    rs = ReplicaSet(col.partitions[0], num_replicas=4, reprobe_after_s=5.0)
    rs.insert([10_001], [77], data[:1])
    rs.kill(2, now_s=100.0)
    rs.kill(2, now_s=101.0)  # double-kill is a no-op (no double failover)
    assert not rs.replicas[2].alive and rs.failovers == 0
    assert rs.probe_dead(now_s=103.0) == []  # cooldown not elapsed
    assert rs.probe_dead(now_s=105.0) == [2]
    assert rs.replicas[2].alive and rs.recoveries == 1
    assert rs.replicas[2].applied_lsn == rs.lsn
    before = rs.read_counts()[2]
    for _ in range(4):
        rs.search(data[:1], 3)
    assert rs.read_counts()[2] > before, "revived replica serves reads"


def test_collection_runs_on_the_card_unless_asked(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cc = CollectionConfig(dim=D, graph=GraphConfig(capacity=64, **GKW),
                          max_vectors_per_partition=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Collection(cc)
    assert Collection(cc, device="cpu").partitions[0].device.type == "cpu"
