"""The port's ``store`` package against the JAX reference's, on the CPU: the
Bw-Tree, term, RU, codec, property-posting and page-cache copies on the same
operation sequences; snapshot and WAL bytes written by one package recovered
by the other; WAL recovery, torn tails and interior bit rot; and a port
``DiskANNIndex`` over a ``StoreProviderSet`` killed at a crash barrier inside
an operation window and recovered."""
import dataclasses

import numpy as np
import pytest

from conftest import clustered_data
from repro.core import DiskANNIndex as RefIndex
from repro.core import GraphConfig as RefConfig
from repro.core.providers import Context as RefContext
from repro.store import bwtree as rbw
from repro.store import faults as rfaults
from repro.store import pages as rpages
from repro.store import props as rprops
from repro.store import ru as rru
from repro.store import terms as rterms
from repro.store.provider import StoreProviderSet as RefStore
from repro_torch.core import Context, DiskANNIndex, GraphConfig
from repro_torch.store import StoreProviderSet
from repro_torch.store import bwtree as tbw
from repro_torch.store import codec as tcodec
from repro_torch.store import faults as tfaults
from repro_torch.store import pages as tpages
from repro_torch.store import props as tprops
from repro_torch.store import ru as tru
from repro_torch.store import terms as tterms

DIM = 16


# ---------------------------------------------------------------------------
# the copies on the same operation sequences
# ---------------------------------------------------------------------------


def _tree_script(seed, n=600):
    rng = np.random.RandomState(seed)
    codec = rterms.TermCodec()
    ops = []
    for _ in range(n):
        doc = int(rng.randint(0, 300))
        key = codec.adj_key(doc) if rng.rand() < 0.6 else codec.quant_key(doc, rng.randint(3))
        r = rng.rand()
        if r < 0.35:
            ops.append(("upsert", key, codec.encode_adjacency(
                rng.randint(0, 300, rng.randint(1, 9)).tolist())))
        elif r < 0.6:
            ops.append(("append", key, codec.encode_adjacency(rng.randint(0, 300, 3).tolist())))
        elif r < 0.8:
            ops.append(("get", key))
        elif r < 0.9:
            ops.append(("delete", key))
        else:
            ops.append(("put", key, codec.encode_adjacency([int(rng.randint(300))])))
    return ops


@pytest.mark.parametrize("seed", range(3))
def test_bwtree_contents_and_stats_equal(seed):
    trees = [m.BwTree(merge_fn=t.merge_adjacency, cache_pages=6, page_capacity=16)
             for m, t in ((rbw, rterms), (tbw, tterms))]
    for i, (op, *args) in enumerate(_tree_script(seed)):
        out = []
        for tr in trees:  # a refused patch (the §2.1 contract) must be refused by both
            try:
                out.append(getattr(tr, op)(*args))
            except (KeyError, ValueError) as e:
                out.append(type(e))
        assert out[0] == out[1], (i, op)
        if i % 50 == 0:
            assert dataclasses.asdict(trees[0].stats) == dataclasses.asdict(trees[1].stats)
            assert trees[0].chain_length(args[0]) == trees[1].chain_length(args[0])
    prefix = rterms.TermCodec().adj_prefix()
    assert list(trees[0].prefix_seek(prefix)) == list(trees[1].prefix_seek(prefix))
    assert trees[0].dump_items() == trees[1].dump_items()
    assert trees[0].num_pages == trees[1].num_pages > 1
    assert dataclasses.asdict(trees[0].stats) == dataclasses.asdict(trees[1].stats)


@pytest.mark.parametrize("shard", [None, 7])
def test_term_bytes_equal_both_ways(shard):
    rc, tc = rterms.TermCodec("/embedding"), tterms.TermCodec("/embedding")
    for doc in (0, 1, 12345, 2 ** 31 - 1):
        assert rc.adj_key(doc, shard) == tc.adj_key(doc, shard)
        assert rc.quant_key(doc, shard) == tc.quant_key(doc, shard)
        assert tc.decode_doc_id(rc.adj_key(doc, shard)) == rc.decode_doc_id(tc.adj_key(doc, shard))
    assert rc.adj_prefix(shard) == tc.adj_prefix(shard)
    assert rc.quant_prefix(shard) == tc.quant_prefix(shard)
    for value in (3, "red", 2.5, True, None):
        assert rterms.TermCodec.prop_key("/cat", value, shard) == \
            tterms.TermCodec.prop_key("/cat", value, shard)
    adj = [5, 0, 99, 1 << 20]
    assert rc.encode_adjacency(adj) == tc.encode_adjacency(adj)
    assert tc.decode_adjacency(rc.encode_adjacency(adj)) == adj
    q = rc.encode_quant_value(bytes(range(16)), 1)
    assert q == tc.encode_quant_value(bytes(range(16)), 1) and tc.decode_quant_value(q) == (
        bytes(range(16)), 1)
    words = np.arange(9, dtype=np.uint32) * 77
    assert rc.encode_posting(words) == tc.encode_posting(words)
    np.testing.assert_array_equal(tc.decode_posting(rc.encode_posting(words)), words)
    merged = [b"\x01\x00\x00\x00", b"\x02\x00\x00\x00"]
    assert rterms.merge_adjacency(None, merged) == tterms.merge_adjacency(None, merged)


@pytest.mark.parametrize("seed", range(3))
def test_ru_charges_equal(seed):
    rng = np.random.RandomState(seed)
    cfg_r, cfg_t = rru.RUConfig(), tru.RUConfig()
    assert dataclasses.asdict(cfg_r) == dataclasses.asdict(cfg_t)
    m_r, m_t = rru.RUMeter(cfg_r), tru.RUMeter(cfg_t)
    names = [f.name for f in dataclasses.fields(rru.OpCounters)]
    for _ in range(40):
        vals = {n: (float(rng.rand() * 9) if n in ("cpu_ms", "vector_kb") else int(rng.randint(50)))
                for n in names}
        c_r, c_t = rru.OpCounters(**vals), tru.OpCounters(**vals)
        assert m_r.charge(c_r) == m_t.charge(c_t)
        assert m_r.latency_ms(c_r) == m_t.latency_ms(c_t)
    stats = RefIndex.__init__.__globals__["QueryStats"](hops=12.0, cmps=900.0, full_reads=50.0,
                                                       expansions=40.0, tier_misses=3.0)
    for lanes in (1, 4):
        assert dataclasses.asdict(rru.counters_for_ru(stats, lanes)) == \
            dataclasses.asdict(tru.counters_for_ru(stats, lanes))
    assert dataclasses.asdict(rru.counters_for_latency(stats)) == \
        dataclasses.asdict(tru.counters_for_latency(stats))
    g_r, g_t = rru.ResourceGovernor(100.0), tru.ResourceGovernor(100.0)
    for i in range(30):
        ru = float(rng.rand() * 80)
        assert g_r.request(ru) == g_t.request(ru)
        g_r.advance(0.1)
        g_t.advance(0.1)
        d_r, d_t = g_r.try_admit(ru, i * 0.2), g_t.try_admit(ru, i * 0.2)
        assert dataclasses.asdict(d_r) == dataclasses.asdict(d_t)
    assert dataclasses.asdict(m_r.total) == dataclasses.asdict(m_t.total)
    assert g_r.throttle_events == g_t.throttle_events


class _Eq:
    """A one-term predicate: the duck type PropertyTermIndex.compile reads."""

    def __init__(self, path, value):
        self.path, self.value = path, value

    def key(self):
        return f"{self.path}={self.value!r}".encode()

    def compile_words(self, idx):
        words = idx.posting(self.path, self.value)
        return idx.zeros() if words is None else words


def test_property_postings_equal_and_written_through():
    stores = [RefStore(96, 8, 4, DIM), StoreProviderSet(96, 8, 4, DIM, device="cpu")]
    idxs = [m.PropertyTermIndex(96, store=s) for m, s in zip((rprops, tprops), stores)]
    rng = np.random.RandomState(2)
    for _ in range(120):
        slot = int(rng.randint(96))
        if rng.rand() < 0.2:
            for i in idxs:
                i.remove(slot)
        else:
            items = (("cat", int(rng.randint(4))), ("tag", ["a", "b"][rng.randint(2)]))
            for i in idxs:
                i.assign(slot, items)
    for path, value in (("cat", 0), ("cat", 3), ("tag", "b"), ("tag", "zz")):
        a, b = (i.compile(_Eq(path, value)) for i in idxs)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(rprops.words_to_mask(a, 96), tprops.words_to_mask(b, 96))
    assert idxs[0].epoch == idxs[1].epoch and idxs[0].num_terms == idxs[1].num_terms
    np.testing.assert_array_equal(idxs[0].universe(), idxs[1].universe())
    assert stores[0].tree.dump_items() == stores[1].tree.dump_items()
    assert stores[0].wal_bytes() == stores[1].wal_bytes()


def _touch_script(seed, n_touches=200, capacity=640):
    r = np.random.RandomState(seed)
    return [r.randint(0, capacity, size=r.randint(1, 12)) for _ in range(n_touches)]


@pytest.mark.parametrize("seed", range(3))
def test_page_cache_sequence_equal(seed):
    """The same touches (admitting, scanning, pinning) and budget changes give
    the same hits, misses and evictions, page for page, in both packages."""
    kw = dict(page_size=64, budget_pages=4, seed=7 + seed)
    a, b = rpages.PagedVectorStore(640, DIM, **kw), tpages.PagedVectorStore(640, DIM, **kw)
    rng = np.random.RandomState(seed)
    for i, slots in enumerate(_touch_script(seed)):
        admit, pin = bool(rng.rand() < 0.8), bool(rng.rand() < 0.3)
        ra, ta = a.touch(slots, admit=admit, pin=pin), b.touch(slots, admit=admit, pin=pin)
        assert ra[:2] == ta[:2], i
        np.testing.assert_array_equal(ra[2], ta[2])
        if pin:
            a.unpin(ra[2])
            b.unpin(ta[2])
        if i == 120:
            a.set_budget(2)
            b.set_budget(2)
    np.testing.assert_array_equal(a.resident, b.resident)
    assert a.hand == b.hand and a.state() == b.state() and b.evictions > 0


def test_page_cache_behaviours():
    """The reference's page-cache tests on the port's copy: a seeded warm
    set that re-seeds on re-tiering, pins that no eviction crosses, scans
    billed but never admitted, a zero budget that admits nothing."""
    a = tpages.PagedVectorStore(640, DIM, page_size=64, budget_pages=5, seed=1)
    warm = a.resident.copy()
    assert warm.sum() == 5
    a.set_budget(None)
    assert a.resident.all()
    a.set_budget(5)
    np.testing.assert_array_equal(a.resident, warm)
    pv = tpages.PagedVectorStore(640, DIM, page_size=64, budget_pages=2, seed=0)
    _, _, pinned = pv.touch([0, 70, 140], pin=True)
    assert pinned.size == 3 and pv.resident[pinned].all()
    for s in range(200, 640, 30):
        pv.touch([s])
        assert pv.resident[pinned].all(), "evicted a pinned in-flight page"
    pv.unpin(pinned)
    assert pv.n_resident <= 2
    with pytest.raises(AssertionError, match="unpin"):
        pv.unpin(pinned)
    sc = tpages.PagedVectorStore(640, DIM, page_size=64, budget_pages=3, seed=4)
    warm = sc.resident.copy()
    assert sc.touch(np.arange(640), admit=False)[:2] == (3, 7)
    np.testing.assert_array_equal(sc.resident, warm)
    z = tpages.PagedVectorStore(640, DIM, page_size=64, budget_pages=0, seed=0)
    assert z.touch(np.arange(640))[:2] == (0, 10) and z.n_resident == 0


# ---------------------------------------------------------------------------
# durability: bytes both ways, WAL recovery, damage
# ---------------------------------------------------------------------------


def _drive(pv, ctx, rng_seed=0):
    """The same writes on a provider of either package: bare writes
    (auto-commit) and operation windows, every setter. Returns the RU of
    each window."""
    rng = np.random.RandomState(rng_seed)
    charges = []
    pv.set_full(ctx, np.arange(10), rng.randn(10, DIM).astype(np.float32))
    pv.set_quant(ctx, np.arange(10), rng.randint(0, 255, (10, 4)).astype(np.uint8),
                 np.zeros(10, np.uint8))
    for i in range(4):
        pv.begin_op()
        rows = rng.randint(-1, 10, (3, 8)).astype(np.int32)
        pv.set_neighbors(ctx, np.arange(3 * i, 3 * i + 3) % 10, rows)
        pv.append_neighbors(ctx, i, np.array([i + 1, i + 2], np.int32))
        pv.set_live(ctx, np.arange(i, 10, 2), bool(i % 2))
        pv.write_prop_posting(rterms.TermCodec.prop_key("/cat", i), np.arange(3, dtype=np.uint32))
        charges.append(pv.end_op())
    return charges


def test_snapshot_and_wal_bytes_equal_both_ways():
    ref, port = RefStore(64, 8, 4, DIM), StoreProviderSet(64, 8, 4, DIM, device="cpu")
    assert _drive(ref, RefContext()) == _drive(port, Context())
    assert ref.wal_bytes() == port.wal_bytes()
    wal = port.wal_bytes()
    snap = port.snapshot_bytes()
    assert snap == ref.snapshot_bytes()
    assert ref.committed == port.committed == 6
    _drive(ref, RefContext(), 1)
    _drive(port, Context(), 1)
    wal2 = port.wal_bytes()
    assert wal2 == ref.wal_bytes()
    # each package recovers the other's bytes to the state of its twin
    into_ref, into_port = RefStore(64, 8, 4, DIM), StoreProviderSet(64, 8, 4, DIM, device="cpu")
    assert into_ref.recover(snap, wal2) == into_port.recover(snap, wal2) == 12
    rfaults.recovery_invariants(into_ref, port)
    tfaults.recovery_invariants(into_port, ref)
    tfaults.recovery_invariants(into_port, port)
    assert into_port.read_neighbors_from_store(Context(), 0) == \
        into_ref.read_neighbors_from_store(RefContext(), 0)
    got = into_port.materialize()
    np.testing.assert_array_equal(got[0].numpy(), port.neighbors)
    np.testing.assert_array_equal(got[3].numpy(), port.live)
    assert len(wal) > 0


def test_wal_recovery_equivalence():
    rng = np.random.RandomState(0)
    pv = StoreProviderSet(64, 8, 4, 16, device="cpu")
    ctx = Context()
    pv.set_full(ctx, np.arange(10), rng.randn(10, 16).astype(np.float32))
    pv.set_quant(ctx, np.arange(10), rng.randint(0, 255, (10, 4)).astype(np.uint8),
                 np.zeros(10, np.uint8))
    snap = pv.snapshot_bytes()
    pv.set_neighbors(ctx, np.arange(3), np.full((3, 8), -1, np.int32))
    pv.append_neighbors(ctx, 0, np.array([1, 2], np.int32))
    pv.set_live(ctx, np.arange(10), True)
    wal = pv.wal_bytes()
    pv2 = StoreProviderSet(64, 8, 4, 16, device="cpu")
    pv2.recover(snap, wal)
    for name in ("vectors", "codes", "neighbors", "live"):
        np.testing.assert_array_equal(getattr(pv2, name), getattr(pv, name))
    assert pv2.read_neighbors_from_store(ctx, 0) == [1, 2]


def _provider_with_records(n):
    pv = StoreProviderSet(64, 8, 4, DIM, device="cpu")
    snap = pv.snapshot_bytes()
    rng = np.random.RandomState(0)
    for i in range(n):  # each bare write auto-commits one record
        pv.set_full(Context(), np.array([i]), rng.randn(1, DIM).astype(np.float32))
    return pv, snap


def _fresh():
    return StoreProviderSet(64, 8, 4, DIM, device="cpu")


@pytest.mark.parametrize("seed", range(4))
def test_torn_tail_truncates_to_last_whole_record(seed):
    n = 3 + seed
    pv, snap = _provider_with_records(n)
    torn = tfaults.torn_tail(pv.wal_bytes(), np.random.RandomState(seed),
                             nbytes=3 if seed == 0 else None)
    fresh = _fresh()
    assert fresh.recover(snap, torn) == pv.committed - 1
    assert fresh.recovered_torn_tail
    twin, _ = _provider_with_records(n - 1)
    tfaults.recovery_invariants(fresh, twin)


def test_corrupted_final_record_is_torn_not_fatal():
    pv, snap = _provider_with_records(4)
    wal = tfaults.corrupt_record(pv.wal_bytes(), np.random.RandomState(2), index=3)
    fresh = _fresh()
    assert fresh.recover(snap, wal) == pv.committed - 1 and fresh.recovered_torn_tail


def test_corrupted_interior_record_raises():
    pv, snap = _provider_with_records(5)
    wal = tfaults.corrupt_record(pv.wal_bytes(), np.random.RandomState(3), index=1)
    with pytest.raises(tcodec.WalCorruption):
        _fresh().recover(snap, wal)


# ---------------------------------------------------------------------------
# an index over a StoreProviderSet: crash at a barrier, recover, search
# ---------------------------------------------------------------------------

KW = dict(capacity=480, R=12, M=8, L_build=24, L_search=24, bootstrap_sample=96,
          refine_sample=250, batch_size=32)


def _durable(data, crash: bool):
    """Insert in operation windows, snapshot, insert and delete more, then
    (with ``crash``) die at a barrier inside one more insert window.
    Returns (index, snapshot bytes, the index's own snapshot at the end)."""
    cfg = GraphConfig(**KW)
    pv = StoreProviderSet(cfg.capacity, cfg.R_slack, cfg.M, DIM, device="cpu")
    idx = DiskANNIndex(cfg, DIM, providers=pv, device="cpu")

    def op(fn, *args, **kw):
        pv.begin_op()
        fn(*args, **kw)
        return pv.end_op()

    for s in range(0, 200, KW["batch_size"]):
        op(idx.insert, list(range(s, min(s + 32, 200))), data[s: min(s + 32, 200)])
    snap = pv.snapshot_bytes()
    for s in range(200, 320, KW["batch_size"]):
        op(idx.insert, list(range(s, min(s + 32, 320))), data[s: min(s + 32, 320)])
    op(idx.delete, list(range(0, 60, 3)))
    op(idx.consolidate, 256)
    op(idx.consolidate, 256)
    if crash:
        tfaults.FaultPlan(seed=0).arm("upsert:post_full").attach(pv)
        pv.begin_op()
        with pytest.raises(tfaults.CrashError):
            idx.insert(list(range(320, 352)), data[320:352])
    return idx, snap


def test_index_crash_at_barrier_recovers():
    data = clustered_data(np.random.RandomState(4), 400, DIM)
    crashed, snap = _durable(data, crash=True)
    twin, _ = _durable(data, crash=False)
    wal = crashed.pv.wal_bytes()
    assert crashed.pv.committed == twin.pv.committed
    fresh = StoreProviderSet(crashed.cfg.capacity, crashed.cfg.R_slack, crashed.cfg.M, DIM,
                             device="cpu")
    assert fresh.recover(snap, wal) == twin.pv.committed
    checks = tfaults.recovery_invariants(fresh, twin.pv)
    assert checks["paged_tier"] and checks["terms"] and checks["graph"]
    # a recovered index: the durable terms from the store, the metadata as
    # the partition keeps it
    rec = DiskANNIndex(crashed.cfg, DIM, providers=fresh, device="cpu")
    for name in ("schemas", "count", "medoid", "doc_to_slot", "slot_to_doc", "_graph_built"):
        setattr(rec, name, getattr(twin, name))
    q = (data[350:366] + 0.01).astype(np.float32)
    want, got = twin.search(q, k=5), rec.search(q, k=5)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert not set(got[0].ravel().tolist()) & set(range(0, 60, 3))
    # the same state in the reference: tier hits and misses equal at a
    # quarter budget, on integer codebooks and queries (exact beams)
    snap_idx = twin.snapshot()
    snap_idx["schemas"] = [np.round(s * 4).astype(np.float32) for s in snap_idx["schemas"]]
    ref_pv = RefStore(KW["capacity"], rec.cfg.R_slack, KW["M"], DIM)
    ref = RefIndex(RefConfig(**KW), DIM, providers=ref_pv)
    ref.restore(snap_idx)
    rec.restore(snap_idx)
    budget = fresh.pages.n_pages // 4
    ref_pv.pages.set_budget(budget)
    fresh.pages.set_budget(budget)
    qi = np.round(q * 4).astype(np.float32)
    for k in (5, 10):
        w, g = ref.search(qi, k=k), rec.search(qi, k=k)
        np.testing.assert_array_equal(g[0], w[0])
        assert (g[2].tier_hits, g[2].tier_misses) == (w[2].tier_hits, w[2].tier_misses)
    # the port's cache also counted the unbudgeted search above as hits
    want_state, got_state = ref_pv.pages.state(), fresh.pages.state()
    assert got_state.pop("hits") > want_state.pop("hits")
    assert got_state == want_state and fresh.pages.misses > 0
