"""In-place delete (Alg 6), the consolidation sweep, the drop policy, the
medoid upkeep and the single-program mini-batch insert of the port against
the JAX reference, on the CPU. With integer-valued codebooks every decoded
coordinate and distance is exact in any summation order, so the graphs must
be equal bit for bit; on float data near-ties may round apart, and the rows
are held equal in 99 % of the rows either side touched."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import clustered_data
from repro.core import DiskANNIndex as RefIndex
from repro.core import GraphConfig as RefConfig
from repro.core import delete as rdel
from repro.core import graph as rgraph
from repro.core import insert as rins
from repro.core import recall as rrec
from repro_torch.core import DiskANNIndex, GraphConfig, GraphState, empty_state
from repro_torch.core import delete as tdel
from repro_torch.core import graph as tgraph
from repro_torch.core import insert as tins

N, D = 2000, 32
KW = dict(capacity=N + 64, R=24, M=16, L_build=48, L_search=48, bootstrap_sample=256,
          refine_sample=1200, batch_size=64)
SAME_ROWS = 0.99
RECALL_TOL = 0.01


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def ref():
    rng = np.random.RandomState(7)
    data = clustered_data(rng, N, D)
    idx = RefIndex(RefConfig(**KW), D, seed=0)
    idx.insert(list(range(N)), data)
    assert len(idx.schemas) == 2  # rows of two schema versions
    return idx.snapshot(), data


def _integer_books(snap):
    """The snapshot with integer-valued codebooks (the codes unchanged)."""
    out = dict(snap)
    out["schemas"] = [np.round(np.asarray(cb) * 4).astype(np.float32) for cb in snap["schemas"]]
    return out


def _pair(snap, metric="l2"):
    kw = dict(KW, metric=metric)
    want = RefIndex(RefConfig(**kw), D)
    want.restore(snap)
    got = DiskANNIndex(GraphConfig(**kw), D, device="cpu")
    got.restore(snap)
    return want, got


def _queries(data, seed, n, live):
    rs = np.random.RandomState(seed)
    pick = rs.choice(np.nonzero(live)[0], n, replace=False)
    return (data[pick] + 0.05 * rs.randn(n, D)).astype(np.float32)


# ---------------------------------------------------------------------------
# the index's delete, consolidate and medoid upkeep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_inplace_delete_bit_equal_integer_codebooks(ref, metric):
    snap, _ = ref
    want, got = _pair(_integer_books(snap), metric)
    victims = [int(d) for d in np.random.RandomState(3).choice(N, 24, replace=False)]
    victims.insert(5, int(snap["slot_to_doc"][snap["medoid"]]))  # the medoid's document
    for d in victims:
        want.delete([d])
        got.delete([d])
        np.testing.assert_array_equal(got.pv.neighbors, want.pv.neighbors, err_msg=f"doc {d}")
        np.testing.assert_array_equal(got.pv.live, want.pv.live)
        assert got.medoid == want.medoid
    assert got.medoid != snap["medoid"]
    # the sweep over every row, the last chunk clipped to the last row
    for _ in range(-(-got.count // 512) + 1):
        want.consolidate(512)
        got.consolidate(512)
        np.testing.assert_array_equal(got.pv.neighbors, want.pv.neighbors)
    dead = ~got.pv.live
    nb = got.pv.neighbors[: got.count]
    assert not dead[nb[nb >= 0]].any(), "an edge to a dead node survived the sweep"


def test_inplace_delete_float_rows_and_recall(ref):
    snap, data = ref
    want, got = _pair(snap)
    victims = [int(d) for d in np.random.RandomState(4).choice(N, 60, replace=False)]
    for i in range(0, len(victims), 20):
        before = got.pv.neighbors.copy()
        want.delete(victims[i: i + 20])
        got.delete(victims[i: i + 20])
        touched = ((want.pv.neighbors != before) | (got.pv.neighbors != before)).any(1)
        same = (want.pv.neighbors[touched] == got.pv.neighbors[touched]).all(1).mean()
        assert touched.any() and same >= SAME_ROWS, f"rows equal in {same:.4f} of those touched"
    live = got.pv.live[:N].copy()
    q = _queries(data, 11, 24, live)
    gt = rrec.ground_truth(q, data, live, 10)
    r_got = rrec.recall_at_k(got.search(q, k=10)[0], gt, 10)
    r_want = rrec.recall_at_k(want.search(q, k=10)[0], gt, 10)
    assert abs(r_got - r_want) <= RECALL_TOL, (r_got, r_want)


def test_drop_policy_and_recompute_medoid(ref):
    snap, _ = ref
    want, got = _pair(snap)
    victims = [int(snap["slot_to_doc"][snap["medoid"]])] + list(range(300, 340))
    want.delete(victims, policy="drop")
    got.delete(victims, policy="drop")
    np.testing.assert_array_equal(got.pv.neighbors, snap["neighbors"])  # the graph untouched
    np.testing.assert_array_equal(got.pv.live, want.pv.live)
    assert got.medoid == want.medoid != snap["medoid"]
    assert got.doc_to_slot == want.doc_to_slot
    np.testing.assert_array_equal(got.slot_to_doc, want.slot_to_doc)
    more = list(range(0, 400, 3))
    want.delete(more, policy="drop")
    got.delete(more, policy="drop")
    want.recompute_medoid()
    got.recompute_medoid()
    assert got.medoid == want.medoid
    got.delete([10 ** 6])  # an unknown document is ignored
    assert got.num_live == want.num_live


def test_delete_keeps_recall(ref):
    """Deleting 200 documents in place, then three consolidation steps: no
    deleted document comes back and recall@10 over the live set stays
    >= 0.8 (the reference's own test of its delete)."""
    snap, data = ref
    idx = DiskANNIndex(GraphConfig(**KW), D, device="cpu")
    idx.restore(snap)
    victims = list(range(100, 300))
    idx.delete(victims, policy="inplace")
    for _ in range(3):
        idx.consolidate()
    live = np.ones(N, bool)
    live[victims] = False
    rs = np.random.RandomState(123)
    pick = rs.choice(np.nonzero(live)[0], 24, replace=False)
    q = (data[pick] + 0.05 * rs.randn(24, D)).astype(np.float32)
    ids, _, _ = idx.search(q, k=10, L=64)
    assert not set(ids.ravel().tolist()) & set(victims), "deleted ids returned"
    r = rrec.recall_at_k(ids, rrec.ground_truth(q, data, live, 10), 10)
    assert r >= 0.8, f"post-delete recall {r}"


# ---------------------------------------------------------------------------
# the kernels' callers on hand-made graphs
# ---------------------------------------------------------------------------


def _hand_made(seed, n=48, R_slack=8):
    """Rows with p twice, N_out(p) with repeats and gaps, rows not compacted,
    dead nodes; integer coordinates."""
    rng = np.random.RandomState(seed)
    nb = rng.randint(0, n, (n, R_slack)).astype(np.int32)
    nb[rng.rand(n, R_slack) < 0.25] = -1
    p = int(rng.randint(n))
    holders = rng.choice(n, 12, replace=False)
    nb[holders, 0] = p
    nb[holders[:4], 3] = p  # p twice in a row
    nb[p, :4] = nb[p, 0]  # a repeated member of N_out(p)
    nb[p, 5] = -1
    live = rng.rand(n) > 0.15
    live[p] = False
    vecs = rng.randint(-6, 7, (n, 4)).astype(np.float32)
    return nb, live, vecs, p


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("c_replace", [1, 3])
def test_inplace_delete_hand_made_graph_bit_equal(seed, c_replace):
    nb, live, vecs, p = _hand_made(seed)
    kw = dict(R=5, R_slack=nb.shape[1], alpha=1.2, c_replace=c_replace)
    want = np.asarray(rdel.inplace_delete(jnp.asarray(nb), jnp.asarray(live), jnp.asarray(vecs),
                                          jnp.int32(p), **kw))
    vt = t(vecs)
    got = tdel.inplace_delete(t(nb), t(live), lambda ids: vt[ids.long().clamp(min=0)], p, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[p] == -1).all()


@pytest.mark.parametrize("start", [0, 17, 40])
def test_consolidate_chunk_bit_equal(start):
    nb, live, _, _ = _hand_made(5)
    want = np.asarray(rdel.consolidate_chunk(jnp.asarray(nb), jnp.asarray(live),
                                             jnp.int32(start), 16))
    got = tdel.consolidate_chunk(t(nb), t(live), start, 16)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# GraphState and the single-program mini-batch insert
# ---------------------------------------------------------------------------


def test_graph_state_helpers():
    cfg = GraphConfig(capacity=50, R=8, M=4)
    st = empty_state(cfg, device="cpu")
    want = rgraph.empty_state(RefConfig(capacity=50, R=8, M=4))
    for name in GraphState._fields:
        a, b = getattr(st, name), np.asarray(getattr(want, name))
        assert a.numpy().dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b)
    assert st.capacity == want.capacity == 50
    nb = st.neighbors.clone()
    nb[3, :4] = torch.tensor([1, 2, 5, 6], dtype=torch.int32)
    live = st.live.clone()
    live[:7] = True
    st = st._replace(neighbors=nb, live=live)
    ref_st = want._replace(neighbors=jnp.asarray(nb.numpy()), live=jnp.asarray(live.numpy()))
    np.testing.assert_array_equal(tgraph.degree(st).numpy(), np.asarray(rgraph.degree(ref_st)))
    assert int(tgraph.num_live(st)) == int(rgraph.num_live(ref_st)) == 7


@pytest.mark.parametrize("integer", [True, False])
def test_insert_batch_jit_matches_reference(ref, integer):
    snap, data = ref
    if integer:
        snap = _integer_books(snap)
    books = np.stack([np.asarray(cb, np.float32) for cb in snap["schemas"]])
    rng = np.random.RandomState(9)
    new = clustered_data(rng, 64, D)
    if integer:
        new = np.round(new * 4).astype(np.float32)
    slots = np.arange(snap["count"], snap["count"] + 64, dtype=np.int32)
    kw = dict(L_build=KW["L_build"], R=KW["R"], R_slack=RefConfig(**KW).R_slack, alpha=1.2)
    arrays = [snap[k] for k in ("neighbors", "codes", "versions", "live")]
    want = rins.insert_batch_jit(*(jnp.asarray(a) for a in arrays), jnp.asarray(books),
                                 jnp.asarray(new), jnp.asarray(slots), jnp.int32(snap["medoid"]),
                                 **kw)
    got = tins.insert_batch_jit(*(t(a) for a in arrays), t(books), t(new), t(slots),
                                int(snap["medoid"]), **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))  # codes
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # versions
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))  # live
    nb_got, nb_want = got[0].numpy(), np.asarray(want[0])
    if integer:
        np.testing.assert_array_equal(nb_got, nb_want)
        np.testing.assert_array_equal(got[4].hops.numpy(), np.asarray(want[4].hops))
        np.testing.assert_array_equal(got[4].cmps.numpy(), np.asarray(want[4].cmps))
    else:
        touched = ((nb_got != snap["neighbors"]) | (nb_want != snap["neighbors"])).any(1)
        same = (nb_got[touched] == nb_want[touched]).all(1).mean()
        assert same >= SAME_ROWS, f"rows equal in {same:.4f} of those touched"
    deg = (nb_got[slots] >= 0).sum(1)
    assert deg.min() >= 1
    np.testing.assert_array_equal(arrays[0], snap["neighbors"])  # inputs untouched
