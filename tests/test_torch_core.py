"""The port's core (``repro_torch.core``) against the JAX reference
(``repro.core``) on identical inputs, on the CPU: PQ with the reference's
codebooks, the packed bitmap, the batched greedy search (bit-equal with
integer-valued LUTs), RobustPrune, insert candidates, and the flat plans."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import clustered_data
from repro.core import DiskANNIndex as RefIndex
from repro.core import GraphConfig as RefConfig
from repro.core import flat as rflat
from repro.core import graph as rgraph
from repro.core import insert as rinsert
from repro.core import pq as rpq
from repro.core import prune as rprune
from repro.core import search as rsearch
from repro_torch.core import flat as tflat
from repro_torch.core import graph as tgraph
from repro_torch.core import insert as tinsert
from repro_torch.core import pq as tpq
from repro_torch.core import prune as tprune
from repro_torch.core import search as tsearch

N, D, M = 600, 32, 8


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def ref_index():
    """A small reference-built index whose two schemas coexist."""
    rng = np.random.RandomState(3)
    data = clustered_data(rng, N, D)
    cfg = RefConfig(capacity=N + 8, R=16, M=M, L_build=32, L_search=32,
                    bootstrap_sample=150, refine_sample=400, batch_size=50)
    idx = RefIndex(cfg, D, seed=0)
    idx.insert(list(range(N)), data)
    assert len(idx.schemas) == 2
    return idx, data


@pytest.fixture(scope="module")
def graph_arrays(ref_index):
    idx, _ = ref_index
    nb, codes, versions, live, vectors = (np.asarray(a) for a in idx.pv.materialize())
    return dict(neighbors=nb, codes=codes, versions=versions, live=live, vectors=vectors,
                medoid=idx.medoid,
                books=np.stack([np.asarray(s.codebooks) for s in idx.schemas]))


# ---------------------------------------------------------------------------
# pq
# ---------------------------------------------------------------------------


def _schemas(books):
    ref = [rpq.PQSchema(jnp.asarray(b), jnp.int32(i)) for i, b in enumerate(books)]
    port = [tpq.PQSchema(t(b), i) for i, b in enumerate(books)]
    return ref, port


def test_pq_with_reference_codebooks(graph_arrays):
    books = graph_arrays["books"]
    rs, ps = _schemas(books)
    rng = np.random.RandomState(0)
    x = rng.randn(40, D).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tpq.encode(ps[1], t(x)).numpy(),
                                  np.asarray(rpq.encode(rs[1], jnp.asarray(x))))
    codes = np.asarray(rpq.encode(rs[0], jnp.asarray(x)))
    np.testing.assert_allclose(tpq.decode(ps[0], t(codes)).numpy(),
                               np.asarray(rpq.decode(rs[0], jnp.asarray(codes))), **tol)
    for metric in ("l2", "ip"):
        lut = tpq.adc_lut(ps[0], t(x[0]), metric).numpy()
        np.testing.assert_allclose(lut, np.asarray(rpq.adc_lut(rs[0], jnp.asarray(x[0]), metric)),
                                   **tol)
    luts = tpq.multi_lut(ps, t(x[0])).numpy()
    rluts = np.asarray(rpq.multi_lut(tuple(rs), jnp.asarray(x[0])))
    np.testing.assert_allclose(luts, rluts, **tol)
    assert tpq.multi_lut(ps, t(x[:3])).shape == (3, 2, M, 256)
    versions = rng.randint(0, 2, (40,)).astype(np.uint8)
    np.testing.assert_allclose(
        tpq.adc_distance_versioned(t(rluts), t(codes), t(versions)).numpy(),
        np.asarray(rpq.adc_distance_versioned(jnp.asarray(rluts), jnp.asarray(codes),
                                              jnp.asarray(versions))), **tol)
    for fn in ("adc_distance", "adc_distance_onehot"):
        np.testing.assert_allclose(
            getattr(tpq, fn)(t(rluts[0]), t(codes)).numpy(),
            np.asarray(getattr(rpq, fn)(jnp.asarray(rluts[0]), jnp.asarray(codes))), **tol)
    y = rng.randn(25, D).astype(np.float32)
    for metric in ("l2", "ip"):
        np.testing.assert_allclose(
            tpq.pairwise_distance(t(x), t(y), metric).numpy(),
            np.asarray(rpq.pairwise_distance(jnp.asarray(x), jnp.asarray(y), metric)), **tol)
        np.testing.assert_allclose(
            tpq.exact_distance(t(x[:25]), t(y), metric).numpy(),
            np.asarray(rpq.exact_distance(jnp.asarray(x[:25]), jnp.asarray(y), metric)), **tol)


def test_kmeans_properties(graph_arrays):
    """k-means draws from a torch.Generator, so it is tested by its
    properties: shapes, codes in range, inertia never rising across Lloyd
    steps, determinism under a seed, refine keeps the shape and bumps the
    version."""
    data = t(graph_arrays["vectors"][:N])
    s1 = tpq.train_pq(torch.Generator().manual_seed(5), data, M, K=32, iters=6)
    s2 = tpq.train_pq(torch.Generator().manual_seed(5), data, M, K=32, iters=6)
    assert s1.codebooks.shape == (M, 32, D // M) and s1.version == 0
    assert torch.equal(s1.codebooks, s2.codebooks)
    codes = tpq.encode(s1, data)
    assert codes.dtype == torch.uint8 and int(codes.max()) < 32

    def inertia(cent):
        rec = tpq.decode(tpq.PQSchema(cent), tpq.encode(tpq.PQSchema(cent), data))
        return float(((rec - data) ** 2).sum())

    cent = s1.codebooks
    prev = inertia(cent)
    for _ in range(4):
        cent = tpq._lloyd(data, cent, 1)
        cur = inertia(cent)
        assert cur <= prev * (1 + 1e-6)
        prev = cur
    r = tpq.refine_pq(None, s1, data, iters=2)
    assert r.version == 1 and r.codebooks.shape == s1.codebooks.shape
    assert inertia(r.codebooks) <= inertia(s1.codebooks) * (1 + 1e-6)
    small = tpq.train_pq(torch.Generator().manual_seed(0), data[:10], M, K=16, iters=2)
    assert small.codebooks.shape == (M, 16, D // M)  # S < K draws with replacement


# ---------------------------------------------------------------------------
# bitmap
# ---------------------------------------------------------------------------


def test_bitmap_ops_bit_equal():
    rng = np.random.RandomState(1)
    cap = 300
    bm_ref = rgraph.bitmap_init(cap)
    bm = tgraph.bitmap_init(cap)
    for _ in range(5):
        ids = rng.randint(-3, cap, (40,)).astype(np.int32)  # negatives and duplicates
        bm_ref = rgraph.bitmap_set(bm_ref, jnp.asarray(ids))
        bm = tgraph.bitmap_set(bm, t(ids)[None])
        np.testing.assert_array_equal(tgraph.bitmap_to_numpy(bm)[0], np.asarray(bm_ref))
        probe = rng.randint(-2, cap, (64,)).astype(np.int32)
        np.testing.assert_array_equal(
            tgraph.bitmap_test(bm, t(probe)[None]).numpy()[0],
            np.asarray(rgraph.bitmap_test(bm_ref, jnp.asarray(probe))))
    words = np.asarray(bm_ref)
    np.testing.assert_array_equal(tgraph.bitmap_to_numpy(tgraph.bitmap_from_numpy(words)), words)
    # the search loop's fast OR: distinct unset ids only
    fresh = np.setdiff1d(np.arange(cap), np.nonzero(np.unpackbits(
        words.view(np.uint8), bitorder="little"))[0])[:30].astype(np.int32)
    np.testing.assert_array_equal(
        tgraph.bitmap_to_numpy(tgraph.bitmap_or_new(bm, t(fresh)[None]))[0],
        np.asarray(rgraph.bitmap_set(bm_ref, jnp.asarray(fresh))))


def test_mask_duplicates_matches_reference():
    rng = np.random.RandomState(2)
    ids = rng.randint(-2, 12, (6, 30)).astype(np.int32)
    want = np.stack([np.asarray(rsearch.mask_duplicates(jnp.asarray(r))) for r in ids])
    np.testing.assert_array_equal(tsearch.mask_duplicates(t(ids)).numpy(), want)


# ---------------------------------------------------------------------------
# greedy search: bit-equal with integer-valued LUTs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("filtered", [False, True], ids=["plain", "beta"])
@pytest.mark.parametrize("W", [1, 2, 4])
def test_greedy_search_bit_equal(graph_arrays, W, filtered):
    """Sums of M small integers are exact in any order, so every output of
    the batched loop must equal the vmapped reference bit for bit -- this
    pins the tie-break rules of the frontier pick, the merge and the dedup."""
    ga = graph_arrays
    rng = np.random.RandomState(10 * W + filtered)
    B, L = 6, 24
    luts = rng.randint(0, 16, (B, 2, M, 256)).astype(np.float32)
    kw = dict(L=L, beam_width=W)
    fb_ref = fb = None
    if filtered:
        mask = rng.rand(ga["neighbors"].shape[0]) < 0.4
        words = RefIndex._pack_bits(mask)
        fb_ref = jnp.asarray(np.broadcast_to(words, (B,) + words.shape))
        fb = tgraph.bitmap_from_numpy(np.broadcast_to(words, (B,) + words.shape))
        kw["beta"] = 0.5
    ref = rsearch.batch_greedy_search(
        *(jnp.asarray(ga[k]) for k in ("neighbors", "codes", "versions", "live")),
        jnp.asarray(luts), jnp.int32(ga["medoid"]), filter_bits=fb_ref, **kw)
    got = tsearch.batch_greedy_search(
        *(t(ga[k]) for k in ("neighbors", "codes", "versions", "live")),
        t(luts), ga["medoid"], filter_bits=fb, **kw)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int(got.n_hops.max()) > 1



@pytest.mark.parametrize("W", [1, 4])
def test_fixed_round_search_equals_the_synced_loop(graph_arrays, W, monkeypatch):
    """The round loop without its per-round sync (forced, as fake inputs
    run it) runs exactly max_hops rounds and gives the synced loop's
    result bit for bit: rounds past the last active lane change nothing.
    Under FakeTensorMode the loop runs without a sync."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    ga = graph_arrays
    rng = np.random.RandomState(7 + W)
    luts = rng.randint(0, 16, (6, 2, M, 256)).astype(np.float32)
    args = [t(ga[k]) for k in ("neighbors", "codes", "versions", "live")] + [t(luts)]
    synced = tsearch.batch_greedy_search(*args, ga["medoid"], L=24, beam_width=W)
    with monkeypatch.context() as m:  # the loop as it runs on fake inputs
        m.setattr(tsearch, "_is_fake", lambda x: True)
        fixed = tsearch.batch_greedy_search(*args, ga["medoid"], L=24, beam_width=W)
    for name in synced._fields:
        assert torch.equal(getattr(synced, name), getattr(fixed, name)), name
    assert int(synced.n_hops.max()) < tsearch.default_max_hops(24, W)  # rounds to spare
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = tsearch.batch_greedy_search(*(mode.from_tensor(a) for a in args), ga["medoid"],
                                           L=24, beam_width=W)
    assert [tuple(a.shape) for a in fake] == [tuple(a.shape) for a in synced]


def test_bucketing_and_candidates(graph_arrays):
    assert tsearch.next_bucket(3) == rsearch.next_bucket(3) == 4
    assert tsearch.next_bucket(130) == rsearch.next_bucket(130) == 192
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(tsearch.pad_batch(t(a), 4).numpy(),
                                  np.asarray(rsearch.pad_batch(jnp.asarray(a), 4)))
    np.testing.assert_array_equal(tsearch.pad_batch_np(a, 4), rsearch.pad_batch_np(a, 4))
    ga = graph_arrays
    luts = np.random.RandomState(4).randint(0, 9, (3, 2, M, 256)).astype(np.float32)
    arrs = ("neighbors", "codes", "versions", "live")
    ref = rsearch.search_candidates(rsearch.bucketed_batch_greedy_search(
        *(jnp.asarray(ga[k]) for k in arrs), jnp.asarray(luts), jnp.int32(ga["medoid"]), L=16))
    got = tsearch.search_candidates(tsearch.bucketed_batch_greedy_search(
        *(t(ga[k]) for k in arrs), t(luts), ga["medoid"], L=16))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# prune + insert
# ---------------------------------------------------------------------------


def test_prune_with_vectors_ids_equal():
    rng = np.random.RandomState(3)
    B, C, Dp, R = 5, 40, 8, 8
    p = rng.randn(B, Dp).astype(np.float32)
    vecs = rng.randn(B, C, Dp).astype(np.float32)
    ids = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    ids[:, 5] = -1
    ids[:, 7] = ids[:, 3]  # duplicate
    ids[1, 2] = 100  # self id of row 1
    self_id = np.array([-1, 100, -1, -1, 17], np.int32)
    for metric in ("l2", "ip"):
        got = tprune.prune_with_vectors(t(p), t(ids), t(vecs), alpha=1.2, R=R, metric=metric,
                                        self_id=t(self_id)).numpy()
        for b in range(B):
            want = np.asarray(rprune.prune_with_vectors(
                jnp.asarray(p[b]), jnp.asarray(ids[b]), jnp.asarray(vecs[b]), alpha=1.2, R=R,
                metric=metric, self_id=int(self_id[b])))
            np.testing.assert_array_equal(got[b], want)


def test_insert_candidates_and_prune_batch(graph_arrays, ref_index):
    ga = graph_arrays
    _, data = ref_index
    rng = np.random.RandomState(6)
    new = (data[rng.choice(N, 8, replace=False)] + 0.05 * rng.randn(8, D)).astype(np.float32)
    arrs = ("neighbors", "codes", "versions", "live")
    rc, rd, rst = rinsert.insert_candidates(
        *(jnp.asarray(ga[k]) for k in arrs), jnp.asarray(ga["books"]), jnp.asarray(new),
        jnp.int32(ga["medoid"]), L_build=32)
    pc, pd, pst = tinsert.insert_candidates(
        *(t(ga[k]) for k in arrs), t(ga["books"]), t(new), ga["medoid"], L_build=32)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pst.hops.numpy(), np.asarray(rst.hops))
    np.testing.assert_array_equal(pst.cmps.numpy(), np.asarray(rst.cmps))
    rn = rinsert.prune_batch(jnp.asarray(ga["codes"]), jnp.asarray(ga["versions"]),
                             jnp.asarray(ga["books"]), jnp.asarray(new), rc, R=16, alpha=1.2)
    pn = tinsert.prune_batch(t(ga["codes"]), t(ga["versions"]), t(ga["books"]), t(new), pc,
                             R=16, alpha=1.2)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))


# ---------------------------------------------------------------------------
# brute force, Q-Flat, rerank
# ---------------------------------------------------------------------------


def test_flat_plans_ids_equal(graph_arrays):
    ga = graph_arrays
    rng = np.random.RandomState(8)
    q = (ga["vectors"][rng.choice(N, 6)] + 0.05 * rng.randn(6, D)).astype(np.float32)
    vec, live = ga["vectors"], ga["live"]
    few = live & (np.arange(len(live)) % 120 == 0)  # 5 matches < k: -1 padding
    for mask in (live, few):
        ri, rd = rflat.brute_force(jnp.asarray(q), jnp.asarray(vec), jnp.asarray(mask), k=10)
        pi, pd = tflat.brute_force(t(q), t(vec), t(mask), k=10)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=2e-3, atol=2e-3)
    assert (pi.numpy()[:, 5:] == -1).all()

    _, ps = _schemas(ga["books"])
    luts = tpq.multi_lut(ps, t(q)).numpy()
    few = live & (np.arange(len(live)) % 40 == 0)  # 15 matches < k' = 20
    for mask in (live, few):
        ri, rd = rflat.qflat_scan(jnp.asarray(luts), jnp.asarray(ga["codes"]),
                                  jnp.asarray(ga["versions"]), jnp.asarray(mask), kprime=20)
        pi, pd = tflat.qflat_scan(t(luts), t(ga["codes"]), t(ga["versions"]), t(mask), kprime=20)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=1e-5, atol=1e-5)
    assert (pi.numpy()[:, 15:] == -1).all()

    cand = np.array(ri)
    cand[:, 3] = cand[:, 1]  # a duplicate candidate is scored once
    short = cand.copy()
    short[:, 6:] = -1  # 5 distinct candidates < k: -1 padding
    for c in (cand, short):
        ri, rd = rflat.rerank(jnp.asarray(q), jnp.asarray(c), jnp.asarray(vec), k=10)
        pi, pd = tflat.rerank(t(q), t(c), t(vec), k=10)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=1e-5, atol=1e-5)
    assert (pi.numpy()[:, 5:] == -1).all() and (pi.numpy()[:, :5] >= 0).all()
