"""Paginated search (§3.2, Fig 3) of the port against the JAX reference, on
the CPU. With integer-valued LUTs every ADC sum is exact in any order, so
the pages and every ``PageState`` field must equal the reference's bit for
bit (the visited bitmap compared as the reference's uint32 words); through
the index, on float data, the page ids are held equal in 99 % of slots."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import clustered_data
from repro.core import DiskANNIndex as RefIndex
from repro.core import GraphConfig as RefConfig
from repro.core import paginate as rpag
from repro.core import recall as rrec
from repro_torch.core import DiskANNIndex, GraphConfig
from repro_torch.core import graph as tgraph
from repro_torch.core import index as tindex
from repro_torch.core import paginate as tpag

N, D = 1200, 16
KW = dict(capacity=N + 64, R=16, M=8, L_build=32, L_search=32, bootstrap_sample=128,
          refine_sample=700, batch_size=64)
SAME_SLOTS = 0.99


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def ref():
    rng = np.random.RandomState(5)
    data = clustered_data(rng, N, D)
    idx = RefIndex(RefConfig(**KW), D, seed=0)
    idx.insert(list(range(N)), data)
    assert len(idx.schemas) == 2
    return idx, data


def _arrays(snap):
    return [snap[k] for k in ("neighbors", "codes", "versions", "live")]


def _states_equal(got: tpag.PageState, want: rpag.PageState, what: str):
    for name in tpag.PageState._fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        a = tgraph.bitmap_to_numpy(a) if name == "bitmap" else a.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}: {name} {a.dtype} {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")


def _pages(snap, luts, *, L, backup_cap, k, pages, W, words=None, beta=1.0):
    """The same pages through both packages; every page's ids, dists and
    state compared. Returns the last states."""
    arrays = _arrays(snap)
    start = int(snap["medoid"])
    want = rpag.start_pagination(snap["neighbors"].shape[0], L, backup_cap,
                                 jnp.asarray(snap["codes"]), jnp.asarray(snap["versions"]),
                                 jnp.asarray(luts), jnp.int32(start))
    got = tpag.start_pagination(snap["neighbors"].shape[0], L, backup_cap, t(snap["codes"]),
                                t(snap["versions"]), t(luts), start)
    _states_equal(got, want, "start")
    rkw = dict(k=k, beam_width=W, beta=beta)
    tkw = dict(k=k, beam_width=W, beta=beta)
    if words is not None:
        rkw.update(has_filter=True, filter_bits=jnp.asarray(words))
        tkw.update(filter_bits=tgraph.bitmap_from_numpy(words))
    for i in range(pages):
        r_ids, r_d, want = rpag.next_page(*(jnp.asarray(a) for a in arrays), jnp.asarray(luts),
                                          want, **rkw)
        g_ids, g_d, got = tpag.next_page(*(t(a) for a in arrays), t(luts), got, **tkw)
        np.testing.assert_array_equal(g_ids.numpy(), np.asarray(r_ids), err_msg=f"page {i}")
        np.testing.assert_array_equal(g_d.numpy(), np.asarray(r_d), err_msg=f"page {i}")
        _states_equal(got, want, f"page {i}")
    return got, want


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("filtered", [False, True])
def test_next_page_bit_equal_integer_luts(ref, W, filtered):
    idx, _ = ref
    snap = idx.snapshot()
    rng = np.random.RandomState(10 * W + filtered)
    luts = rng.randint(0, 16, (2, KW["M"], 256)).astype(np.float32)
    words = None
    if filtered:
        words = RefIndex._pack_bits(rng.rand(snap["neighbors"].shape[0]) < 0.4)
    got, _ = _pages(snap, luts, L=24, backup_cap=tindex.PAGE_BACKUP_CAP, k=6, pages=4, W=W,
                    words=words, beta=0.5 if filtered else 1.0)
    assert int(got.hops) > 4 and int(got.dropped) == 0


def test_tiny_backup_cap_counts_dropped(ref):
    idx, _ = ref
    luts = np.random.RandomState(3).randint(0, 16, (2, KW["M"], 256)).astype(np.float32)
    got, _ = _pages(idx.snapshot(), luts, L=16, backup_cap=8, k=4, pages=3, W=4)
    assert int(got.dropped) > 0


def test_exhausted_after_draining():
    """A ring of 40 nodes, drained by pages of 8: both packages report
    exhausted at the same page, and the pages hold every node once."""
    n, R_slack = 40, 4
    nb = np.full((n, R_slack), -1, np.int32)
    nb[:, 0] = (np.arange(n) + 1) % n
    nb[:, 1] = (np.arange(n) - 1) % n
    codes = np.random.RandomState(0).randint(0, 16, (n, 4)).astype(np.uint8)
    snap = dict(neighbors=nb, codes=codes, versions=np.zeros(n, np.uint8), live=np.ones(n, bool),
                medoid=0)
    luts = np.random.RandomState(1).randint(0, 9, (1, 4, 16)).astype(np.float32)
    arrays = _arrays(snap)
    want = rpag.start_pagination(n, 8, 16, jnp.asarray(snap["codes"]),
                                 jnp.asarray(snap["versions"]), jnp.asarray(luts), jnp.int32(0))
    got = tpag.start_pagination(n, 8, 16, t(snap["codes"]), t(snap["versions"]), t(luts), 0)
    seen = []
    for _ in range(8):
        assert bool(tpag.exhausted(got)) == bool(rpag.exhausted(want))
        if bool(tpag.exhausted(got)):
            break
        r_ids, _, want = rpag.next_page(*(jnp.asarray(a) for a in arrays), jnp.asarray(luts),
                                        want, k=8)
        g_ids, _, got = tpag.next_page(*(t(a) for a in arrays), t(luts), got, k=8)
        np.testing.assert_array_equal(g_ids.numpy(), np.asarray(r_ids))
        seen += [int(i) for i in g_ids if i >= 0]
    assert bool(tpag.exhausted(got)) and bool(rpag.exhausted(want))
    assert sorted(seen) == list(range(n))


@pytest.mark.parametrize("rerank", [True, False])
def test_index_next_page_matches_reference(ref, rerank):
    idx, data = ref
    port = DiskANNIndex(GraphConfig(**KW), D, device="cpu")
    port.restore(idx.snapshot())
    slot_filter = np.arange(KW["capacity"]) % 3 != 0
    q = (data[np.random.RandomState(8).choice(N, 6, replace=False)] + 0.01).astype(np.float32)
    same, total = 0, 0
    for i, qq in enumerate(q):
        sf = slot_filter if i % 2 else None
        st_w, st_g = idx.start_pagination(qq), port.start_pagination(qq)
        for _ in range(3):
            prev = st_g
            w_ids, w_d, st_w = idx.next_page(qq, st_w, 5, rerank=rerank, slot_filter=sf)
            g_ids, g_d, st_g = port.next_page(qq, st_g, 5, rerank=rerank, slot_filter=sf)
            same += int((w_ids == g_ids).sum())
            total += w_ids.size
            ok = (g_ids >= 0) & (g_ids == w_ids)
            np.testing.assert_allclose(g_d[ok], w_d[ok], rtol=1e-4, atol=1e-4)
            if sf is not None:
                assert slot_filter[g_ids[g_ids >= 0]].all()
            stats = port.page_stats(prev, st_g, 5, rerank=rerank)
            assert stats.plan == "paginated" and stats.full_reads == (5 if rerank else 0)
            assert stats.hops >= 1 and stats.cmps >= 0 and stats.expansions >= stats.hops
            # the paged tier (fully resident in both) counts the rerank's
            # pages: equal on equal ids, within 1 % where a near-tie moved one
            tol = 0.0 if (g_ids == w_ids).all() else 0.01
            for got, want in zip(port.last_page_tier, idx.last_page_tier):
                assert got == pytest.approx(want, rel=tol, abs=0.0)
            if not rerank:
                assert port.last_page_tier == (0.0, 0.0)  # no rerank reads no vector
    assert same / total >= SAME_SLOTS, f"page ids equal in {same / total:.4f} of slots"


def test_paginated_search_disjoint_and_ordered(ref):
    """Four pages never repeat a result, hold at least 15 of them, and their
    union overlaps the exact top 20 by >= 0.6 (the reference's own test)."""
    idx, data = ref
    port = DiskANNIndex(GraphConfig(**KW), D, device="cpu")
    port.restore(idx.snapshot())
    rng = np.random.RandomState(55)
    q = (data[rng.choice(N, 1)] + 0.05 * rng.randn(1, D)).astype(np.float32)[0]
    state = port.start_pagination(q, L=32)
    seen = set()
    for _ in range(4):
        ids, dists, state = port.next_page(q, state, k=5, rerank=False)
        page = [i for i in ids.tolist() if i >= 0]
        assert not set(page) & seen, "pages must not repeat results"
        assert (np.diff(dists[ids >= 0]) >= 0).all()
        seen |= set(page)
    assert len(seen) >= 15
    gt = rrec.ground_truth(q[None], data, np.ones(N, bool), 20)[0]
    overlap = len(seen & set(gt.tolist())) / 20
    assert overlap >= 0.6, overlap
