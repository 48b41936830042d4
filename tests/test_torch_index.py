"""The port's ``DiskANNIndex`` as a whole against the JAX reference, on the
CPU: the reference's state restored into the port and searched by every plan,
a port-built index with the reference's codebooks, the snapshot round trip,
and the refusal to fall back to the CPU."""
import numpy as np
import pytest
import torch

from conftest import clustered_data
from repro.core import DiskANNIndex as RefIndex
from repro.core import GraphConfig as RefConfig
from repro.core import recall as rrec
from repro_torch.core import DiskANNIndex, GraphConfig
from repro_torch.core import pq as tpq

N, D = 2000, 32
KW = dict(capacity=N + 64, R=24, M=16, L_build=48, L_search=48, bootstrap_sample=256,
          refine_sample=1200, batch_size=64)

# XLA and torch round the LUT einsum and the M-term ADC sums in different
# orders, which can reorder near-ties in the beam and so the final ids: the
# restored index is held to its recall within 0.01 and to equal ids in 99 % of
# the (query, rank) slots rather than bit for bit.
RECALL_TOL = 0.01
SAME_SLOTS = 0.99


@pytest.fixture(scope="module")
def ref():
    rng = np.random.RandomState(7)
    data = clustered_data(rng, N, D)
    idx = RefIndex(RefConfig(**KW), D, seed=0)
    idx.insert(list(range(N)), data)
    assert len(idx.schemas) == 2  # refine_sample < N: two schema versions coexist
    pick = np.random.RandomState(99).choice(N, 32, replace=False)
    q = (data[pick] + 0.05 * np.random.RandomState(5).randn(32, D)).astype(np.float32)
    gt = rrec.ground_truth(q, data, np.ones(N, bool), 10)
    return idx, data, q, gt


@pytest.fixture(scope="module")
def restored(ref):
    idx, *_ = ref
    port = DiskANNIndex(GraphConfig(**KW), D, device="cpu")
    port.restore(idx.snapshot())
    return port


def _filter(mode):
    slots = np.arange(N + 64)
    if mode == "qflat":
        return slots % 5 == 0  # 400 matches: below the Q-Flat threshold
    return slots % 2 == 0


# "beta_unlisted": a mode the planner does not name runs as beta in both
# packages and is reported under its own name
@pytest.mark.parametrize("mode", ["search", "beta", "post", "qflat", "brute", "beta_unlisted"])
def test_restored_index_matches_reference(ref, restored, mode):
    idx, data, q, gt = ref
    if mode == "search":
        want = idx.search(q, k=10)
        got = restored.search(q, k=10)
        truth = gt
    else:
        mask = _filter(mode)
        want = idx.filtered_search(q, 10, mask, mode=mode)
        got = restored.filtered_search(q, 10, mask, mode=mode)
        assert got[2].plan == want[2].plan == mode
        truth = rrec.ground_truth(q, data, mask[:N], 10)
    assert got[0].shape == (32, 10)
    same = float((got[0] == want[0]).mean())
    assert same >= SAME_SLOTS, f"{mode}: ids equal in {same:.4f} of slots"
    r_got, r_want = rrec.recall_at_k(got[0], truth, 10), rrec.recall_at_k(want[0], truth, 10)
    assert abs(r_got - r_want) <= RECALL_TOL, (mode, r_got, r_want)
    ok = got[0] >= 0
    np.testing.assert_allclose(got[1][ok], want[1][ok], rtol=1e-4, atol=1e-4)
    if mode in ("search", "beta", "post", "beta_unlisted"):
        assert got[2].hops > 1 and got[2].cmps > 1
        assert abs(got[2].hops - want[2].hops) <= 0.5
    # the paged tier (fully resident in both) counts the pages each plan
    # touched: equal on equal ids, within 1 % where a near-tie moved a
    # candidate to another page
    tol = 0.0 if (got[0] == want[0]).all() else 0.01
    assert got[2].tier_hits > 0
    assert got[2].tier_hits == pytest.approx(want[2].tier_hits, rel=tol, abs=0.0)
    assert got[2].tier_misses == pytest.approx(want[2].tier_misses, rel=tol, abs=0.0)


def test_port_built_index_with_reference_codebooks(ref, monkeypatch):
    """The port's own insert path (bootstrap, mini-batch build, orphan repair,
    reverse edges, batched overflow prunes, re-quantization) with the
    reference's codebooks injected, since the k-means draws differ."""
    idx, data, q, gt = ref
    books = [torch.from_numpy(np.array(s.codebooks)) for s in idx.schemas]
    monkeypatch.setattr(tpq, "train_pq", lambda gen, sample, M, **kw: tpq.PQSchema(books[0], 0))
    monkeypatch.setattr(tpq, "refine_pq", lambda gen, schema, sample, **kw: tpq.PQSchema(books[1], 1))
    port = DiskANNIndex(GraphConfig(**KW), D, seed=0, device="cpu")
    port.insert(list(range(N)), data)
    assert len(port.schemas) == 2 and port.medoid == idx.medoid
    np.testing.assert_array_equal(port.pv.codes[:N], idx.pv.codes[:N])
    np.testing.assert_array_equal(port.pv.versions[:N], idx.pv.versions[:N])
    deg = (port.pv.neighbors[:N] >= 0).sum(1)
    assert deg.min() >= 1 and deg.max() <= port.cfg.R_slack
    r_port = rrec.recall_at_k(port.search(q, k=10)[0], gt, 10)
    r_ref = rrec.recall_at_k(idx.search(q, k=10)[0], gt, 10)
    assert abs(r_port - r_ref) <= 0.02, (r_port, r_ref)
    assert r_port >= 0.85


def test_snapshot_round_trip_is_exact(ref, restored):
    idx, *_ = ref
    want = idx.snapshot()
    got = restored.snapshot()
    assert set(got) == set(want)
    for key in ("neighbors", "codes", "versions", "live", "vectors", "slot_to_doc"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (got["count"], got["medoid"], got["graph_built"]) == (
        want["count"], want["medoid"], want["graph_built"])
    assert len(got["schemas"]) == len(want["schemas"]) == 2
    for a, b in zip(got["schemas"], want["schemas"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    again = DiskANNIndex(GraphConfig(**KW), D, device="cpu")
    again.restore(got)
    assert again.doc_to_slot == restored.doc_to_slot
    for key in ("neighbors", "codes", "vectors"):
        np.testing.assert_array_equal(again.snapshot()[key], got[key])


def test_requantize_steps_match_reference(ref):
    """Background re-quantization on copies of the same state: every chunk
    re-encodes with the newest schema (codes bit-equal to the reference's),
    and the last step retires the old schema."""
    idx, data, q, gt = ref
    snap = idx.snapshot()
    want = RefIndex(RefConfig(**KW), D)
    want.restore(snap)
    got = DiskANNIndex(GraphConfig(**KW), D, device="cpu")
    got.restore(snap)
    steps = 0
    while not got.requantize_step(chunk=512):
        assert not want.requantize_step(chunk=512)
        steps += 1
        np.testing.assert_array_equal(got.pv.codes, want.pv.codes)
        np.testing.assert_array_equal(got.pv.versions, want.pv.versions)
    assert want.requantize_step(chunk=512)
    assert steps == -(-N // 512)
    assert len(got.schemas) == len(want.schemas) == 1
    assert not got.pv.versions.any()
    np.testing.assert_array_equal(got.snapshot()["schemas"][0], np.asarray(want.schemas[0].codebooks))
    r_got = rrec.recall_at_k(got.search(q, k=10)[0], gt, 10)
    r_want = rrec.recall_at_k(want.search(q, k=10)[0], gt, 10)
    assert abs(r_got - r_want) <= RECALL_TOL


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiskANNIndex(GraphConfig(capacity=64, M=4), 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiskANNIndex(GraphConfig(capacity=64, M=4), 16, device="cuda")
    DiskANNIndex(GraphConfig(capacity=64, M=4), 16, device="cpu")  # asked for: fine


def test_restored_index_wide_k_matches_reference(ref, restored):
    """A search whose rerank window k' = 5k exceeds 1024 (k=210: k' = 1050),
    so the beam of L = k' entries is merged by the topk_select form for L >
    1024 on the card: ids equal to the reference's in 99 % of the slots,
    recall within 0.01, distances at 1e-4."""
    idx, data, q, _ = ref
    k, q8 = 210, q[:8]
    want = idx.search(q8, k=k)
    got = restored.search(q8, k=k)
    assert got[0].shape == (8, k) and got[2].full_reads == 1050
    same = float((got[0] == want[0]).mean())
    assert same >= SAME_SLOTS, f"ids equal in {same:.4f} of slots"
    truth = rrec.ground_truth(q8, data, np.ones(N, bool), k)
    r_got, r_want = rrec.recall_at_k(got[0], truth, k), rrec.recall_at_k(want[0], truth, k)
    assert abs(r_got - r_want) <= RECALL_TOL, (r_got, r_want)
    ok = got[0] >= 0
    np.testing.assert_allclose(got[1][ok], want[1][ok], rtol=1e-4, atol=1e-4)


def test_plain_providers_count_like_the_reference(monkeypatch):
    """A plain port index and a plain reference index (the reference's
    codebooks injected, since the k-means draws differ) report the same
    write epoch after the same inserts, and the same paged-tier hits and
    misses for the same searches, with the tier fully resident and then at
    a budget of a quarter of its pages."""
    n = 300
    data = clustered_data(np.random.RandomState(3), n, D)
    kw = dict(KW, capacity=n + 64, bootstrap_sample=64, refine_sample=200, batch_size=40)
    want = RefIndex(RefConfig(**kw), D, seed=0)
    want.insert(list(range(n)), data)
    books = [torch.from_numpy(np.array(s.codebooks)) for s in want.schemas]
    monkeypatch.setattr(tpq, "train_pq", lambda gen, sample, M, **k: tpq.PQSchema(books[0], 0))
    monkeypatch.setattr(tpq, "refine_pq", lambda gen, schema, sample, **k: tpq.PQSchema(books[1], 1))
    got = DiskANNIndex(GraphConfig(**kw), D, seed=0, device="cpu")
    got.insert(list(range(n)), data)
    np.testing.assert_array_equal(got.pv.neighbors, want.pv.neighbors)
    assert got.pv.write_count == want.pv.write_count > n
    got.delete([5, 17])
    want.delete([5, 17])
    got.consolidate()
    want.consolidate()
    assert got.pv.write_count == want.pv.write_count
    q = (data[:4] + 0.01).astype(np.float32)
    for budget in (None, got.pv.pages.n_pages // 4):
        got.pv.pages.set_budget(budget)
        want.pv.pages.set_budget(budget)
        for _ in range(2):
            g_ids, _, g_st = got.search(q, k=10)
            w_ids, _, w_st = want.search(q, k=10)
            np.testing.assert_array_equal(g_ids, w_ids)
            assert (g_st.tier_hits, g_st.tier_misses) == (w_st.tier_hits, w_st.tier_misses)
        assert (got.pv.pages.hits, got.pv.pages.misses) == (want.pv.pages.hits,
                                                            want.pv.pages.misses)
    assert g_st.tier_misses > 0
