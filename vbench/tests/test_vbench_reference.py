"""The reference's exact top k against a NumPy brute force, and the judge's
comparisons on hand-made answers."""
import numpy as np
import pytest
import torch

from vbench import judge, load, reference


def brute(q, x, k, n=None):
    d = ((q[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1)
    if n is not None:
        d[:, n:] = np.inf
    return np.argsort(d, axis=1, kind="stable")[:, :k], np.sort(d, axis=1)[:, :k]


@pytest.fixture
def small():
    rng = np.random.RandomState(3)
    return rng.randn(700, 24).astype(np.float32), rng.randn(37, 24).astype(np.float32)


def test_exact_topk_equals_numpy(small, monkeypatch):
    x, q = small
    monkeypatch.setattr(reference, "ROW_BLOCK", 256)  # several row blocks merged
    monkeypatch.setattr(reference, "QUERY_BLOCK", 16)
    ids, d = reference.exact_topk(q, x, 10, "cpu")
    want, wd = brute(q, x, 10)
    assert np.array_equal(ids, want)
    np.testing.assert_allclose(d, wd, rtol=1e-4, atol=1e-4)


def test_truth_over_the_documents_acknowledged_when_asked(small):
    x, q = small
    rows = np.arange(len(q)) % 11  # queries asked more than once
    n = np.where(np.arange(len(q)) % 2 == 0, 650, 300)
    gt = judge.truth(q, x, rows, n, 5, "cpu")
    for b in range(len(q)):
        assert np.array_equal(gt[b], brute(q[rows[b]:rows[b] + 1], x, 5, n=n[b])[0][0])


def test_pair_dists_and_tf32(small):
    x, q = small
    ids = np.tile(np.arange(5), (len(q), 1))
    ids[0, 2] = -1
    d = reference.pair_dists(q, x, ids, "cpu")
    want = ((q[:, None, :].astype(np.float64) - x[ids.clip(0)]) ** 2).sum(-1)
    assert np.isnan(d[0, 2])
    np.testing.assert_allclose(np.nan_to_num(d), np.where(ids >= 0, want, 0.0), rtol=1e-12)
    t = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10, 3.0])
    assert reference.round_tf32(t).tolist() == [1.0, 1.0 + 2 ** -10, 3.0]
    # the control's TF32 distances differ from float32's: the gap it shows
    f32 = reference.sq_dists(torch.from_numpy(q), torch.from_numpy(x))
    tf32 = reference.sq_dists(torch.from_numpy(q), torch.from_numpy(x), "tf32")
    assert (tf32 - f32).abs().max() > 1e-3


def test_bad_rows():
    ids = np.array([[0, 1, 2], [0, 0, 2], [0, -1, 2], [0, 9, 2], [2, 1, 0], [0, 1, 2]])
    d = np.array([[1, 2, 3], [1, 2, 3], [1, np.inf, 3], [1, 2, 3], [1, 2, 3], [3, 2, 1]], float)
    n = np.full(6, 5)
    assert judge.bad_rows(ids, d, n).tolist() == [False, True, True, True, False, True]
    # fewer documents than k: a missing id is no fault
    assert not judge.bad_rows(np.array([[0, 1, -1]]), np.array([[1.0, 2.0, np.inf]]),
                              np.array([2]))[0]


class _Inputs:
    def __init__(self, corpus, queries):
        self.corpus, self.queries, self.extra = corpus, queries, corpus[:0]


def _ops(*names):
    from vbench import harness

    return {n: harness.load_module(harness.HERE / "ops" / f"{n}.py") for n in names}


def test_judge_reads_recall_and_gaps(small):
    x, q = small
    ids, d = reference.exact_topk(q, x, 10, "cpu")
    good = [load.Request("search", 0.0, 1.0, np.arange(len(q)), len(x), ids, d)]
    ctx = judge.Context(_Inputs(x, q), {"limits": {"recall": 0.9, "dist_gap": 1e-4,
                                                   "unfindable": 1e-3}}, "cpu")
    ops = _ops("search", "serve", "insert")
    quality, checks = judge.judge(good, ops, {}, ctx)
    assert quality["recall"] == 1.0 and all(c["holds"] for c in checks.values())
    assert set(checks) == {"recall", "dist_gap", "bad_rows", "not_served"}
    # half the answers replaced by the next query's: recall falls, the
    # distances no longer belong to the ids
    bad_ids = ids.copy()
    bad_ids[::2] = ids[1::2][: len(ids[::2])] if len(q) % 2 == 0 else np.roll(ids, 1, 0)[::2]
    bad = [load.Request("search", 0.0, 1.0, np.arange(len(q)), len(x), bad_ids, d)]
    quality, checks = judge.judge(bad, ops, {}, ctx)
    assert not checks["recall"]["holds"] and not checks["dist_gap"]["holds"]
    # a throttled request is not served
    thr = good + [load.Request("serve", 0.0, 1.0, np.arange(1), len(x), status=429)]
    _, checks = judge.judge(thr, ops, {}, ctx)
    assert not checks["not_served"]["holds"]
    # an insert's read-back: a lost write, and writes a search does not find
    wrote = good + [load.Request("insert", 0.0, 1.0, docs=100)]
    _, checks = judge.judge(wrote, ops, {"insert": {"lost": 0, "unfindable": 0.0}}, ctx)
    assert checks["lost_writes"]["holds"] and checks["unfindable"]["holds"]
    _, checks = judge.judge(wrote, ops, {"insert": {"lost": 1, "unfindable": 0.0}}, ctx)
    assert not checks["lost_writes"]["holds"]
    _, checks = judge.judge(wrote, ops, {"insert": {"lost": 0, "unfindable": 0.01}}, ctx)
    assert not checks["unfindable"]["holds"]
