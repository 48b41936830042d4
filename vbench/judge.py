"""What decides ``correct``: every answer the window produced, held against
the reference, and each op's own checks (an insert's read-back).

The numbers compared for the answers of the ops that give k nearest
neighbours (``KNN = True``), each against its limit from the
configuration's ``limits``:

- ``recall``: mean recall@k of all answers against the reference's exact
  top k over the documents acknowledged when each query was sent (the beam
  search in PQ space and its merges);
- ``dist_gap``: the largest relative gap between a returned distance and the
  reference's exact distance of the returned id (the full-precision
  rerank), at most the limit;
- ``bad_rows``: answers with a missing, unknown or repeated id, or distances
  out of order (the merges, the fan-out's among them): none;
- ``not_served``: requests answered with anything but 200: none.
"""
from __future__ import annotations

import numpy as np

from vbench import reference


def _answers(requests: list) -> dict:
    """The answers by their width k: (pool rows, documents when asked, ids,
    dists) of each."""
    got: dict = {}
    for r in requests:
        if r.status == 200 and r.ids is not None:
            got.setdefault(np.asarray(r.ids).shape[1], []).append(r)
    return {k: (np.concatenate([r.pool for r in rs]),
                np.concatenate([np.full(len(r.pool), r.n_docs, np.int64) for r in rs]),
                np.concatenate([np.asarray(r.ids, np.int64) for r in rs]),
                np.concatenate([np.asarray(r.dists, np.float64) for r in rs]))
            for k, rs in got.items()}


def truth(queries: np.ndarray, docs: np.ndarray, rows: np.ndarray, n_docs: np.ndarray,
          k: int, device) -> np.ndarray:
    """The exact top k of each answer's query over the documents that existed
    when it was sent, computed once for each distinct (query, documents)."""
    gt = np.empty((len(rows), k), np.int64)
    for n in np.unique(n_docs):
        sel = np.nonzero(n_docs == n)[0]
        uniq, inv = np.unique(rows[sel], return_inverse=True)
        ids, _ = reference.exact_topk(queries[uniq], docs[:n], k, device)
        gt[sel] = ids[inv]
    return gt


def bad_rows(ids: np.ndarray, dists: np.ndarray, n_docs: np.ndarray) -> np.ndarray:
    """Answers with a missing id (where k documents existed), an id no
    document had when it was asked, a repeated id, or distances that are not
    finite and ascending."""
    k = ids.shape[1]
    missing = (ids < 0).any(1) & (n_docs >= k)
    unknown = ((ids >= n_docs[:, None]) | (ids < -1)).any(1)
    s = np.sort(ids, 1)
    repeated = ((np.diff(s, axis=1) == 0) & (s[:, 1:] >= 0)).any(1)
    valid = ids >= 0
    d = np.where(valid, dists, np.inf)
    unordered = (np.diff(d, axis=1) < 0).any(1) | (valid & ~np.isfinite(dists)).any(1)
    return missing | unknown | repeated | unordered


class Context:
    """What an op's checks read: the inputs, the configuration, the device."""

    def __init__(self, inputs, cfg: dict, device):
        self.inputs, self.cfg, self.device = inputs, cfg, device


def answer_checks(requests: list, ctx: Context) -> tuple[dict, dict]:
    """(quality numbers, checks) of k-nearest-neighbour answers."""
    inputs, lim = ctx.inputs, ctx.cfg["limits"]
    docs = np.concatenate([inputs.corpus, inputs.extra]) if len(inputs.extra) else inputs.corpus
    found, answers, gaps, bad = 0.0, 0, [], 0
    for k, (rows, n_docs, ids, dists) in _answers(requests).items():
        gt = truth(inputs.queries, docs, rows, n_docs, k, ctx.device)
        found += (gt[:, :, None] == ids[:, None, :]).any(2).sum() / k
        answers += len(ids)
        exact = reference.pair_dists(inputs.queries[rows], docs, ids, ctx.device)
        valid = ids >= 0
        gap = np.abs(dists - exact) / np.maximum(exact, np.finfo(np.float32).tiny)
        gaps.append(gap[valid].max() if valid.any() else np.inf)
        bad += int(bad_rows(ids, dists, n_docs).sum())
    quality = dict(answers=answers, recall=float(found / answers) if answers else 0.0,
                   dist_gap=float(max(gaps)) if gaps else float("inf"), bad_rows=bad,
                   not_served=sum(1 for r in requests if r.status != 200))
    return quality, {
        "recall": (quality["recall"], ">=", lim["recall"]),
        "dist_gap": (quality["dist_gap"], "<=", lim["dist_gap"]),
        "bad_rows": (quality["bad_rows"], "<=", 0),
        "not_served": (quality["not_served"], "<=", 0),
    }


def judge(requests: list, ops: dict, read: dict, ctx: Context):
    """(quality numbers, checks) of a run: the k-nearest-neighbour answers of
    the ops that give them, then each op's own checks on its requests and
    read-back. Each check is {value, rule, limit, holds}."""
    knn = [r for r in requests if getattr(ops[r.op], "KNN", False)]
    quality, checks = answer_checks(knn, ctx) if knn else ({}, {})
    for name, op in ops.items():
        if hasattr(op, "checks"):
            mine = op.checks([r for r in requests if r.op == name], ctx, read.get(name))
            quality.update({k: v for k, (v, _, _) in mine.items()})
            checks.update(mine)
    out = {}
    for name, (v, rule, limit) in checks.items():
        holds = v >= limit if rule == ">=" else v <= limit
        out[name] = dict(value=v, rule=rule, limit=limit, holds=bool(holds))
    return quality, out
