"""The control: the reference put in the program's place, one precision
below the configuration's (TF32 for its float32). It answers every request
a cell's traffic sends, exactly but in TF32, and keeps every document it is
sent. ``vbench/control.py`` runs it; the benchmark's own runs never do.
"""
from __future__ import annotations

import time

import numpy as np

from vbench import reference


class System:
    def __init__(self, cfg: dict, corpus: np.ndarray, device, capacity_extra: int = 0):
        self.device = device
        self.docs = [np.asarray(corpus, np.float32)]
        self.ids = [np.arange(len(corpus))]

    def _all(self):
        return np.concatenate(self.docs), np.concatenate(self.ids)

    def search(self, queries: np.ndarray, k: int):
        docs, ids = self._all()
        rows, dists = reference.exact_topk(queries, docs, k, self.device, precision="tf32")
        return ids[rows], dists, None

    def serve(self, next_query, clients: int, k: int, until) -> list:
        """Each client's query answered at once, in rounds of one a client,
        while the host clock is before ``until``."""
        done = []
        while True:
            asked = [next_query() for _ in range(clients)]
            t0 = time.perf_counter()
            got, dists, _ = self.search(np.stack([q for _, q in asked]), k)
            t1 = time.perf_counter()
            done += [(tag, t0, t1, 200, got[i], dists[i]) for i, (tag, _) in enumerate(asked)]
            if until is None or t1 >= until:
                return done

    def insert(self, doc_ids: list, vectors: np.ndarray) -> None:
        self.docs.append(np.asarray(vectors, np.float32))
        self.ids.append(np.asarray(doc_ids, np.int64))

    def read_back(self, doc_ids: np.ndarray, vectors: np.ndarray) -> dict:
        docs, ids = self._all()
        where = {int(d): i for i, d in enumerate(ids)}
        lost = sum(1 for d, v in zip(doc_ids, vectors)
                   if int(d) not in where or not np.array_equal(docs[where[int(d)]], v))
        return dict(lost=lost)

    def close(self) -> None:
        self.docs = self.ids = None
