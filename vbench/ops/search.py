"""search: one call answering ``batch`` queries (the system's ``search``).
Its answers are judged as the exact k nearest neighbours among the
documents acknowledged when it was sent."""
from __future__ import annotations

import numpy as np

from vbench.load import Request, now

KNN = True


def run(gen, step, out, until) -> None:
    rows = gen.rows(int(step["batch"]))
    t0 = now()
    ids, dists, work = gen.sut.search(gen.inp.queries[rows], gen.k)
    out.append(Request("search", t0, now(), rows, gen.n_docs, np.asarray(ids),
                       np.asarray(dists), work=work))
