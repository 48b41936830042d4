"""insert: one call writing ``docs`` new documents, drawn from the seed (the
system's ``insert``). After the window every acknowledged document is read
back: live and stored as written (the system's ``read_back``), and findable,
returned among the k nearest when its own vector is searched for."""
from __future__ import annotations

import numpy as np

from vbench.load import Request, now

FIND_BATCH = 128  # queries a findability search


def run(gen, step, out, until) -> None:
    m = int(step["docs"])
    ids, vectors = gen.new_docs(m)
    t0 = now()
    gen.sut.insert(ids, vectors)
    out.append(Request("insert", t0, now(), n_docs=gen.n_docs, docs=m))
    gen.written(m)


def read_back(gen) -> dict:
    n = gen.d_next
    if n == 0:
        return {}
    ids = np.arange(len(gen.inp.corpus), len(gen.inp.corpus) + n)
    vectors = gen.inp.extra[:n]
    unfound = 0
    for lo in range(0, n, FIND_BATCH):
        got, _, _ = gen.sut.search(vectors[lo:lo + FIND_BATCH], gen.k)
        unfound += int((~(np.asarray(got) == ids[lo:lo + FIND_BATCH, None]).any(1)).sum())
    return dict(written=n, lost=gen.sut.read_back(ids, vectors)["lost"],
                unfindable=unfound / n)


def checks(requests, ctx, read) -> dict:
    """``lost_writes``: acknowledged documents not live or not as written;
    ``unfindable``: the share of them that a search for their own vector
    does not return."""
    if not read:
        return {}
    return {"lost_writes": (read["lost"], "<=", 0),
            "unfindable": (read["unfindable"], "<=", ctx.cfg["limits"]["unfindable"])}
