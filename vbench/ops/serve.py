"""serve: ``clients`` closed-loop clients of the system's serving engine,
each sending one query and, while the window lasts, its next as soon as
its own answer is back (the system's ``serve``). Each query is one
request, from its submission to the end of the micro-batch that answered
it. Outside the window (warm-up, the traced stretch) a round is one query a
client. Answers are judged as the exact k nearest neighbours."""
from __future__ import annotations

import numpy as np

from vbench.load import Request

KNN = True


def run(gen, step, out, until) -> None:
    def next_query():
        row = gen.rows(1)
        return row, gen.inp.queries[row[0]]

    for row, t0, t1, status, ids, dists in gen.sut.serve(next_query, int(step["clients"]),
                                                          gen.k, until):
        out.append(Request("serve", t0, t1, row, gen.n_docs,
                           None if ids is None else np.asarray(ids)[None],
                           None if dists is None else np.asarray(dists)[None], status=status))
