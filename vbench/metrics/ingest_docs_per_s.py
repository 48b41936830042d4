"""ingest_docs_per_s: documents acknowledged by insert in the window over the
window's seconds (host clock)."""


def read(run):
    docs = sum(r.docs for r in run.requests if r.op == "insert" and r.status == 200)
    return docs / run.window_s if docs else None
