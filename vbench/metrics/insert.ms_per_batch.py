"""insert.ms_per_batch: mean host milliseconds of an ``insert`` call (one
mini-batch of documents), from the harness's span around it, the card
synchronised at its end; spans of the profiled stretch left out."""


def read(run):
    ms = [(t1 - t0) * 1e3 for name, t0, t1, _ in run.spans if name == "insert"]
    return sum(ms) / len(ms) if ms else None
