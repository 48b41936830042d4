"""query_p95_ms: the 95th percentile of every query request's latency in the
window (a search call, or one client's served query), host clock, each
ending when its answer is back on the host."""
import numpy as np


def read(run):
    lat = run.latencies_ms()
    return float(np.percentile(lat, 95)) if lat else None
