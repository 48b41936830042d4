"""search.launches_per_query: device kernels in the traced stretch (the
profiler's trace) over the queries answered in it."""


def read(run):
    if run.trace is None or run.trace.kernels == 0:
        return None  # nothing ran on a device
    q = run.queries(run.traced_requests)
    return run.trace.kernels / q if q else None
