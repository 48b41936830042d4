"""device.busy_pct: the union of the device operations' intervals over the
traced stretch's length, from the profiler's trace."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or run.trace.window_s <= 0:
        return None  # nothing ran on a device
    return 100.0 * run.trace.busy_s / run.trace.window_s
