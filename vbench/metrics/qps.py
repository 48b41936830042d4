"""qps: every query answered in the window over the window's seconds (host
clock, first request sent to last answer back)."""


def read(run):
    n = run.queries()
    return n / run.window_s if n else None
