"""index.cmps_per_query: quantized distance comparisons per query answered
(``QueryStats.cmps``, summed over a query's partitions), over the window:
from each search call's stats, or from the fan-out spans' partition stats."""


def read(run):
    works = [r.work for r in run.requests if r.op == "search" and r.work]
    works += [a for name, _, _, a in run.traced_spans + run.spans if "cmps" in a]
    q = sum(w["queries"] for w in works)
    return sum(w["cmps"] for w in works) / q if q else None
