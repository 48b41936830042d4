"""Labeled metrics registry — per-tenant / per-stage cost attribution.

``EngineMetrics`` (serve/metrics.py) keeps engine-global aggregates; this
module adds the *labeled* layer the paper's cost analysis needs: which
tenant spent which RU, and which lifecycle stage each millisecond of
latency went to. Two primitive kinds, Prometheus-style:

  * counters — monotonically increasing floats keyed by a label set
    (e.g. ``serve_ru_total{tenant="t0",op="query"}``)
  * histograms — the bounded streaming ``Histogram`` from serve/metrics,
    one per label set (e.g. ``serve_latency_ms{tenant="t0"}``)

The registry is deliberately schema-free — families are created on first
touch — but label *names* are locked per family on first use so a typo'd
label key fails loudly rather than silently forking a series.

Conservation contracts (asserted in tests/test_observability.py):

  * RU:     Σ serve_ru_total{op=query|page} == EngineMetrics.ru_query_total
            Σ serve_ru_total{op=hedge}      == EngineMetrics.hedge_ru_total
            Σ serve_ru_total{op=ingest}     == EngineMetrics.ru_ingest_total
            and per-tenant query+page+hedge == that tenant's governor
            ``consumed`` (refunded reservations never enter the registry).
  * time:   Σ serve_stage_ms{stage=queue|lane} totals ==
            Σ serve_latency_ms totals (stages tile the request interval).

``to_prometheus_text`` renders the standard text exposition format
(counters, and summary-style quantiles for histograms) for the
``launch/serve.py --metrics-out`` exporter.

The port's own copy of ``repro.serve.obs`` (no JAX there, but importing it
through ``repro`` loads JAX); the exposition text is the reference's byte
for byte.
"""
from __future__ import annotations

from typing import Optional

from .metrics import Histogram


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels))


class RollupWindow:
    """Differencing window over cumulative rollups (the (count, sum)
    pairs ``observability_summary`` reports per stage/tenant). The
    registry's histograms never decay, so cumulative percentiles go
    sticky under changing load; count/sum *deltas* between reads window
    exactly. ``delta`` returns ``max(new - prev, 0)`` — a value that
    shrank means a metrics-epoch reset (``engine.reset_metrics`` at a
    warmup boundary), so the window re-bases at the new value instead of
    reporting a negative rate. The control plane (serve/policy.py) runs
    on these windows."""

    __slots__ = ("_prev",)

    def __init__(self):
        self._prev: dict = {}

    def delta(self, key: str, value: float) -> float:
        prev = self._prev.get(key, 0.0)
        self._prev[key] = value
        return value - prev if value >= prev else 0.0

    def reset(self) -> None:
        self._prev.clear()


class _Family:
    __slots__ = ("name", "kind", "labelnames", "series")

    def __init__(self, name: str, kind: str, labelnames: tuple):
        self.name = name
        self.kind = kind  # "counter" | "histogram"
        self.labelnames = labelnames
        self.series: dict = {}  # label-value tuple -> float | Histogram


class MetricsRegistry:
    """On-demand families of labeled counters and streaming histograms."""

    def __init__(self):
        self._families: dict[str, _Family] = {}

    def _family(self, name: str, kind: str, labels: dict) -> _Family:
        names = _label_key(labels)
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(name, kind, names)
            self._families[name] = fam
        else:
            if fam.kind != kind:
                raise ValueError(f"metric {name!r} is a {fam.kind}, not a {kind}")
            if fam.labelnames != names:
                raise ValueError(
                    f"metric {name!r} label names {fam.labelnames} != {names}")
        return fam

    @staticmethod
    def _values(fam: _Family, labels: dict) -> tuple:
        return tuple(str(labels[k]) for k in fam.labelnames)

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels):
        fam = self._family(name, "counter", labels)
        key = self._values(fam, labels)
        fam.series[key] = fam.series.get(key, 0.0) + float(value)

    def observe(self, name: str, value: float, **labels):
        fam = self._family(name, "histogram", labels)
        key = self._values(fam, labels)
        h = fam.series.get(key)
        if h is None:
            h = fam.series[key] = Histogram()
        h.observe(value)

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------
    def counter_value(self, name: str, **labels) -> float:
        fam = self._families.get(name)
        if fam is None:
            return 0.0
        return float(fam.series.get(self._values(fam, labels), 0.0))

    def histogram(self, name: str, **labels) -> Optional[Histogram]:
        fam = self._families.get(name)
        if fam is None:
            return None
        return fam.series.get(self._values(fam, labels))

    def total(self, name: str, **match) -> float:
        """Sum of a counter family over every series matching ``match``
        (a subset of the family's labels); 0.0 for unknown families."""
        fam = self._families.get(name)
        if fam is None:
            return 0.0
        idx = [(fam.labelnames.index(k), str(v)) for k, v in match.items()]
        tot = 0.0
        for key, v in fam.series.items():
            if all(key[i] == want for i, want in idx):
                tot += v
        return tot

    def label_values(self, name: str, label: str) -> list:
        """Sorted distinct values one label takes across a family."""
        fam = self._families.get(name)
        if fam is None or label not in fam.labelnames:
            return []
        i = fam.labelnames.index(label)
        return sorted({key[i] for key in fam.series})

    def series(self, name: str) -> list:
        """[(labels_dict, value_or_histogram)] for one family."""
        fam = self._families.get(name)
        if fam is None:
            return []
        return [(dict(zip(fam.labelnames, key)), v)
                for key, v in sorted(fam.series.items())]

    # ------------------------------------------------------------------
    # exporters
    # ------------------------------------------------------------------
    def summary(self) -> dict:
        """JSON-friendly dump: counters as floats, histograms as stats."""
        out: dict = {}
        for name, fam in sorted(self._families.items()):
            fam_out = {}
            for key, v in sorted(fam.series.items()):
                label = ",".join(f"{k}={val}" for k, val
                                 in zip(fam.labelnames, key)) or "_"
                if fam.kind == "counter":
                    fam_out[label] = v
                else:
                    fam_out[label] = dict(
                        count=v.count, sum=v.sum, mean=v.mean(),
                        p50=v.percentile(50), p95=v.percentile(95),
                        p99=v.percentile(99), max=v.max)
            out[name] = fam_out
        return out

    def to_prometheus_text(self) -> str:
        """Standard Prometheus text exposition. Histograms render as
        summaries (quantile series + ``_sum``/``_count``)."""
        lines = []
        for name, fam in sorted(self._families.items()):
            if fam.kind == "counter":
                lines.append(f"# TYPE {name} counter")
                for key, v in sorted(fam.series.items()):
                    lines.append(f"{name}{_fmt_labels(fam.labelnames, key)} "
                                 f"{_fmt_num(v)}")
            else:
                lines.append(f"# TYPE {name} summary")
                for key, h in sorted(fam.series.items()):
                    for q in (0.5, 0.95, 0.99):
                        lbl = _fmt_labels(fam.labelnames + ("quantile",),
                                          key + (f"{q:g}",))
                        lines.append(f"{name}{lbl} "
                                     f"{_fmt_num(h.percentile(q * 100))}")
                    base = _fmt_labels(fam.labelnames, key)
                    lines.append(f"{name}_sum{base} {_fmt_num(h.sum)}")
                    lines.append(f"{name}_count{base} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_labels(names: tuple, values: tuple) -> str:
    if not names:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in zip(names, values))
    return "{" + inner + "}"


def _fmt_num(v: float) -> str:
    return repr(float(v))
