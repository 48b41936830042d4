"""The least time the card needs for a window's search work: the yardstick of
the kernels' roofline shares and of ``mfu_pct``.

``bound`` and the H100's published rates are a frozen copy of
``chip_smoke.bound`` and its constants. The work is counted from what the
inputs need, never from what a kernel happens to do (its padding, the
tables it reads again each round), so a later change that fuses or replaces
a kernel is read against the same work:

- ADC: the code bytes gathered, ``cmps x M``, plus each query's lookup
  tables (``V x M x K`` float32) read once; one addition a code byte.
- merges (``topk_select``): each beam round merges the beam with the round's
  new candidates (``L + cmps / hops`` float32 read, ``L`` values and
  indices written) and picks the next frontier (``L`` read, ``W`` values
  and indices written); each lane's rerank cut reads its ``k'`` and writes
  ``k``; where one query searched several partitions, the partitions' k
  each are merged to k.
- rerank: each full vector read once, ``full_reads x D`` float32, three
  operations an element.
- the lookup tables themselves: ``V x M x K x D/M`` products of the query
  with the codebooks, three operations each, the codebooks read once a call.

All counts are totals over the window: ``lanes`` is the number of
(query, partition) searches, ``hops``, ``cmps`` and ``full_reads`` their
sums.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores


def bound(nbytes: float, ops: float, rate: float = FP32_FLOPS) -> tuple[float, str]:
    """The larger of bytes over the memory rate and ops over ``rate``, in ms
    (copied from ``chip_smoke.bound``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def adc_work(w: dict, cfg: dict) -> tuple[float, float]:
    """(bytes, ops) of the ADC distances: codes gathered plus the tables."""
    M, K = cfg["M"], cfg["K"]
    nbytes = w["cmps"] * M + w["lanes"] * w.get("schemas", 1) * M * K * 4
    return nbytes, w["cmps"] * M


def topk_work(w: dict, cfg: dict) -> tuple[float, float]:
    """(bytes, ops) of the merges, frontier picks and cuts."""
    L, W, k, kp = w["L"], cfg["beam_width"], w["k"], w["kprime"]
    hops, lanes = w["hops"], w["lanes"]
    new = w["cmps"]  # every new candidate is read once, in its round's merge
    nbytes = (hops * L + new) * 4 + hops * L * 8  # beam merges
    nbytes += hops * L * 4 + hops * W * 8  # frontier picks
    nbytes += lanes * (kp * 4 + k * 8)  # rerank cuts
    parts = lanes // max(w["queries"], 1)
    if parts > 1:
        nbytes += w["queries"] * (parts * k * 4 + k * 8)  # the partitions' merge
    return nbytes, 0.0


def rerank_work(w: dict, cfg: dict) -> tuple[float, float]:
    """(bytes, ops) of the full-precision rerank."""
    D = cfg["dim"]
    return w["full_reads"] * D * 4 + w["lanes"] * D * 4, w["full_reads"] * D * 3


def lut_work(w: dict, cfg: dict) -> tuple[float, float]:
    """(bytes, ops) of building each query's lookup tables."""
    D, M, K, V = cfg["dim"], cfg["M"], cfg["K"], w.get("schemas", 1)
    return w["calls"] * V * K * D * 4 + w["lanes"] * D * 4, w["lanes"] * V * K * D * 3


def least_ms(parts: list[tuple[float, float]]) -> float:
    """The least time, in ms, for the sum of several (bytes, ops) works."""
    return bound(sum(b for b, _ in parts), sum(o for _, o in parts))[0]


def search_ms(w: dict, cfg: dict) -> float:
    """The least time of the whole search work: the step's yardstick."""
    return least_ms([adc_work(w, cfg), topk_work(w, cfg), rerank_work(w, cfg), lut_work(w, cfg)])
