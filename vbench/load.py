"""The one general generator: drives a system with the requests a traffic
file describes, in a closed loop, and records each request.

A traffic file is a JSON object of parameters:

- ``steps``: the requests of one round, in order, each an object with
  ``op`` and its sizes. Each op is a module ``vbench/ops/<op>.py`` that the
  harness finds by name: it makes the step's requests (``run``) and may
  bring its own read-back of the system's state (``read_back``) and its
  own checks (``checks``); its answers are judged as exact k nearest
  neighbours where it sets ``KNN = True``. A round's requests are sent once
  the previous round's answers are back, as callers that wait for their
  reply send them;
- ``query_pool``: queries drawn from the seed at set-up; requests take them
  in turn, cycling;
- ``insert_docs_per_s_cap``: sizes the pool of new documents for the steps
  that write (those with ``docs``): this rate over the window, plus the
  warm-up's; the window ends early if a system writes them all;
- ``warmup_rounds``: rounds run before the window (set-up), which touch
  every shape the window uses;
- ``trace_rounds``: the stretch that a ``--trace 1`` run profiles once the
  window has closed.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from vbench import trace

now = time.perf_counter


class PoolSpent(Exception):
    """Every document drawn for inserts is written: the window ends there."""


@dataclasses.dataclass
class Request:
    op: str
    t0: float  # sent, host clock
    t1: float  # its answer back on the host
    pool: np.ndarray | None = None  # rows of the query pool it asked
    n_docs: int = 0  # documents acknowledged when it was sent
    ids: np.ndarray | None = None  # (queries, k) document ids answered
    dists: np.ndarray | None = None
    status: int = 200
    docs: int = 0  # documents it wrote
    work: dict | None = None  # the program's counters for it


@dataclasses.dataclass
class Window:
    requests: list  # the measured window's
    seconds: float = 0.0
    trace: object = None  # the traced stretch's reading, after the window
    traced_requests: list = dataclasses.field(default_factory=list)  # every traced attempt's
    stretch_requests: list = dataclasses.field(default_factory=list)  # the held attempt's
    window_spans: int = 0  # the window's spans are spans[:window_spans]
    stretch_spans: tuple = (0, 0)  # the held stretch's, spans[from:to]


class Generator:
    def __init__(self, traffic: dict, cfg: dict, seconds: float, ops: dict):
        self.t = traffic
        self.steps = traffic["steps"]
        self.ops = ops  # op name -> its module
        missing = {s["op"] for s in self.steps} - set(ops)
        if missing:
            raise ValueError(f"no module for ops {sorted(missing)}")
        self.k = int(cfg["k"])
        self.query_pool = int(traffic.get("query_pool", 0))
        per_round = sum(int(s.get("docs", 0)) for s in self.steps)
        warm = per_round * int(traffic.get("warmup_rounds", 1))
        cap = float(traffic.get("insert_docs_per_s_cap", 0))
        self.insert_pool = warm + int(math.ceil(cap * seconds)) if per_round else 0
        self.sut = None

    def bind(self, sut, inputs) -> None:
        self.sut, self.inp = sut, inputs
        self.n_docs = len(inputs.corpus)  # documents acknowledged so far
        self.q_next = 0
        self.d_next = 0  # documents of the insert pool written so far

    # -- what the ops draw on -------------------------------------------------
    def rows(self, n: int) -> np.ndarray:
        """The next ``n`` rows of the query pool, cycling."""
        rows = (self.q_next + np.arange(n)) % self.query_pool
        self.q_next = (self.q_next + n) % self.query_pool
        return rows

    def new_docs(self, m: int) -> tuple[list, np.ndarray]:
        """The next ``m`` documents of the insert pool: (ids, vectors); the
        window ends where the pool is spent. ``written`` acknowledges them."""
        lo, hi = self.d_next, self.d_next + m
        if hi > len(self.inp.extra):
            raise PoolSpent
        base = len(self.inp.corpus)
        return list(range(base + lo, base + hi)), self.inp.extra[lo:hi]

    def written(self, m: int) -> None:
        self.d_next += m
        self.n_docs += m

    # -- the loop ---------------------------------------------------------------
    def _closed(self, out: list, rounds: int | None, until: float | None) -> None:
        r = 0
        try:
            while (rounds is None or r < rounds) and (until is None or now() < until):
                for step in self.steps:
                    self.ops[step["op"]].run(self, step, out, until)
                r += 1
        except PoolSpent:
            pass

    def warm_up(self) -> None:
        """The set-up's rounds: every shape the window's requests use, once."""
        self._closed([], int(self.t.get("warmup_rounds", 1)), None)

    def window(self, seconds: float, spans: list, launch_counts=None, device="cuda") -> Window:
        """The measured window: rounds for ``seconds`` (the round in progress
        at the end ends it). With ``launch_counts``, a stretch of the same
        traffic then runs under the profiler, after the window has closed."""
        w = Window([])
        t = now()
        self._closed(w.requests, None, t + seconds)
        w.seconds = now() - t
        w.window_spans = len(spans)
        if launch_counts is not None:
            marks = {}

            def stretch() -> None:
                r0, s0 = len(w.traced_requests), len(spans)
                self._closed(w.traced_requests, int(self.t.get("trace_rounds", 1)), None)
                marks.update(req=(r0, len(w.traced_requests)), spans=(s0, len(spans)))

            w.trace = trace.traced(stretch, launch_counts, device)
            w.stretch_requests = w.traced_requests[slice(*marks["req"])]
            w.stretch_spans = marks["spans"]
        return w

    def read_back(self) -> dict:
        """Each op's reading of the system's state after the window, for its
        checks, taken while the system is still there."""
        return {name: op.read_back(self) for name, op in self.ops.items()
                if hasattr(op, "read_back")}
