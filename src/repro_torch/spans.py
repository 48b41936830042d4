"""Host-clock spans at the port's layer boundaries, and the span type the
serving plane's SimClock traces share.

The port's serving plane models time on its ``SimClock`` (``serve.trace``,
``serve.metrics``); this module measures it. A ``Recorder`` keeps one
``Span`` per piece of a layer's work -- the engine's queue and micro-batch,
the fan-out, an index's search and its phases, an insert and its phases --
stamped with ``time.perf_counter_ns()`` (the host clock a caller's own
``time.perf_counter()`` reads), with the index of the span that was open
when it began as its parent. Counts go on the spans they belong to, as
attributes set when the span ends: ``rounds`` on a beam search, ``syncs``
(host reads of device values: ``bool()``, ``float()``, ``int()``,
``.item()``, ``.cpu()``, ``.tolist()``) on the beam search and on the search
calls that hold it.

Off by default: ``ACTIVE`` is None, and each span site tests it once, so an
untraced call allocates nothing and enters no profiler range. ``recording()``
installs a recorder for the length of a ``with`` block. While one is
installed and a ``torch.profiler`` session runs, each span also opens a
``record_function`` range of its name (a user annotation, entered through
``torch.autograd``'s lighter call than the context manager's), so the
program's spans sit on the device trace's own timeline.

Spans are kept in memory, at most ``capacity`` of them (later ones are only
counted, in ``dropped``), and read after the run from ``Recorder.spans``. The
port's paths run on one thread; a recorder is not shared between threads.

Span names, by layer (``stage`` is the part before the dot):

  engine.queue     one query, from its submission to the start of the
                   ``_dispatch`` that takes it (does not nest; ``rid``)
  engine.batch     one micro-batch, ``_dispatch_chunk`` (``queries``)
  fanout.search    ``SpmdFanout.search`` (``queries``, ``partitions``, ``syncs``)
  fanout.stack     the block's LUTs and stacked provider arrays
  fanout.rerank    the stacked rerank and the partials read back to the host
  fanout.meter     each partition's stats, page-tier touches and RU
  fanout.merge     the host merge of the partitions' answers
  index.search     ``DiskANNIndex.search`` (``queries``, ``syncs``)
  search.luts      the query batch's lookup tables
  search.beam      ``batch_greedy_search`` (``queries``, ``rounds``, ``syncs``)
  search.rerank    the full-precision rerank of the k' candidates
  search.answer    the stats and answers read back, slots mapped to documents
  index.insert     ``DiskANNIndex.insert`` (``docs``)
  insert.full_write  posting writes (``set_full``)
  insert.term_write  PQ encode and ``set_quant``
  insert.materialize the device mirror's copy-up of the rows written
  insert.candidates  the beam search at L_build
  insert.prune       the new nodes' prune and their rows written
  insert.edges       reverse edges grouped by target, ``append_neighbors``
  insert.overflow_prune  ``_prune_nodes``: the rows that overflowed
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator, Optional

import torch

CAPACITY = 1 << 18  # spans a recorder keeps (a minute of served micro-batches of 16: ~35 000)


@dataclasses.dataclass
class Span:
    """One span: a stage of a request's lifecycle on the serving plane's
    SimClock (``serve.trace``), or a layer's work on the host clock
    (``Recorder``; ``stage`` is then the layer)."""

    name: str
    stage: str
    t0_s: float
    t1_s: float
    parent: int = -1  # index into the owning list of spans, -1 for a root
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def dur_ms(self) -> float:
        return (self.t1_s - self.t0_s) * 1000.0


class Recorder:
    """Host-clock spans of one run, in the order they began."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = int(capacity)
        self.spans: list[Span] = []
        self.dropped = 0  # spans begun once ``capacity`` were kept
        self.syncs = 0  # host reads of device values counted so far
        self._open: list[int] = []  # the nesting spans open now, innermost last
        self._marks: dict[int, tuple] = {}  # open span -> (syncs at begin, profiler range)

    def _new(self, name: str, attrs: dict, nests: bool) -> int:
        if len(self.spans) >= self.capacity:
            self.dropped += 1
            return -1
        i = len(self.spans)
        t = time.perf_counter_ns() * 1e-9
        # the profiler's range lies inside the span: its own bookkeeping,
        # tens of µs at times, falls inside both
        rng = None
        if torch._C._autograd._profiler_enabled():
            rng = torch.autograd._record_function_with_args_enter(name)
        self.spans.append(Span(name, name.partition(".")[0], t, t,
                               self._open[-1] if self._open else -1, attrs))
        self._marks[i] = (self.syncs, rng)
        if nests:
            self._open.append(i)
        return i

    def begin(self, name: str, **attrs) -> int:
        """Open a span that nests: spans begun before it ends are its
        children. Returns its index (-1 when the recorder is full)."""
        return self._new(name, attrs, True)

    def start(self, name: str, **attrs) -> int:
        """Open a span that does not nest (a request waiting in a queue):
        its parent is the span open now, but no later span is its child."""
        return self._new(name, attrs, False)

    def syncs_since(self, i: int) -> int:
        """Host reads of device values counted since open span ``i`` began."""
        return self.syncs - self._marks.get(i, (self.syncs,))[0]

    def end(self, i: int, **attrs) -> None:
        """Close span ``i`` with ``attrs`` added. Nesting spans still open
        inside it (left by an exception) close with it."""
        if i < 0:
            return
        if i in self._marks:
            inner = []
            if i in self._open:
                at = self._open.index(i)
                inner, self._open[at:] = self._open[at + 1:], []
            closing = inner[::-1] + [i]
            for j in closing:
                rng = self._marks.pop(j)[1]
                if rng is not None:
                    torch.autograd._record_function_with_args_exit(rng)
            t = time.perf_counter_ns() * 1e-9
            for j in closing:
                self.spans[j].t1_s = t
        self.spans[i].attrs.update(attrs)


ACTIVE: Optional[Recorder] = None  # where spans go; None: recording is off


@contextlib.contextmanager
def recording(capacity: int = CAPACITY) -> Iterator[Recorder]:
    """Record the port's spans into a new ``Recorder`` inside the block."""
    global ACTIVE
    prev, ACTIVE = ACTIVE, Recorder(capacity)
    try:
        yield ACTIVE
    finally:
        ACTIVE = prev
