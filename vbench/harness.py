"""Run one cell of ``BENCHMARK.json``: set-up, the measured window, the
check of what the window produced, and the metrics.

The harness knows no configuration, traffic mix, system or metric by name.
A cell names a configuration and a traffic mix; it finds

- the configuration at the ``file`` the manifest gives, a JSON object whose
  ``system`` names its module ``vbench/systems/<system>.py``;
- the traffic mix at ``vbench/traffic/<traffic>.json``, the parameters of
  the one general generator (``vbench/load.py``), and each op its steps
  name at ``vbench/ops/<op>.py``;
- each metric's reader at ``vbench/metrics/<metric name>.py``, a function
  ``read(run)`` that returns the number, or None where the run holds
  nothing for it to read.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path

import torch

from vbench import data, judge, load

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_MODULES: dict = {}


def load_module(path: Path):
    """The module in ``path``, loaded once a process."""
    key = str(path.resolve())
    if key not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no file {path}")
        spec = importlib.util.spec_from_file_location(f"vbench_{path.parent.name}_{path.stem}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict  # the configuration file's object
    traffic: dict  # the traffic file's object
    end_to_end: list  # the manifest's metric entries this cell reports
    per_layer: list
    files: Path  # the benchmark's folder: systems/, traffic/, ops/, metrics/


def find_cell(name: str, root: Path = ROOT, cfg_overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    man = read_json(root / "BENCHMARK.json")
    w = [w for w in man["workloads"] if w["name"] == name]
    if not w:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = w[0]
    c = [c for c in man["configs"] if c["name"] == w["config"]][0]
    cfg = dict(read_json(root / c["file"]), **(cfg_overrides or {}))
    traffic = read_json(root / HERE.name / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]
    return Cell(name, int(w["chips"]), cfg, traffic, e2e, per_layer, root / HERE.name)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    requests: list  # the window's requests (load.Request)
    window_s: float  # first request sent to last answer back, host clock
    quality: dict  # the judge's numbers (recall, gaps, ...)
    spans: list  # (name, start, end, attrs) recorded in the window
    trace: object = None  # trace.Trace of the traced stretch, or None
    traced_requests: list = dataclasses.field(default_factory=list)  # the stretch's
    traced_spans: list = dataclasses.field(default_factory=list)

    def queries(self, requests=None) -> int:
        """Queries answered (a search answers its batch, a served request one)."""
        reqs = self.requests if requests is None else requests
        return sum(len(r.ids) for r in reqs if r.ids is not None and r.status == 200)

    def latencies_ms(self) -> list:
        return [(r.t1 - r.t0) * 1e3 for r in self.requests if r.ids is not None]

    def traced_work(self) -> dict | None:
        """The program's search counters over the traced stretch, summed: from
        the requests where a call reports them, else from its spans."""
        items = [r.work for r in self.traced_requests if r.work]
        items += [a for name, _, _, a in self.traced_spans if "cmps" in a]
        if not items:
            return None
        w = {key: sum(i[key] for i in items) for key in ("lanes", "queries", "cmps", "hops",
                                                          "full_reads")}
        for key in ("L", "k", "kprime", "schemas"):
            w[key] = max(i[key] for i in items)
        w["calls"] = len(items)
        return w


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def set_up(cell: Cell, seed: int, seconds: float, dev: torch.device,
           system: str | None = None) -> load.Generator:
    """A cell's set-up: its inputs from the seed, the system built from them
    and warmed up, bound to the generator of its traffic."""
    ops = {op: load_module(cell.files / "ops" / f"{op}.py")
           for op in {step["op"] for step in cell.traffic["steps"]}}
    gen = load.Generator(cell.traffic, cell.cfg, seconds, ops)
    inputs = data.Inputs(seed, cell.cfg["total_vectors"], cell.cfg["dim"], gen.query_pool,
                         gen.insert_pool, dev)
    drv = load_module(cell.files / "systems" / f"{system or cell.cfg['system']}.py")
    gen.bind(drv.System(cell.cfg, inputs.corpus, dev, capacity_extra=gen.insert_pool), inputs)
    gen.warm_up()
    _sync(dev)
    return gen


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_process: float | None = None, root: Path = ROOT,
             cfg_overrides: dict | None = None, system: str | None = None,
             on_window_closed=None) -> dict:
    """One run of cell ``name``; returns the result's fields (the line's
    object) with ``checks``, the numbers compared and their limits.
    ``system`` puts another module of ``vbench/systems/`` in the program's
    place (the control); ``on_window_closed`` is called as the window
    closes (run.py checks what the process has loaded there)."""
    t_process = time.perf_counter() if t_process is None else t_process
    dev = torch.device(device)
    cell = find_cell(name, root, cfg_overrides)
    cfg = cell.cfg
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # -- set-up: inputs, the system built from them, warm-up ----------------
    gen = set_up(cell, seed, seconds, dev, system)
    sut, inputs, ops = gen.sut, gen.inp, gen.ops
    spans: list = []
    launch_counts = None
    if trace:
        from repro_torch import kernels as K

        launch_counts = K.launch_counts
        if hasattr(sut, "instrument"):
            sut.instrument(spans)

    # -- the window, then (tracing) a profiled stretch ----------------------
    t_setup_end = time.perf_counter()
    window = gen.window(seconds, spans, launch_counts, dev)
    _sync(dev)
    if on_window_closed is not None:
        on_window_closed()
    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0

    # -- what the window produced, judged against the reference -------------
    read_back = gen.read_back()  # the program's state, read before it is freed
    sut.close()
    del sut, gen.sut
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    judged = window.requests + window.traced_requests
    quality, checks = judge.judge(judged, ops, read_back, judge.Context(inputs, cfg, dev))

    run = Run(cell, t_setup_end - t_process, window.requests, window.seconds, quality,
              spans[:window.window_spans], window.trace, window.stretch_requests,
              spans[slice(*window.stretch_spans)])
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        v = load_module(cell.files / "metrics" / f"{m['name']}.py").read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = dict(correct=all(c["holds"] for c in checks.values()), attempted=len(judged),
               failed=sum(1 for r in judged if r.status != 200), metrics=metrics,
               device=dict(platform="gpu" if dev.type == "cuda" else dev.type,
                           kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                           count=cell.chips, memory_peak_bytes=peak))
    if trace:
        out["device"].update(busy_s=window.trace.busy_s, window_s=window.trace.window_s)
        out["breakdown"] = window.trace.breakdown()
    out["checks"] = checks
    return out
