#!/usr/bin/env python3
"""Read the port's host-clock spans (``repro_torch.spans``) over one cell of
the benchmark: the per-layer numbers they give, what recording them costs,
and where the card's idle time goes.

    python3 scripts/torch_span_report.py --workload p1-search-b128 --seed 7 \\
        --seconds 20 --pairs 2 --out chiprun_out/spans_p1.json

One set-up (``vbench.harness.set_up``) with the harness's own spans on, as
in a ``--trace 1`` run; then ``--pairs`` pairs of measured windows, the
recorder off and on in turns (qps and p95 of each, and with the recorder on the
layer metrics and the spans held against the harness's); then the cell's
traced stretch (``trace_rounds`` under ``torch.profiler``) with the recorder
on, each idle gap of the device put down to the innermost program span
holding its middle (``idle_by_span``); last, one request of the cell under
``torch.cuda.set_sync_debug_mode("warn")``, the synchronising calls it warns
of against the ``syncs`` its spans counted. Prints a summary; the whole
report goes to ``--out``. ``--device cpu --tiny`` rehearses it on the CPU at
the widths of the benchmark's CPU tests (no device, so no idle gaps).
"""
from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import statistics
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NON_NESTING = ("engine.queue",)  # spans that hold no child (Recorder.start)
SEARCH_CALLS = ("index.search", "fanout.search")  # the calls that carry a search's syncs
OUTSIDE = "outside any program span"
TINY = dict(total_vectors=1500, dim=32, M=8, R=16, R_slack=20, L_build=40, L_search=40,
            bootstrap_sample=200, refine_sample=1000, max_vectors_per_partition=2000)


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def self_s(spans: list) -> list:
    """Each span's seconds less the part of it that its children cover (a
    span's self time)."""
    kids: list = [[] for _ in spans]
    for s in spans:
        if s.parent >= 0 and s.name not in NON_NESTING:
            kids[s.parent].append((s.t0_s, s.t1_s))
    out = []
    for s, ks in zip(spans, kids):
        clipped = [(max(a, s.t0_s), min(b, s.t1_s)) for a, b in ks]
        covered = sum(b - a for a, b in _union([c for c in clipped if c[1] > c[0]]))
        out.append(s.t1_s - s.t0_s - covered)
    return out


def between(spans: list, t0: float, t1: float) -> list:
    """Indices of the spans that began in [t0, t1] (host clock, seconds)."""
    return [i for i, s in enumerate(spans) if t0 <= s.t0_s <= t1]


def _under(spans: list, s, names) -> bool:
    while s.parent >= 0:
        s = spans[s.parent]
        if s.name in names:
            return True
    return False


def _mean(v: list):
    return sum(v) / len(v) if v else None


def layer_metrics(spans: list, idx: list) -> dict:
    """The layer metrics the spans ``idx`` of ``spans`` give (None where
    none of the spans a metric reads is among them)."""
    sel = [spans[i] for i in idx]
    own = self_s(spans)
    tops = [s for s in sel if s.name in SEARCH_CALLS and not _under(spans, s, SEARCH_CALLS)]
    queries = sum(s.attrs["queries"] for s in tops)
    inserts = [s for s in sel if s.name == "index.insert"]
    edges = [s.dur_ms for s in sel if s.name in ("insert.edges", "insert.overflow_prune")
             and _under(spans, s, ("index.insert",))]
    return {
        "engine.queue_ms": _mean([s.dur_ms for s in sel if s.name == "engine.queue"]),
        "engine.self_ms_per_batch": _mean([own[i] * 1e3 for i in idx
                                           if spans[i].name == "engine.batch"]),
        "search.beam_ms_per_call": _mean([
            s.dur_ms for s in sel if s.name == "search.beam" and s.parent >= 0
            and spans[s.parent].name in SEARCH_CALLS]),
        "search.syncs_per_query": (sum(s.attrs["syncs"] for s in tops) / queries
                                   if queries else None),
        "insert.edges_ms_per_batch": sum(edges) / len(inserts) if inserts else None,
    }


def by_name(spans: list, idx: list) -> dict:
    """name -> [spans, mean ms, mean self ms] over the spans ``idx``."""
    own = self_s(spans)
    acc: dict = collections.defaultdict(list)
    for i in idx:
        acc[spans[i].name].append((spans[i].dur_ms, own[i] * 1e3))
    return {n: [len(v), _mean([d for d, _ in v]), _mean([o for _, o in v])]
            for n, v in sorted(acc.items())}


def idle_by_span(prof, mark: str) -> dict:
    """The device's idle gaps inside the profile's ``mark`` range, each put
    down to the innermost program span (a ``record_function`` range other
    than ``mark``; a query waiting in the engine's queue holds none) holding
    its middle, or to OUTSIDE; with the stretch's length, busy and idle
    seconds."""
    from torch.autograd import DeviceType

    events = prof.events()
    w = [e for e in events if e.name == mark and e.device_type != DeviceType.CUDA]
    if not w:
        raise RuntimeError(f"the profile holds no {mark} range")
    w0, w1 = w[0].time_range.start, w[0].time_range.end
    dev, progs = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        user = getattr(e, "is_user_annotation", False) or e.name == mark
        if e.device_type == DeviceType.CUDA:
            if not user and min(t, w1) > max(s, w0):
                dev.append((max(s, w0), min(t, w1)))
        elif user and e.name != mark and e.name not in NON_NESTING:
            progs.append((s, t, e.name))
    busy = _union(dev)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    progs.sort()
    starts = [p[0] for p in progs]
    idle: dict = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        name = OUTSIDE
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if progs[j][1] >= mid:  # the latest-starting span still open there
                name = progs[j][2]
                break
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    return dict(idle_by_span=idle, window_s=(w1 - w0) / 1e6,
                busy_s=sum(t - s for s, t in busy) / 1e6, idle_s=sum(idle.values()))


def _window_numbers(reqs: list, seconds: float) -> dict:
    q = sum(len(r.ids) for r in reqs if r.ids is not None and r.status == 200)
    lat = sorted((r.t1 - r.t0) * 1e3 for r in reqs if r.ids is not None)
    p95 = statistics.quantiles(lat, n=20, method="inclusive")[-1] if len(lat) > 1 else None
    ins = [r for r in reqs if r.op == "insert"]
    return dict(qps=q / seconds, p95_ms=p95, mean_latency_ms=_mean(lat),
                ingest_docs_per_s=sum(r.docs for r in ins) / seconds if ins else None,
                requests=len(reqs))


def _outside(hspans: list, name: str) -> float | None:
    return _mean([(t1 - t0) * 1e3 for n, t0, t1, _ in hspans if n == name])


def sync_check(gen, torch, spans) -> dict:
    """One request of the cell's kind under the sync debug mode: the
    synchronising calls it warns of, each by the line of the port that made
    it, beside the ``syncs`` the spans of its search counted."""
    sut = gen.sut
    k = gen.k
    if hasattr(sut, "serve"):
        def one():
            row = gen.rows(1)
            return row, gen.inp.queries[row[0]]

        def run():
            return sut.serve(one, 16, k, None)
    else:
        def run():
            return sut.search(gen.inp.queries[gen.rows(128)], k)
    sites: collections.Counter = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = traceback.extract_stack()[:-1]
            ours = [f for f in stack if "repro_torch" in f.filename] or stack[-4:]
            sites[" <- ".join(f"{Path(f.filename).name}:{f.lineno} {f.line}"
                              for f in reversed(ours[-1:] if "repro_torch" in ours[-1].filename
                                                else ours))] += 1

    torch.cuda.synchronize()
    with spans.recording() as rec, warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    tops = [s for s in rec.spans if s.name in SEARCH_CALLS
            and not _under(rec.spans, s, SEARCH_CALLS)]
    beams = [s.attrs.get("rounds") for s in rec.spans if s.name == "search.beam"]
    return dict(counted=sum(s.attrs["syncs"] for s in tops), warned=sum(sites.values()),
                rounds=beams, sites=dict(sites.most_common()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="the CPU tests' widths")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    t_start = time.perf_counter()

    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "2"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from repro_torch import kernels as K
    from repro_torch import spans
    from vbench import harness
    from vbench import trace as vtrace

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell = harness.find_cell(args.workload, cfg_overrides=TINY if args.tiny else None)
    # the insert pool lasts every window
    gen = harness.set_up(cell, args.seed, args.seconds * 2 * args.pairs, dev)
    hspans: list = []
    if hasattr(gen.sut, "instrument"):
        gen.sut.instrument(hspans)
    report = dict(workload=args.workload, seed=args.seed, seconds=args.seconds,
                  device=torch.cuda.get_device_name(dev) if cuda else "cpu",
                  setup_s=time.perf_counter() - t_start, windows=[])
    if cuda:
        import subprocess

        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()

    # -- windows, the recorder off and on, in turns ------------------------------
    for pair in range(args.pairs):
        for on in ((False, True) if pair % 2 == 0 else (True, False)):
            h0 = len(hspans)
            with spans.recording() if on else contextlib.nullcontext() as rec:
                w = gen.window(args.seconds, hspans)
                sync()
            row = dict(pair=pair, recorder=on, **_window_numbers(w.requests, w.seconds))
            hw = hspans[h0:]
            row["fanout.ms_per_batch"] = _outside(hw, "fanout")
            row["insert.ms_per_batch"] = _outside(hw, "insert")
            if on:
                ss = rec.spans
                idx = list(range(len(ss)))
                row.update(layer_metrics(ss, idx), spans=len(idx), dropped=rec.dropped)
                row["by_name"] = by_name(ss, idx)
                # the inside clock against the outside one
                row["index.insert_ms"] = row["by_name"].get("index.insert", [0, None])[1]
                row["fanout.search_ms"] = row["by_name"].get("fanout.search", [0, None])[1]
                row["engine.batch_ms"] = row["by_name"].get("engine.batch", [0, None])[1]
            report["windows"].append(row)
            print(json.dumps({k: v for k, v in row.items() if k != "by_name"}), flush=True)

    # -- the traced stretch, the recorder on ------------------------------------
    profs = []
    read = vtrace.read

    def keep(prof):
        profs.append(prof)
        return read(prof)

    tries = []

    def stretch():
        tries.append(time.perf_counter())
        gen._closed([], int(gen.t.get("trace_rounds", 1)), None)

    vtrace.read = keep
    try:
        with spans.recording() as rec:
            tr = vtrace.traced(stretch, K.launch_counts, dev)
    finally:
        vtrace.read = read
    held = between(rec.spans, tries[-1], time.perf_counter())  # the attempt that held
    ibs = idle_by_span(profs[-1], vtrace.WINDOW_MARK)
    report["stretch"] = dict(breakdown=tr.breakdown(), kernels=tr.kernels,
                             trace_busy_s=tr.busy_s, trace_window_s=tr.window_s, **ibs)
    report["stretch"]["spans"] = by_name(rec.spans, held)
    report["stretch"]["tries"] = len(tries)
    print(json.dumps(dict(stretch=dict(
        busy_pct=100 * tr.busy_s / tr.window_s if tr.window_s else None,
        idle_s=ibs["idle_s"], window_less_busy_s=ibs["window_s"] - ibs["busy_s"],
        idle_by_span=sorted(ibs["idle_by_span"].items(), key=lambda kv: -kv[1])[:12]))),
        flush=True)

    if cuda:
        report["sync_check"] = sync_check(gen, torch, spans)
        print(json.dumps(dict(sync_check=report["sync_check"])), flush=True)
    gen.sut.close()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
