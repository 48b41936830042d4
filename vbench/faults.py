#!/usr/bin/env python3
"""Faults planted in the program's PQ path, read on the card at a cell's own
size and load: each seed's set-up is built once, then a short window of the
cell's traffic runs sound and under each fault, and its answers are judged
as a run's are. Each (seed, fault) prints one JSON line with the numbers
compared. The readings give the recall limit its upper end.

    python3 vbench/faults.py --workload p1-search-b128 --seconds 3 --seeds 11 12 13

The faults act on ``repro_torch.core.search.pq_adc``, the ADC every beam
search round calls (the fan-out's stacked rounds among them), by changing
its lookup tables (B, V, M, K):

- ``adc_subspace``: one of the M subspaces dropped (its table zero);
- ``adc_tail8`` / ``adc_tail24``: the last 8 / 24 subspaces read the table
  entry of the code below their own (a tile's tail indexed one off);
- ``adc_shift``: every subspace does.

The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _tail(n):
    def f(luts):
        luts = luts.clone()
        luts[:, :, -n:, :] = luts[:, :, -n:, :].roll(1, dims=3)
        return luts
    return f


def _drop_one(luts):
    luts = luts.clone()
    luts[:, :, 0, :] = 0.0
    return luts


FAULTS = {
    "none": None,
    "adc_subspace": _drop_one,
    "adc_tail8": _tail(8),
    "adc_tail24": _tail(24),
    "adc_shift": lambda luts: luts.roll(1, dims=3),
}


def planted(fault):
    """Plant ``fault`` on the search's ADC; returns the function that takes it
    out again."""
    from repro_torch.core import search

    inner = search.pq_adc
    change = FAULTS[fault]
    if change is not None:
        search.pq_adc = lambda luts, codes, versions, ids=None: inner(
            change(luts), codes, versions, ids)
    return lambda: setattr(search, "pq_adc", inner)


def read(workload: str, seeds: list, seconds: float, faults: list, device="cuda"):
    """Yield one reading a (seed, fault): the numbers compared and the
    queries judged."""
    import torch

    from vbench import harness, judge

    dev = torch.device(device)
    cell = harness.find_cell(workload)
    for seed in seeds:
        gen = harness.set_up(cell, seed, seconds, dev)
        ctx = judge.Context(gen.inp, cell.cfg, dev)
        for fault in faults:
            undo = planted(fault)
            try:
                w = gen.window(seconds, [])
            finally:
                undo()
            quality, checks = judge.judge(w.requests, gen.ops, {}, ctx)
            yield dict(workload=workload, seed=seed, fault=fault,
                       answers=quality.get("answers", 0),
                       checks={k: [c["value"], c["rule"], c["limit"]] for k, c in checks.items()})
        gen.sut.close()
        del gen


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", default=list(FAULTS), choices=list(FAULTS))
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("the faults are read on a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for line in read(args.workload, args.seeds, args.seconds, args.faults):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
