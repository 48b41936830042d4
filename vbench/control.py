#!/usr/bin/env python3
"""The control of a cell's comparison, on the card: the reference put in the
program's place one precision below the configuration's (TF32 for its
float32), at the cell's own size and load, on several seeds in one process.
Each seed prints one JSON line with ``correct`` and each number compared
beside its limit; the control must come out not correct.

    python3 vbench/control.py --workload p1-search-b128 --seconds 5 --seeds 11 12 13

The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from vbench import harness

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    out = []
    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False, device="cuda",
                             system="control")
        line = dict(workload=args.workload, seed=seed, correct=r["correct"],
                    attempted=r["attempted"],
                    checks={k: [c["value"], c["rule"], c["limit"]] for k, c in r["checks"].items()})
        print(json.dumps(line), flush=True)
        out.append(r["correct"])
    return 0 if not any(out) else 1


if __name__ == "__main__":
    sys.exit(main())
