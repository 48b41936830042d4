#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the CUDA card(s) of this machine.

    python3 vbench/run.py --workload p1-search-b128 --seed 7 --seconds 30 --trace 0

Prints the card's identity first; then, as its last lines on standard
error, each number compared with the reference beside its limit; and, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s``), with ``--trace 1`` ``breakdown``, and
last ``checks``. Without enough CUDA cards, or where the process has loaded
JAX or the JAX package once the window has closed, it prints no result and
exits non-zero.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
HOST_THREADS = 2  # the host's thread pools: one process with few threads runs steadier


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_identity(torch) -> str:
    """The card's name, power limit and SM clock (nvidia-smi), and the
    torch and CUDA versions."""
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        smi = q.stdout.strip().replace("\n", " | ") or f"nvidia-smi failed: {q.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi failed: {e}"
    return f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    # every build and kernel cache inside the checkout, at fixed paths
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from vbench import harness

    torch.set_num_threads(HOST_THREADS)

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(card_identity(torch), file=sys.stderr, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    found = []
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_process=T_PROCESS,
                              on_window_closed=lambda: found.extend(loaded_forbidden()))
    found = sorted(set(found) | set(loaded_forbidden()))
    if found:
        print(f"the process loaded {found} by the time the window closed", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} {c['rule']} {c['limit']!r} "
              f"{'holds' if c['holds'] else 'FAILS'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
