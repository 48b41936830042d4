#!/usr/bin/env python3
"""Time the two kernels every beam round launches, design by design and
against another tree's wrappers.

    python3 scripts/torch_round_kernels.py --designs          # this tree's designs
    python3 scripts/torch_round_kernels.py --tree DIR         # DIR's wrappers
    python3 scripts/torch_round_kernels.py --parent DIR       # DIR, this, this, DIR; then --designs

Needs one CUDA card. Shapes are the main path's: pq_adc gathered at B=128,
C=164 (W=4 x R_slack=41), V=2, M=96, K=256, N=100 000 with every 7th id -1;
topk_select at the beam merge (B=128, N=264, L=100), the frontier pick
(128, 100, 4), the rerank cut (128, 50, 10) and the prune cut (100, 316, 32)
on tie-heavy rows.

--designs calls the C launchers of this tree with each form code (pq_adc:
l2 and staged; topk_select: the rank form), checks each against the plain
version (pq_adc within rtol=atol=1e-5, topk_select bit for bit), and prints
its device time per call (chip_smoke.device_ms). pq_adc is also timed on
rows that all carry one schema, where the staged form copies half the
table, and the staged and l2 forms at fewer rows per query (ADC_CROSSOVER:
the build's beam has 41), which sets ops.STAGED_MIN_ROWS.

--tree imports DIR/src/repro_torch and prints, for the two wrappers at the
same shapes, the device time per call and the host time per call
(chip_smoke.host_ms: CUDA events around 200 back-to-back calls). --parent
runs --tree DIR, --tree ., --tree ., --tree DIR in turns, each in its own
process, then --designs, and with --out PATH writes everything there as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # chip_smoke's yardsticks; the package comes from --tree
ITERS = 200
ADC_SHAPE = dict(B=128, C=164, V=2, M=96, K=256, N=100_000)
TOPK_SHAPES = {"merge": (128, 264, 100), "frontier": (128, 100, 4),
               "rerank": (128, 50, 10), "prune_cut": (100, 316, 32)}
# kernel names of the parent's rank form, beside this tree's
KERNELS_EXTRA = ("topk_rank_kernel",)


# rows per query at which the staged and l2 forms are compared, with rows of
# two schemas or of one: the build's beam (W=1: C = R_slack = 41, B=100
# inserts) and widths around it
ADC_CROSSOVER = ((100, 24, False), (100, 41, False), (128, 64, False), (128, 96, False),
                 (100, 24, True), (100, 32, True), (100, 41, True))


def adc_inputs(torch, dev, one_schema: bool = False, B: int = 0, C: int = 0, M: int = 0):
    s = dict(ADC_SHAPE, **({"B": B, "C": C} if B else {}), **({"M": M} if M else {}))
    g = torch.Generator(device=dev).manual_seed(1)
    luts = torch.randn(s["B"], s["V"], s["M"], s["K"], generator=g, device=dev)
    codes = torch.randint(0, s["K"], (s["N"], s["M"]), generator=g, device=dev, dtype=torch.uint8)
    versions = torch.randint(0, s["V"], (s["N"],), generator=g, device=dev, dtype=torch.uint8)
    if one_schema:
        versions.fill_(1)
    ids = torch.randint(0, s["N"], (s["B"], s["C"]), generator=g, device=dev, dtype=torch.int32)
    ids[:, ::7] = -1
    return luts, codes, versions, ids


def tie_heavy(torch, dev, rows: int, n: int):
    g = torch.Generator(device=dev).manual_seed(rows * 1000 + n)
    d = torch.randint(0, 64, (rows, n), generator=g, device=dev).float()
    d[torch.rand(rows, n, generator=g, device=dev) < 0.3] = float("inf")
    return d


def tree_times(tree: Path) -> dict:
    """Device and host ms per call of tree's two wrappers at the path shapes."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as K

    dev = torch.device("cuda")
    names = cs.OUR_KERNELS + KERNELS_EXTRA
    luts, codes, versions, ids = adc_inputs(torch, dev)
    fn = lambda: K.pq_adc(luts, codes, versions, ids)  # noqa: E731
    out = {"pq_adc.gathered": dict(ms=cs.device_ms(torch, fn, ITERS, names),
                                   host_ms_per_call=cs.host_ms(torch, fn, ITERS))}
    for name, (rows, n, L) in TOPK_SHAPES.items():
        d = tie_heavy(torch, dev, rows, n)
        fn = lambda: K.topk_select(d, L)  # noqa: E731
        out[f"topk_select {name}"] = dict(ms=cs.device_ms(torch, fn, ITERS, names),
                                          host_ms_per_call=cs.host_ms(torch, fn, ITERS))
    return out


def designs() -> dict:
    """Every design of this tree's two kernels, checked, by device time."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.pq_adc.ops import FORMS as ADC_FORMS
    from repro_torch.kernels.pq_adc.ref import pq_adc_ref
    from repro_torch.kernels.topk_select.ops import FORMS as TOPK_FORMS
    from repro_torch.kernels.topk_select.ref import topk_select_ref

    dev = torch.device("cuda")
    _build.library()
    for line in _build.BuildInfo.log.splitlines():
        if any(w in line for w in ("registers", "spill", "rror", "arning")) or line.startswith("=="):
            print("  " + line.strip(), flush=True)

    def adc(luts, codes, versions, ids, code):
        B, V, M, K = luts.shape
        out = torch.empty(ids.shape, dtype=torch.float32, device=dev)
        _build.launch("repro_pq_adc", luts.data_ptr(), codes.data_ptr(), versions.data_ptr(),
                      ids.data_ptr(), out.data_ptr(), B, V, M, K, codes.shape[0], ids.shape[1],
                      code)
        return out

    def topk(d, L, code, mark=False):
        B, N = d.shape
        vals = torch.empty((B, L), dtype=torch.float32, device=dev)
        idx = torch.empty((B, L), dtype=torch.int32, device=dev)
        _build.launch("repro_topk_select", d.data_ptr(), vals.data_ptr(), idx.data_ptr(), None,
                      B, N, L, 1, N, int(mark), code)
        return vals, idx

    out = {}
    for one in (False, True):
        luts, codes, versions, ids = adc_inputs(torch, dev, one_schema=one)
        ok = ids >= 0
        want = pq_adc_ref(luts, codes, versions, ids)
        for name, code in (("l2", ADC_FORMS["gathered_l2"]), ("staged", ADC_FORMS["gathered"])):
            got = adc(luts, codes, versions, ids, code)
            torch.cuda.synchronize()
            err = float((got - want).abs()[ok].max())
            good = (torch.allclose(got[ok], want[ok], rtol=1e-5, atol=1e-5)
                    and bool(torch.isinf(got[~ok]).all()))
            key = f"pq_adc {name}{' one schema' if one else ''}"
            out[key] = dict(ok=good, max_abs_err=err, ms=cs.device_ms(
                torch, lambda: adc(luts, codes, versions, ids, code), ITERS, cs.OUR_KERNELS))
            print(key, json.dumps(out[key]), flush=True)
    for B, C, one in ADC_CROSSOVER:
        luts, codes, versions, ids = adc_inputs(torch, dev, one_schema=one, B=B, C=C)
        ok = ids >= 0
        want = pq_adc_ref(luts, codes, versions, ids)
        for name, code in (("l2", ADC_FORMS["gathered_l2"]), ("staged", ADC_FORMS["gathered"])):
            got = adc(luts, codes, versions, ids, code)
            good = torch.allclose(got[ok], want[ok], rtol=1e-5, atol=1e-5)
            key = f"pq_adc {name} B={B} C={C}{' one schema' if one else ''}"
            out[key] = dict(ok=good, ms=cs.device_ms(
                torch, lambda: adc(luts, codes, versions, ids, code), ITERS, cs.OUR_KERNELS))
            print(key, json.dumps(out[key]), flush=True)
    del luts, codes
    for name, (rows, n, L) in TOPK_SHAPES.items():
        d = tie_heavy(torch, dev, rows, n)
        code = TOPK_FORMS["rank"]
        good = True
        for mark in (False, True):
            v1, i1 = topk(d, L, code, mark)
            v2, i2 = topk_select_ref(d, L, mark)
            good &= torch.equal(i1, i2) and torch.equal(v1.view(torch.int32),
                                                        v2.view(torch.int32))
        key = f"topk_select {name} rank"
        out[key] = dict(ok=good, ms=cs.device_ms(torch, lambda: topk(d, L, code), ITERS,
                                                 cs.OUR_KERNELS))
        print(key, json.dumps(out[key]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--designs", action="store_true")
    ap.add_argument("--tree", type=Path)
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--out", type=Path, help="with --parent: also write the results as JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA card")
        return 1
    if args.tree:
        print(json.dumps(tree_times(args.tree.resolve())), flush=True)
        return 0
    if args.designs:
        res = designs()
        print(json.dumps(res), flush=True)
        return 0 if all(r["ok"] for r in res.values()) else 1
    if not args.parent:
        ap.error("give --designs, --tree DIR or --parent DIR")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for tree in (args.parent, ROOT, ROOT, args.parent):
        p = subprocess.run([sys.executable, __file__, "--tree", str(tree)], capture_output=True,
                           text=True)
        if p.returncode != 0:
            print(p.stdout[-3000:], p.stderr[-3000:])
            return 1
        res = json.loads(p.stdout.strip().splitlines()[-1])
        turns.append(dict(tree="parent" if tree == args.parent else "this", **{"times": res}))
        print(json.dumps(turns[-1]), flush=True)
    p = subprocess.run([sys.executable, __file__, "--designs"], capture_output=True, text=True)
    print(p.stdout[-6000:], p.stderr[-3000:], flush=True)
    found = json.loads(p.stdout.strip().splitlines()[-1]) if p.stdout.strip() else {}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=smi, turns=turns, designs=found), indent=1))
    return p.returncode


if __name__ == "__main__":
    sys.exit(main())
