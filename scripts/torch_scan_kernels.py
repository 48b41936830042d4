#!/usr/bin/env python3
"""Time the kernels of the Q-Flat scan and of the cuts wider than 1024,
design by design and against another tree's wrappers.

    python3 scripts/torch_scan_kernels.py --designs          # this tree's designs
    python3 scripts/torch_scan_kernels.py --tree DIR         # DIR's wrappers
    python3 scripts/torch_scan_kernels.py --parent DIR       # DIR, this, this, DIR; then --designs

Needs one CUDA card. Shapes are the main path's: pq_adc's dense form at the
Q-Flat scan (B=128 queries, N=100 000 rows, V=2, M=96, K=256, rows of two
schemas); topk_select at L > 1024: N=100 000 with L=1025 and 1250 (Q-Flat's
cut at k=250) on tie-heavy and on normal rows, and the beam merge of a k=250
search (B=128, N=1414, L=1250).

--designs calls the C launchers of this tree with each design (pq_adc: the
bank-per-lane kernel with 2-byte code loads and with one byte a load; the
designs not kept are at git tag scan-kernel-variants; topk_select: the
radix form with its sort holding at least 2048, 4096 or 8192 candidates and
its passes aiming for 256 or 1024 blocks, and at the merge the sort form
against the radix form), checks each against the plain
version (pq_adc within rtol=atol=1e-5, topk_select bit for bit) and prints
its device time per call (chip_smoke.device_ms).

--tree imports DIR/src/repro_torch and prints, for the wrappers at the same
shapes, the device time per call and the host time per call
(chip_smoke.host_ms). --parent runs --tree DIR, --tree ., --tree ., --tree
DIR in turns, each in its own process, then --designs, and with --out PATH
writes everything there as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # chip_smoke's yardsticks; the package comes from --tree
ADC_SHAPE = dict(B=128, N=100_000, V=2, M=96, K=256)
# (name, B, N, L, normal rows?) -- the cuts wider than 1024 on the path
TOPK_SHAPES = (("wide", 128, 100_000, 1025, False), ("wide normal", 128, 100_000, 1025, True),
               ("qflat_k250", 128, 100_000, 1250, False),
               ("qflat_k250 normal", 128, 100_000, 1250, True),
               ("merge_k250", 128, 1414, 1250, False))
# the radix form's designs: (least candidates its sort holds, blocks a pass aims for)
RADIX_DESIGNS = ((4096, 256), (2048, 1024), (4096, 1024), (8192, 1024))
# kernel names of earlier trees' forms beside this tree's: the parent's dense
# and iterating kernels
KERNELS_EXTRA = ("adc_dense_smem_kernel", "topk_iter_kernel")


def adc_inputs(torch, dev):
    s = ADC_SHAPE
    g = torch.Generator(device=dev).manual_seed(1)
    luts = torch.randn(s["B"], s["V"], s["M"], s["K"], generator=g, device=dev)
    codes = torch.randint(0, s["K"], (s["N"], s["M"]), generator=g, device=dev, dtype=torch.uint8)
    versions = torch.randint(0, s["V"], (s["N"],), generator=g, device=dev, dtype=torch.uint8)
    return luts, codes, versions


def topk_rows(torch, dev, rows: int, n: int, normal: bool):
    g = torch.Generator(device=dev).manual_seed(rows * 1000 + n)
    if normal:
        return torch.randn(rows, n, generator=g, device=dev)
    d = torch.randint(0, 64, (rows, n), generator=g, device=dev).float()
    d[torch.rand(rows, n, generator=g, device=dev) < 0.3] = float("inf")
    return d


def iters(n: int) -> int:
    return 200 if n < 10_000 else 20


def tree_times(tree: Path) -> dict:
    """Device and host ms per call of tree's wrappers at the path shapes."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as K

    dev = torch.device("cuda")
    names = cs.OUR_KERNELS + KERNELS_EXTRA

    def both(fn, n_iters):
        # per_call learnt: the trees launch different kernels for one call
        return dict(ms=cs.device_ms(torch, fn, n_iters, names),
                    host_ms_per_call=cs.host_ms(torch, fn, n_iters))

    luts, codes, versions = adc_inputs(torch, dev)
    out = {"pq_adc.dense": both(lambda: K.pq_adc(luts, codes, versions), 10)}
    del luts, codes, versions
    for name, rows, n, L, normal in TOPK_SHAPES:
        d = topk_rows(torch, dev, rows, n, normal)
        # the parent's iterating kernel takes tens of ms at n = 1e5
        out[f"topk_select {name}"] = both(lambda: K.topk_select(d, L, n > 10_000), 3)
    return out


def designs() -> dict:
    """Every design of this tree's two kernels, checked, by device time."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.pq_adc.ops import DENSE_DESIGNS, FORMS as ADC_FORMS
    from repro_torch.kernels.pq_adc.ref import pq_adc_ref
    from repro_torch.kernels.topk_select.ops import FORMS as TOPK_FORMS, radix_plan, sort_keys
    from repro_torch.kernels.topk_select.ref import topk_select_ref

    dev = torch.device("cuda")
    _build.library()
    for line in _build.BuildInfo.log.splitlines():
        if any(w in line for w in ("registers", "spill", "rror", "arning")) or line.startswith("=="):
            print("  " + line.strip(), flush=True)

    def adc(luts, codes, versions, code):
        B, V, M, K = luts.shape
        out = torch.empty((B, codes.shape[0]), dtype=torch.float32, device=dev)
        _build.launch("repro_pq_adc", luts.data_ptr(), codes.data_ptr(), versions.data_ptr(),
                      None, out.data_ptr(), B, V, M, K, codes.shape[0], codes.shape[0], code)
        return out

    def topk(d, L, form, design, mark=True):
        B, N = d.shape
        vals = torch.empty((B, L), dtype=torch.float32, device=dev)
        idx = torch.empty((B, L), dtype=torch.int32, device=dev)
        if form == "radix":
            p = radix_plan(B, N, L, *design)
            ws = torch.empty(p["ws_bytes"], dtype=torch.uint8, device=dev)
            args = (ws.data_ptr(), B, N, L, p["S"], p["chunk"], p["P"])
        else:
            args = (None, B, N, L, 1, N, sort_keys(N))
        _build.launch("repro_topk_select", d.data_ptr(), vals.data_ptr(), idx.data_ptr(), *args,
                      int(mark), TOPK_FORMS[form])
        return vals, idx

    out = {}
    luts, codes, versions = adc_inputs(torch, dev)
    want = pq_adc_ref(luts, codes, versions)
    s = ADC_SHAPE
    bound = cs.bound(s["N"] * (s["M"] + 1) + s["B"] * s["V"] * s["M"] * s["K"] * 4
                     + s["B"] * s["N"] * 4, s["B"] * s["N"] * s["M"])[0]
    for name, code in (("bank, 2-byte code loads", ADC_FORMS["dense"]),
                       ("bank, 1-byte code loads", DENSE_DESIGNS["singles"])):
        got = adc(luts, codes, versions, code)
        torch.cuda.synchronize()
        key = f"pq_adc dense {name}"
        out[key] = dict(ok=torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                        max_abs_err=float((got - want).abs().max()), bound_ms=bound,
                        ms=cs.device_ms(torch, lambda: adc(luts, codes, versions, code), 10,
                                        cs.OUR_KERNELS, 1))
        print(key, json.dumps(out[key]), flush=True)
    del luts, codes, versions, want, got
    for name, rows, n, L, normal in TOPK_SHAPES:
        d = topk_rows(torch, dev, rows, n, normal)
        refs = {m: topk_select_ref(d, L, m) for m in (False, True)}
        variants = [("radix", p) for p in RADIX_DESIGNS]
        if n <= 16_384:
            variants.insert(0, ("sort", None))
        for form, design in variants:
            good = True
            for mark in (False, True):
                v1, i1 = topk(d, L, form, design, mark)
                v2, i2 = refs[mark]
                good &= torch.equal(i1, i2) and torch.equal(v1.view(torch.int32),
                                                            v2.view(torch.int32))
            per_call = 1 if form == "sort" else radix_plan(rows, n, L, *design)["kernels"]
            key = f"topk_select {name} {form}" + (
                " P>={} blocks={}".format(*design) if form == "radix" else "")
            out[key] = dict(ok=bool(good), ms=cs.device_ms(
                torch, lambda: topk(d, L, form, design), iters(n), cs.OUR_KERNELS, per_call))
            print(key, json.dumps(out[key]), flush=True)
        key = f"topk_select {name} torch.topk"
        out[key] = dict(ok=True, ms=cs.device_ms(
            torch, lambda: torch.topk(d, L, dim=1, largest=False), iters(n)))
        print(key, json.dumps(out[key]), flush=True)
        del d, refs
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
        turns.append(dict(tree="parent" if tree == args.parent else "this",
                          times=json.loads(p.stdout.strip().splitlines()[-1])))
        print(json.dumps(turns[-1]), flush=True)
    p = subprocess.run([sys.executable, __file__, "--designs"], capture_output=True, text=True)
    print(p.stdout[-8000:], p.stderr[-3000:], flush=True)
    found = json.loads(p.stdout.strip().splitlines()[-1]) if p.stdout.strip() else {}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=smi, turns=turns, designs=found), indent=1))
    return p.returncode


if __name__ == "__main__":
    sys.exit(main())
