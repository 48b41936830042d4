#!/usr/bin/env python3
"""Time the kernels of the search's and the build's beam rounds and
pq_encode, design by design and against another tree's wrappers.

    python3 scripts/torch_round_kernels.py --designs          # this tree's designs
    python3 scripts/torch_round_kernels.py --tree DIR         # DIR's wrappers
    python3 scripts/torch_round_kernels.py --parent DIR       # DIR, this, this, DIR; then --designs

Needs one CUDA card. Shapes are the main path's: pq_adc gathered at the
search round, B=128, C=164 (W=4 x R_slack=41), and at the build's round,
B=100, C=41 (W=1), V=2, M=96, K=256, N=100 000 with every 7th id -1;
topk_select at the beam merge (B=128, N=264, L=100), the frontier pick
(128, 100, 4), the rerank cut (128, 50, 10) and the prune cut (100, 316, 32)
on tie-heavy rows; pq_encode at D=768, M=96, K=256 on N=100 (an insert
mini-batch), 1 000 (the bootstrap) and 25 000 (the refinement) rows.

--designs calls the C launchers of this tree with each form code (pq_adc:
l2 and staged; topk_select: the rank form), checks each against the plain
version (pq_adc within rtol=atol=1e-5, topk_select bit for bit, pq_encode
by chip_smoke's near-tie rule), and prints its device time per call
(chip_smoke.device_ms). pq_adc is also timed on rows that all carry one
schema, where the staged form copies half the table, and the staged and
l2 forms at other rows per query (ADC_CROSSOVER: the build's beam has 41
rows, the search's 164), which sets ops.STAGED_MIN_ROWS.

--tree imports DIR/src/repro_torch and prints, for the wrappers at the
same shapes, the device time per call and the host time per call
(chip_smoke.host_ms: CUDA events around 200 back-to-back calls); with
--codes FILE it saves pq_encode's codes there. --parent runs --tree DIR,
--tree ., --tree ., --tree DIR in turns, each in its own process, compares
the two trees' pq_encode codes bit for bit, then runs --designs, and with
--out PATH writes everything there as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # chip_smoke's yardsticks; the package comes from --tree
ITERS = 200
ADC_SHAPE = dict(B=128, C=164, V=2, M=96, K=256, N=100_000)
BUILD_ROUND = dict(B=100, C=41)  # W=1: R_slack rows for each of a mini-batch's inserts
TOPK_SHAPES = {"merge": (128, 264, 100), "frontier": (128, 100, 4),
               "rerank": (128, 50, 10), "prune_cut": (100, 316, 32)}
ENCODE_ROWS = (100, 1000, 25_000)  # an insert mini-batch, the bootstrap, the refinement
ENCODE_SHAPE = dict(D=768, M=96, K=256)
# kernel names of earlier trees' forms beside this tree's: an earlier rank
# form and l2 form
KERNELS_EXTRA = ("topk_rank_kernel", "adc_gathered_kernel")


# rows per query at which the staged and l2 forms are compared, with rows of
# two schemas or of one: the build's beam (W=1: C = R_slack = 41, B=100
# inserts), the search's (C=164), and widths between
ADC_CROSSOVER = ((100, 41, False), (128, 64, False), (128, 96, False), (128, 112, False),
                 (128, 128, False), (100, 41, True), (128, 64, True), (128, 96, True),
                 (128, 112, True), (128, 128, True))


# the l2 form at the build's round on inputs that take parts of its work
# away: every id -1 (the id load alone), and 1 000 rows of codes (code loads
# from a hot 96 KB, not from 9.6 MB)
L2_PROBES = {"every id -1": dict(ids_valid=False), "N=1000 rows": dict(N=1000)}


def adc_inputs(torch, dev, one_schema: bool = False, B: int = 0, C: int = 0, M: int = 0,
               N: int = 0, ids_valid: bool = True):
    s = dict(ADC_SHAPE, **({"B": B, "C": C} if B else {}), **({"M": M} if M else {}),
             **({"N": N} if N else {}))
    g = torch.Generator(device=dev).manual_seed(1)
    luts = torch.randn(s["B"], s["V"], s["M"], s["K"], generator=g, device=dev)
    codes = torch.randint(0, s["K"], (s["N"], s["M"]), generator=g, device=dev, dtype=torch.uint8)
    versions = torch.randint(0, s["V"], (s["N"],), generator=g, device=dev, dtype=torch.uint8)
    if one_schema:
        versions.fill_(1)
    ids = torch.randint(0, s["N"], (s["B"], s["C"]), generator=g, device=dev, dtype=torch.int32)
    ids[:, ::7] = -1
    if not ids_valid:
        ids.fill_(-1)
    return luts, codes, versions, ids


def encode_inputs(torch, dev, n: int):
    """Rows (n, D) and codebooks (M, K, D/M), from a seed fixed by n."""
    g = torch.Generator(device=dev).manual_seed(n)
    s = ENCODE_SHAPE
    cb = torch.randn(s["M"], s["K"], s["D"] // s["M"], generator=g, device=dev)
    return torch.randn(n, s["D"], generator=g, device=dev), cb


def encode_bound_ms(cs, n: int) -> float:
    s = ENCODE_SHAPE
    return cs.bound(n * s["D"] * 4 + s["M"] * s["K"] * s["D"] // s["M"] * 4 + n * s["M"],
                    n * s["M"] * s["K"] * 2 * s["D"] // s["M"])[0]


def tie_heavy(torch, dev, rows: int, n: int):
    g = torch.Generator(device=dev).manual_seed(rows * 1000 + n)
    d = torch.randint(0, 64, (rows, n), generator=g, device=dev).float()
    d[torch.rand(rows, n, generator=g, device=dev) < 0.3] = float("inf")
    return d


def tree_times(tree: Path, codes_out: Path | None = None) -> dict:
    """Device and host ms per call of tree's wrappers at the path shapes."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as K

    dev = torch.device("cuda")
    names = cs.OUR_KERNELS + KERNELS_EXTRA

    def both(fn, iters=ITERS):
        return dict(ms=cs.device_ms(torch, fn, iters, names, per_call=1),
                    host_ms_per_call=cs.host_ms(torch, fn, iters))

    out = {}
    for key, shape in (("pq_adc.gathered", {}), ("pq_adc.gathered_l2 build round", BUILD_ROUND)):
        luts, codes, versions, ids = adc_inputs(torch, dev, **shape)
        out[key] = both(lambda: K.pq_adc(luts, codes, versions, ids))
        del luts, codes
    for name, (rows, n, L) in TOPK_SHAPES.items():
        d = tie_heavy(torch, dev, rows, n)
        out[f"topk_select {name}"] = both(lambda: K.topk_select(d, L))
    saved = {}
    for n in ENCODE_ROWS:
        x, cb = encode_inputs(torch, dev, n)
        saved[n] = K.pq_encode(x, cb).cpu()
        out[f"pq_encode N={n}"] = both(lambda: K.pq_encode(x, cb), ITERS if n < 10_000 else 20)
    if codes_out:
        torch.save(saved, codes_out)
    return out


def compare_codes(parent: Path, this: Path) -> dict:
    """The two trees' pq_encode codes, bit for bit; for codes that differ,
    the largest relative gap of the two centroids' squared distances
    (float64): a near-tie is within 1e-5."""
    import torch

    dev = torch.device("cuda")
    a, b = torch.load(parent), torch.load(this)
    out = {}
    for n in ENCODE_ROWS:
        bad = a[n] != b[n]
        res = dict(differ=int(bad.sum()), compared=bad.numel())
        if bad.any():
            x, cb = encode_inputs(torch, dev, n)
            nn, mm = bad.nonzero(as_tuple=True)
            sub = x.double().cpu().reshape(n, cb.shape[0], -1)[nn, mm]
            cbd = cb.double().cpu()
            s1 = ((sub - cbd[mm, a[n][nn, mm].long()]) ** 2).sum(-1)
            s2 = ((sub - cbd[mm, b[n][nn, mm].long()]) ** 2).sum(-1)
            res["max_rel_gap"] = float(((s1 - s2).abs() / s2.abs().clamp_min(1e-12)).max())
        out[f"N={n}"] = res
    return out


def designs() -> dict:
    """Every design of this tree's kernels, checked, by device time."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as K
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
                      B, N, L, 1, N, 0, int(mark), code)
        return vals, idx

    out = {}
    shapes = [(ADC_SHAPE["B"], ADC_SHAPE["C"], one) for one in (False, True)] + list(ADC_CROSSOVER)
    for B, C, one in shapes:
        luts, codes, versions, ids = adc_inputs(torch, dev, one_schema=one, B=B, C=C)
        ok = ids >= 0
        want = pq_adc_ref(luts, codes, versions, ids)
        for name, code in (("l2", ADC_FORMS["gathered_l2"]), ("staged", ADC_FORMS["gathered"])):
            got = adc(luts, codes, versions, ids, code)
            torch.cuda.synchronize()
            good = (torch.allclose(got[ok], want[ok], rtol=1e-5, atol=1e-5)
                    and bool(torch.isinf(got[~ok]).all()))
            key = f"pq_adc {name} B={B} C={C}{' one schema' if one else ''}"
            out[key] = dict(ok=good, max_abs_err=float((got - want).abs()[ok].max()),
                            ms=cs.device_ms(torch, lambda: adc(luts, codes, versions, ids, code),
                                            ITERS, cs.OUR_KERNELS, 1))
            print(key, json.dumps(out[key]), flush=True)
        del luts, codes
    for name, probe in L2_PROBES.items():
        luts, codes, versions, ids = adc_inputs(torch, dev, **BUILD_ROUND, **probe)
        key = f"pq_adc l2 B={BUILD_ROUND['B']} C={BUILD_ROUND['C']} {name}"
        out[key] = dict(ok=True, ms=cs.device_ms(
            torch, lambda: adc(luts, codes, versions, ids, ADC_FORMS["gathered_l2"]), ITERS,
            cs.OUR_KERNELS, 1))
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
                                                 cs.OUR_KERNELS, 1))
        print(key, json.dumps(out[key]), flush=True)
    for n in ENCODE_ROWS:
        x, cb = encode_inputs(torch, dev, n)
        key = f"pq_encode N={n}"
        try:
            _, differ, _ = cs.encode_same(torch, K, x, cb, key)
            good = True
        except AssertionError as e:
            print(e, flush=True)
            good, differ = False, None
        out[key] = dict(ok=good, differ=differ, bound_ms=encode_bound_ms(cs, n), ms=cs.device_ms(
            torch, lambda: K.pq_encode(x, cb), ITERS if n < 10_000 else 20, cs.OUR_KERNELS, 1))
        print(key, json.dumps(out[key]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--designs", action="store_true")
    ap.add_argument("--tree", type=Path)
    ap.add_argument("--codes", type=Path, help="with --tree: save pq_encode's codes here")
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--out", type=Path, help="with --parent: also write the results as JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA card")
        return 1
    if args.tree:
        print(json.dumps(tree_times(args.tree.resolve(), args.codes)), flush=True)
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
    with tempfile.TemporaryDirectory() as tmp:
        codes = {"parent": Path(tmp) / "parent.pt", "this": Path(tmp) / "this.pt"}
        for tree in (args.parent, ROOT, ROOT, args.parent):
            which = "parent" if tree == args.parent else "this"
            p = subprocess.run([sys.executable, __file__, "--tree", str(tree),
                                "--codes", str(codes[which])], capture_output=True, text=True)
            if p.returncode != 0:
                print(p.stdout[-3000:], p.stderr[-3000:])
                return 1
            res = json.loads(p.stdout.strip().splitlines()[-1])
            turns.append(dict(tree=which, times=res))
            print(json.dumps(turns[-1]), flush=True)
        same = compare_codes(codes["parent"], codes["this"])
    print("pq_encode codes, parent against this: " + json.dumps(same), flush=True)
    p = subprocess.run([sys.executable, __file__, "--designs"], capture_output=True, text=True)
    print(p.stdout[-8000:], p.stderr[-3000:], flush=True)
    found = json.loads(p.stdout.strip().splitlines()[-1]) if p.stdout.strip() else {}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=smi, turns=turns, pq_encode_codes=same,
                                            designs=found), indent=1))
    return p.returncode


if __name__ == "__main__":
    sys.exit(main())
