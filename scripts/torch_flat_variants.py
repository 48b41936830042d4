#!/usr/bin/env python3
"""Time variants of the port's dense flat_l2 kernel (3xTF32) to see where its time goes.

    python3 scripts/torch_flat_variants.py    # needs one CUDA card and nvcc

Each variant is the kernel source with one part taken out, built with nvcc
into build/flat_variants/<name>/ and timed by device time per call
(chip_smoke.device_ms) at B=128, N=100 000, D=768, with its max error
against float64:

  base          the kernel as it is
  one_product   hi*hi only (the two cross products taken out)
  zero_product  no tensor-core product at all: the copies, the pass that
                writes x's low parts and sums the norms, and the barriers
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
SOURCE = ROOT / "src/repro_torch/kernels/flat_l2/kernel.cu"
LO_HI = "      wgmma_tf32_m64n128k8(acc, alo[s8], dhi);  // the small terms first\n"
HI_LO = "      wgmma_tf32_m64n128k8(acc, ahi[s8], dlo);\n"
HI_HI = "      wgmma_tf32_m64n128k8(acc, ahi[s8], dhi);\n"
VARIANTS = {
    "base": [],
    "one_product": [(LO_HI, ""), (HI_LO, "")],
    "zero_product": [(LO_HI, ""), (HI_LO, ""), (HI_HI, "")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA card")
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build

    src = SOURCE.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                print(f"FAIL: {name}: the source no longer has {old.strip()!r}")
                return 1
            text = text.replace(old, new)
        out = ROOT / "build" / "flat_variants" / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "kernel.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out / "lib.so"),
             str(out / "kernel.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, N, D = 128, 100_000, 768
    q = torch.randn(B, D, generator=g, device=dev)
    x = torch.randn(N, D, generator=g, device=dev)
    q64, x64 = q.double(), x.double()
    want = ((q64 * q64).sum(1)[:, None] + (x64 * x64).sum(1)[None] - 2 * (q64 @ x64.T)).clamp_min(0)
    del x64
    out_t = torch.empty(B, N, device=dev)
    print(torch.cuda.get_device_name(0), flush=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"FAIL: {name} did not build:\n{log[-3000:]}")
            return 1
        lib = ctypes.CDLL(str(ROOT / "build" / "flat_variants" / name / "lib.so"))
        fn = lib.repro_flat_l2_dense
        fn.argtypes = _build.SIGNATURES["repro_flat_l2_dense"]

        def call():
            err = fn(q.data_ptr(), x.data_ptr(), out_t.data_ptr(), B, N, D, 0, 0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        call()
        err = float((out_t.double() - want).abs().max())
        ms = cs.device_ms(torch, call, 10, ("flat_dense_3xtf32",))
        regs = [ln.split(":")[-1].strip() for ln in log.splitlines() if "registers" in ln][:1]
        print(f"{name}: {ms:.4f} ms, max abs err against float64 {err:.3e}, {regs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
