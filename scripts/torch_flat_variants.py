#!/usr/bin/env python3
"""Time variants of the port's dense flat_l2 kernels to see where their time goes.

    python3 scripts/torch_flat_variants.py    # needs one CUDA card and nvcc

Each variant is the kernel source with one part changed or taken out, built
with nvcc into build/flat_variants/<name>/ and timed by device time per call
(chip_smoke.device_ms) at B=128, N=100 000, D=768, with its max error
against float64 of its inputs (for bf16, of the bf16-rounded values).

f32, the 3xTF32 kernel:

  base          the kernel as it is
  one_product   hi*hi only (the two cross products taken out)
  zero_product  no tensor-core product at all: the copies, the pass that
                writes x's low parts and sums the norms, and the barriers

bf16, the wgmma.m64nNk16 kernel (the design the launcher takes: an N tile
of 128, a 6-stage TMA ring, one wgmma group left in flight):

  bf16_base        the kernel as it is
  bf16_wait0       wgmma.wait_group 0 each step: no product overlaps the next
  bf16_n256        an N tile of 256 (wgmma.m64n256k16, q read from L2 half as
                   often) with the 4-stage ring that fits beside it
  bf16_4st         a 4-stage ring
  bf16_no_product  no tensor-core product: copies, norms and the epilogue
  bf16_no_store    no output store: copies, products and norms
  bf16_stcs        the output stored with __stcs (evict first), so it does
                   not push q out of L2
  bf16_l2_none     no L2 promotion (the kernel: 256 bytes, so a miss also
                   fetches the row's next 64-deep step)

Every variant is timed TURNS times in turns (forward, then backward), so
that differences can be told from the spread. Last, a yardstick: one copy_
moving the bf16 kernel's bytes, half read and half written, and the rate it
reaches.
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
TILE_N = "constexpr int kBf16TileN = 128;"
STAGES = "constexpr int kBf16Stages = 6;"
WAIT = "constexpr int kBf16WaitDepth = 1;"
BF16_PRODUCT = "        wgmma_bf16<kBN>(acc, sw128_desc(qa + 32 * kk), sw128_desc(xa + 32 * kk));\n"
BF16_STORE = "            *reinterpret_cast<float4*>(o) = v;\n"
PROMOTION = "CU_TENSOR_MAP_L2_PROMOTION_L2_256B"
TURNS = 4
# name: (bf16 inputs, edits of the source)
VARIANTS = {
    "base": (False, []),
    "one_product": (False, [(LO_HI, ""), (HI_LO, "")]),
    "zero_product": (False, [(LO_HI, ""), (HI_LO, ""), (HI_HI, "")]),
    "bf16_base": (True, []),
    "bf16_wait0": (True, [(WAIT, WAIT.replace("= 1;", "= 0;"))]),
    "bf16_n256": (True, [(TILE_N, TILE_N.replace("= 128;", "= 256;")),
                         (STAGES, STAGES.replace("= 6;", "= 4;"))]),
    "bf16_4st": (True, [(STAGES, STAGES.replace("= 6;", "= 4;"))]),
    "bf16_no_product": (True, [(BF16_PRODUCT, "")]),
    "bf16_no_store": (True, [(BF16_STORE, "")]),
    "bf16_stcs": (True, [(BF16_STORE, BF16_STORE.replace(
        "*reinterpret_cast<float4*>(o) = v;", "__stcs(reinterpret_cast<float4*>(o), v);"))]),
    "bf16_l2_none": (True, [(PROMOTION, PROMOTION.replace("PROMOTION_L2_256B", "PROMOTION_NONE"))]),
}


def ptxas_usage(log: str, kernel: str) -> list[str]:
    """The register and spill lines ptxas -v printed for each entry whose
    name contains ``kernel``."""
    found, entry = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif entry and kernel in entry and ("registers" in ln or "spill" in ln):
            found.append(ln.split(":", 1)[-1].strip())
    return found


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA card")
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build

    src = SOURCE.read_text()
    procs = {}
    for name, (bf16, edits) in VARIANTS.items():
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
    q16, x16 = q.bfloat16(), x.bfloat16()

    def float64_l2(a, b):
        a, b = a.double(), b.double()
        return ((a * a).sum(1)[:, None] + (b * b).sum(1)[None] - 2 * (a @ b.T)).clamp_min(0)

    want = {False: float64_l2(q, x), True: float64_l2(q16, x16)}
    out_t = torch.empty(B, N, device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi or torch.cuda.get_device_name(0), flush=True)
    calls = {}
    for name, proc in procs.items():
        bf16 = VARIANTS[name][0]
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"FAIL: {name} did not build:\n{log[-3000:]}")
            return 1
        lib = ctypes.CDLL(str(ROOT / "build" / "flat_variants" / name / "lib.so"))
        fn = lib.repro_flat_l2_dense
        fn.argtypes = _build.SIGNATURES["repro_flat_l2_dense"]
        a, b = (q16, x16) if bf16 else (q, x)

        def call(fn=fn, a=a, b=b, bf16=bf16, name=name):
            err = fn(a.data_ptr(), b.data_ptr(), out_t.data_ptr(), B, N, D, int(bf16), 0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        call()
        torch.cuda.synchronize()
        err = float((out_t.double() - want[bf16]).abs().max())
        kernel = "flat_dense_bf16" if bf16 else "flat_dense_3xtf32"
        calls[name] = (call, kernel)
        print(f"{name}: max abs err against float64 {err:.3e}, {ptxas_usage(log, kernel)}",
              flush=True)
    times = {name: [] for name in calls}
    for turn in range(TURNS):
        for name in (list(calls) if turn % 2 == 0 else list(reversed(calls))):
            call, kernel = calls[name]
            times[name].append(cs.device_ms(torch, call, 10, (kernel,), 1))
    for name, ms in times.items():
        print(f"{name}: " + ", ".join(f"{m:.4f}" for m in ms) + " ms", flush=True)
    # the rate plain streaming reaches on this card: one copy_ moving as many
    # bytes (half read, half written) as the bf16 kernel must
    moved = (B + N) * D * 2 + B * N * 4
    src_t = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
    dst_t = torch.empty_like(src_t)
    ms = cs.device_ms(torch, lambda: dst_t.copy_(src_t), 10)
    print(f"copy_ of {moved / 2e6:.1f} MB (read) into as many: {ms:.4f} ms, "
          f"{moved / ms / 1e9:.3f} TB/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
