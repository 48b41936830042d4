#!/usr/bin/env python3
"""Time the port's long-row topk_select against the chunk count it is given.

    python3 scripts/torch_topk_sweep.py    # needs one CUDA card

For each LONG_BLOCKS (the stage-1 blocks ``long_chunks`` aims for) and each
input (tie-heavy integers with 30 % +inf, normal floats, and a Q-Flat-like
row where 98 % of entries are +inf), at B=128, N=100 000, L=10 and L=50:
the kernel's device time per call (chip_smoke.device_ms) after checking its
indices and values against the plain version, and torch.topk's beside it.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA card")
        return 1
    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.kernels.topk_select import ops
    from repro_torch.kernels.topk_select.ref import topk_select_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, N = 128, 100_000
    ties = torch.randint(0, 64, (B, N), generator=g, device=dev).float()
    ties[torch.rand(B, N, generator=g, device=dev) < 0.3] = float("inf")
    normal = torch.randn(B, N, generator=g, device=dev)
    qflat = torch.rand(B, N, generator=g, device=dev)
    qflat[torch.rand(B, N, generator=g, device=dev) < 0.98] = float("inf")
    print(torch.cuda.get_device_name(0), flush=True)
    for L in (10, 50):
        for name, d in (("ties", ties), ("normal", normal), ("qflat", qflat)):
            lib = cs.device_ms(torch, lambda: torch.topk(d, L, dim=1, largest=False), 20)
            row = []
            for blocks in (256, 384, 512, 768, 1024):
                ops.LONG_BLOCKS = blocks
                v1, i1 = K.topk_select(d, L, True)
                v2, i2 = topk_select_ref(d, L, True)
                if not (torch.equal(i1, i2) and torch.equal(v1, v2)):
                    print(f"FAIL: L={L} {name} LONG_BLOCKS={blocks} differs")
                    return 1
                S, _ = ops.long_chunks(B, N, L)
                ms = cs.device_ms(torch, lambda: K.topk_select(d, L, True), 20, cs.OUR_KERNELS)
                row.append(f"{blocks}(S={S}) {ms:.4f}")
            print(f"L={L} {name}: torch.topk {lib:.4f} ms; " + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
