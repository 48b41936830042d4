"""One dry-run cell traced at cut depths: a device's bytes (argument +
output + temp) at each layer count, and with ``--top`` the largest groups
of storage live at the peak (op, local shape, dtype, count), to see what
grows with depth. Runs on the host's CPU under a fake process group.

    PYTHONPATH=src python scripts/torch_dryrun_depth.py qwen3-moe-235b-a22b \\
        train_4k single 16 32 --top 8
"""
from __future__ import annotations

import argparse
import collections

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun


class PeakCounter(dryrun.CellCounter):
    """A CellCounter that keeps, at each new peak, what made each live
    storage: (op, local shape, dtype, bytes)."""

    def __init__(self):
        super().__init__()
        self.made: dict = {}
        self.at_peak: list = []
        self._op = None

    def track(self, t: torch.Tensor) -> None:
        local = dryrun._local(t)
        key = id(dryrun._storage(local)) if local.device.type != "meta" else None
        if key is not None and key not in self._live:
            self.made[key] = (self._op, tuple(local.shape), str(local.dtype))
        peak = self.peak
        super().track(t)
        if self.peak > peak:
            self.at_peak = [(self.made.get(k), n) for k, (_, n) in self._live.items()]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = str(func)
        return super().__torch_dispatch__(func, types, args, kwargs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("arch")
    ap.add_argument("shape", choices=list(SHAPES))
    ap.add_argument("mesh", choices=["single", "multi"])
    ap.add_argument("layers", type=int, nargs="+")
    ap.add_argument("--top", type=int, default=0, help="groups of live storage to print")
    args = ap.parse_args(argv)
    print(torch.__version__, flush=True)
    mesh = dryrun.production_mesh(args.mesh)
    cfg = get_config(args.arch)
    counters = []
    dryrun.CellCounter = lambda: counters.append(PeakCounter()) or counters[-1]
    for L in args.layers:
        v = dryrun._variant_cfg(cfg, L)
        rec = dryrun.trace(lambda: dryrun._build_step(v, SHAPES[args.shape], mesh), f"L{L}", True)
        m = rec["memory"]
        total = sum(m[k] for k in dryrun._PEAK) / 2**30
        print(f"layers {L}: {total:.2f} GiB a device (temp {m['temp_size_in_bytes'] / 2**30:.2f}), "
              f"trace {rec['compile_s']} s, reshards {rec['reshards']}, "
              f"replicated {rec['replicated']}", flush=True)
        groups: collections.Counter = collections.Counter()
        count: collections.Counter = collections.Counter()
        for made, n in counters[-1].at_peak:
            groups[made] += n
            count[made] += 1
        for made, n in groups.most_common(args.top):
            print(f"  {n / 2**30:8.3f} GiB  x{count[made]:<4d} {made}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
