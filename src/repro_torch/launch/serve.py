"""Serving launcher: ``python -m repro_torch.launch.serve --arch smollm-135m``
(the port of ``repro.launch.serve``).

Brings up the batched LM engine (smoke config) together with a vector
collection, runs a demo request mix (embed → ANN search → decode), and
prints throughput + RU accounting. Runs on the CUDA card unless
``--device cpu`` is given. The LM's weights are drawn from a torch
generator seeded 0, so its tokens differ from the reference launcher's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core import GraphConfig
from ..device import resolve_device
from ..models import model as M
from ..serve import (EngineConfig, ServeEngine, VectorCollectionService,
                     VectorQuery)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--corpus", type=int, default=500)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--dispatch-mode", default="serial",
                    choices=("serial", "replica", "spmd"),
                    help="engine dispatch plane: serial (one lane), "
                         "replica (N concurrent lanes + hedging), spmd "
                         "(all partitions in one stacked search, across "
                         "the ranks of a running process group)")
    ap.add_argument("--lanes", type=int, default=4,
                    help="replica lanes for --dispatch-mode=replica")
    ap.add_argument("--resident-frac", type=float, default=None,
                    metavar="F",
                    help="paged vector tier: keep only F of each "
                         "partition's full-precision pages resident "
                         "(search stays PQ-resident; rerank faults pages "
                         "in). Default: fully resident")
    ap.add_argument("--policy", default="static",
                    choices=("static", "adaptive"),
                    help="serving control plane: static pins beam width / "
                         "ingest yield / topology at their configured "
                         "values; adaptive closes the loop on the "
                         "observability rollups (serve/policy.py)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="dump retained request traces as JSON lines "
                         "(flight recorder + anomaly ring)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the labeled metrics registry in Prometheus "
                         "text exposition format")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only; no decode serving")
    model = M.init_params(torch.Generator(device).manual_seed(0), cfg, device)
    rng = np.random.RandomState(0)

    # vector side: random embeddings standing in for a production encoder
    dim = 32
    svc = VectorCollectionService(
        dim=dim,
        graph=GraphConfig(capacity=args.corpus + 256, R=16, M=8, L_build=32,
                          L_search=48, bootstrap_sample=128, refine_sample=10**9),
        max_vectors_per_partition=args.corpus + 128,
        engine_cfg=EngineConfig(dispatch_mode=args.dispatch_mode,
                                lanes=args.lanes, policy=args.policy),
        device=device,
    )
    vecs = rng.randn(args.corpus, dim).astype(np.float32)
    svc.upsert([{"id": i} for i in range(args.corpus)], vecs)
    if args.resident_frac is not None:
        svc.set_residency(args.resident_frac)

    engine = ServeEngine(cfg, model, batch_slots=4, s_max=128)
    t0 = time.time()
    total_ru = 0.0
    results = []
    for rid in range(args.requests):
        res = svc.query(VectorQuery(vector=vecs[rid] + 0.01, k=3))
        total_ru += res.ru
        results.append(res)
        engine.submit(rid, rng.randint(0, cfg.vocab_size, 12),
                      max_new_tokens=args.max_new_tokens)
    out = engine.run()
    dt = time.time() - t0
    tokens = sum(len(v) for v in out.values())
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"served {len(out)} requests, {tokens} tokens in {dt:.1f}s "
          f"({tokens/dt:.1f} tok/s on {where}), search RU total {total_ru:.0f}")
    snap = svc.engine.snapshot()
    pol = snap["policy"]
    print(f"policy[{pol['mode']}]: W={pol['beam_width']} "
          f"interleave={pol['ingest_interleave']} ticks={pol['ticks']} "
          f"w_changes={pol['w_changes']} last_scale={pol['last_scale']}")
    mem, vt = snap["memory"], snap["memory"]["vector_tier"]
    print(f"memory: pq={mem['resident']['pq_codes_bytes']/1024:.0f}KiB "
          f"adj={mem['resident']['adjacency_bytes']/1024:.0f}KiB resident; "
          f"vector tier {vt['resident_bytes']/1024:.0f}"
          f"/{vt['total_bytes']/1024:.0f}KiB paged "
          f"({vt['resident_pages']}/{vt['capacity_pages']} pages, "
          f"hit rate {vt['hit_rate']:.2f})")

    if args.trace_out:
        n = svc.engine.tracer.dump_jsonl(args.trace_out)
        print(f"wrote {n} trace records to {args.trace_out}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(svc.engine.obs.to_prometheus_text())
        print(f"wrote metrics exposition to {args.metrics_out}")
    # what was served, for a caller that checks it: the corpus (document i
    # is row i), the search answers (request i asked for row i + 0.01) and
    # the generated tokens
    return dict(corpus=vecs, search=results, tokens=out)


if __name__ == "__main__":
    main()
