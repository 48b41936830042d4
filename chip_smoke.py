#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # the whole run, one card
    python3 chip_smoke.py --only-kernels  # build and check the kernels, stop

Phases, each printed on its own lines; any failure exits non-zero:

 1. environment: card name and power limit (nvidia-smi), torch and CUDA
    versions; float32 matmuls must not run in TF32.
 2. build: the kernels compile from the repository's sources at first use.
 3. kernels: each kernel form against its plain PyTorch version on the card,
    at the main path's shapes and at edge shapes, with the tests' tolerances
    (flat_l2 also against float64, within a limit that rejects bf16 or TF32
    inputs; every pq_adc edge also through the l2 form). Times, each as
    device time per call (torch.profiler's self device time of the kernels
    the calls launch, from a window holding exactly the kernels the calls
    launched): the kernel, its plain version and (where one exists) a single
    PyTorch call computing the same function; beside them the kernel's host
    time per call (CUDA events around back-to-back calls), which the
    host-bound main path pays. pq_encode is timed at each row count the
    main path gives it (100, 1 000, 25 000). The launch floor: the device
    time of one trivial PyTorch kernel (x.add_(1) on 128 elements), which no
    single launch beats.
 4. main path: a DiskANNIndex at the paper configuration's widths
    (768-D, M=96, R=32, L=100, W=4, k=10) built through ``insert`` on
    synthetic clustered low-rank data made from ``--seed``; 8 batches of 128
    queries through ``search``; one batch through each filtered plan
    (beta, qflat, post, brute), its first call and the median of 5 more
    timed; recall@10 against ``recall.ground_truth``, at
    the defaults and with the same beam reranked at k' = 10k.
 5. the card against the CPU: the built state (``snapshot``) restored into a
    ``device="cpu"`` index, one batch searched there with the plain versions.
 6. wide cuts: on the same index, one batch of 128 queries through
    ``search`` at k=250 (k' = 1250, so the beam holds L = 1250 and every
    merge keeps more than 1024) and through the qflat and brute plans at
    k=250 with phase 4's filters, each its first call and the median of 3
    more; recall@250 against ground truth, the launches of each topk_select
    form, and card-vs-CPU ids on 16 queries. ``--wide-parent DIR`` also runs
    this phase on DIR's package (an unpacked earlier commit), restored from
    the same state, in turns with this tree's (DIR, this, this, DIR), each in
    a process of its own.
 7. every kernel's launch counter (each form apart) rose during phase 4 or
    phase 6, but for the forms in OFF_PATH, which are named with the reason;
    pq_encode's launches are also counted by rows, beside each timed shape.
    (``--profile`` then profiles a query batch and insert mini-batches.)
 8. updates, after every other phase: (a) on phase 4's index, 1 000
    documents deleted in place (each call timed, p50 and p95), the
    consolidation sweep over every row, the medoid recomputed, 8 x 128
    queries searched (no deleted document; recall@10 over the live set
    beside phase 4's), the first 50 deletes again on the CPU from a snapshot
    (rows equal in 99 % of those either side touched); (b) 16 queries, 5
    pages of k=10 each at L=100, W=4, reranked (pages disjoint, no deleted
    document, their union against the exact top 50 >= 0.6, host ms and
    rounds per page, 4 queries again on the CPU); (c) a durable partition:
    a StoreProviderSet on the card with its paged tier at a quarter of its
    pages, built through ``insert`` to 20 000 documents (halved to 10 000
    at the least while the build is projected past 150 s), every insert
    mini-batch and delete call an operation window, a snapshot at 10 000,
    200 deletes and the sweep, then recovery into a fresh provider
    (recovery_invariants, equal ids for 128 queries) and from a WAL torn in
    its last record (reported, committed - 1 records applied). Each part's
    launches are counted from 0 and every form it runs must launch there;
    phase 3 holds each form at the shapes of these paths.
 9. a collection, after phase 8: a ``partition.Collection`` of 4
    StoreProviderSet partitions on the card at phase 4's widths, built
    through a ``serve.VectorCollectionService``'s ``upsert`` (the engine's
    ingest queue, one collection ``insert`` of 400 documents a call) from
    phase 4's first 40 000 vectors (halved to 20 000 at the least while the
    build is projected past 200 s; keys pk{i % 1024}, documents {id, cat =
    i % 10, tier = i % 3}; build rate); 8 x 128 queries
    through the serial ``batched_fanout_search`` and ``SpmdFanout`` (all 4
    partitions in one stacked search) in turns, equal bit for bit (ids,
    dists, RU, stats), p50 / p95 of each, the stacked call's first apart,
    launches per batch of each form; 16 queries again on the CPU, each
    partition's state restored there and merged with ``merge_topk`` (ids
    equal in 99 % of slots); ``distributed_search_fn`` over the
    shard-stacked partitions, equal to its per-shard composition on the
    card; the filtered fan-out with a Q-Flat and a beta predicate (plan,
    first call and the median of 5); 8 queries x 5 merged pages (disjoint,
    the emitted high-water mark ascending, their union against the exact
    top 50 >= 0.6); a ReplicaSet of 4 on partition 0 (a quorum insert of
    100, the primary killed and failed over, a hedged ``fanout_search`` with
    a seeded log-normal latency model, a secondary killed and rebuilt
    through ``probe_dead``: applied == committed, ``recovery_invariants``);
    a 1-partition collection split by 2 100 inserts (every document kept,
    the children [lo, mid) and [mid, hi), recall@10 >= 0.8); recall@10 of
    the fan-out >= 0.75. Its launches are counted from 0 and every form of
    PARTITION_FORMS must launch; phase 3 holds each form at the stacked
    shapes (B = 4 x 128 round, merge and rerank; the B=128 merge of 4 x 10).
    With ``--profile``, one serial and one stacked batch are profiled.
10. the service, after phase 9, on phase 9's collection: 1 024 of phase 4's
    queries through ``engine.submit_query`` (seeded Poisson arrivals offered
    far above what the card serves, so micro-batches of 16 form from a
    backlog) and ``drain``, in turns of 256 in the serial and the stacked
    (``spmd``) dispatch modes: responses equal bit for bit across the modes,
    wall ms per micro-batch (host clock, card synced) by bucket, QPS,
    launches per served query, the launch signatures flat after each
    bucket's first batch, one bucket against a direct
    ``batched_fanout_search``, recall@10 >= 0.75 (halved to 256 queries
    while projected past SERVE_BUDGET_S / 2); 256 queries at max_batch 64 in
    each mode; 64 single ``svc.query`` calls; 16 exact queries as one
    micro-batch on the partitions' device mirrors (the mirrors unchanged,
    ids equal to exact ground truth); the filtered plans (phase 9's plans,
    first call and the median of 5); 8 queries x 5 pages through
    ``query_page`` with every token through bytes and decoded onto the card
    (disjoint, >= 0.6 of the exact top 50, a token decoded again equal to
    itself); a throttled tenant, a deadline of 0 and a degraded partition;
    1 000 documents upserted while 512 queries flow (inserts/s, recall@10
    within 0.01); 16 requests again on the CPU from the collection's state
    carried across (ids equal in 99 % of slots, statuses equal, RU within
    1 %). Every form of SERVE_FORMS must launch, counted from 0; phase 3
    holds each form at the serving shapes (B=16 and 4 x 16 rounds, merges
    and reranks; the exact scan B=16 N=21 024 and its cut). With
    ``--profile``, one micro-batch of 16 is profiled in each mode. No time
    the engine models on its SimClock is printed as a card time.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores, dense
BF16_FLOPS = 989e12  # H100 SXM, bf16 on the tensor cores, dense
BUILD_BUDGET_S = 400.0  # about a third of the run's 1200 s limit
N_STOPS = (30_000, 50_000, 100_000)
# synthetic data (make_data)
N_CLUSTERS, LATENT, CENTER_SCALE, SPREAD, NOISE = 1000, 32, 2.0, 0.6, 0.05
# recall@10 floors. At the reference's defaults (k' = 5k = 50) the PQ codes
# cannot order the members of a tight cluster, and the true neighbours can
# fall past the rerank window though the beam holds them (PERF.md): the
# defaults' floor sits below the 0.80 the port aims for, to catch a graph or
# kernel fault and not that loss; the same beam reranked at k' = 10k must
# find nearly all of them.
RECALL_FLOOR_DEFAULTS = 0.75
RECALL_FLOOR_WIDE_RERANK = 0.95
WIDE_RERANK_MULTIPLIER = 10.0
FILTER_REPEATS = 5  # warmed calls of each filtered plan; their median is its time
PROFILE_TRIES = 5  # profiler windows device_ms takes before it times a CUDA graph instead


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# the port's CUDA kernels, by the names the profiler gives them
OUR_KERNELS = ("adc_staged_kernel", "adc_l2_kernel", "adc_dense_kernel",
               "topk_bitonic_kernel", "topk_chunk_kernel", "topk_merge_kernel", "topk_sort_kernel",
               "topk_radix_clear_kernel", "topk_radix_hist_kernel", "topk_radix_compact_kernel",
               "topk_runs_merge_kernel",
               "flat_dense_3xtf32_kernel", "flat_dense_bf16_kernel", "flat_gathered_kernel",
               "pq_encode_kernel")
# forms that neither the main path nor the wide cuts reach, and why; every
# other form must launch there
OFF_PATH = {
    "flat_l2.dense_bf16": "bf16 inputs: the index stores and queries float32 vectors",
}
WIDE_K = 250  # phase 6: k' = 5k = 1250 > 1024, the widest cut a reranking caller asks for
WIDE_REPEATS = 3  # warmed calls of each wide cut; their median is its time
WIDE_CPU_QUERIES = 16  # queries of each wide cut also run on the CPU
# phase 8: updates, pages and a durable partition on the built index
DELETES, DELETE_CALL, DELETE_CPU = 1000, 100, 50  # deletes, per call, also run on the CPU
PAGE_QUERIES, PAGES, PAGE_K, PAGE_CPU_QUERIES = 16, 5, 10, 4
PAGE_OVERLAP_FLOOR = 0.6  # 5 pages against the exact top 50 (the reference test's floor)
DURABLE_N, DURABLE_SNAPSHOT_AT = 20_000, 10_000  # N_durable, and the snapshot's point
DURABLE_BUDGET_S = 150.0  # N_durable halves, to DURABLE_SNAPSHOT_AT at least, past this
DURABLE_DELETES = 200
# phase 9: a collection of COLL_PARTS partitions at phase 4's widths
COLL_PARTS, COLL_KEYS = 4, 1024  # initial partitions; partition keys pk0 .. pk1023
N_COLL, N_COLL_MIN = 40_000, 20_000  # documents (target), halved to N_COLL_MIN at the least
# N_COLL halves while the build is projected past this: 40 000 took 154 s
# in one run and was projected at 159 s in another (the host's speed varies),
# and at 20 000 no partition holds the 5 000 matches that make the 60 %
# predicate take the beta plan
COLL_BUDGET_S = 200.0
COLL_MAX_PER, COLL_CAPACITY = 20_000, 21_024  # no split fires during the build
COLL_BATCHES, COLL_FILTER_REPEATS = 8, 5  # query batches of 128; warmed filtered calls
COLL_PAGE_QUERIES, COLL_CPU_QUERIES = 8, 16  # paged queries; queries also run on the CPU
REPLICAS, REPLICA_INSERTS = 4, 100
SPLIT_N, SPLIT_MAX = 2_100, 2_000  # one split of a 1-partition collection
SPLIT_RECALL_FLOOR = 0.8  # the reference test's floor
# the forms phase 9 must launch
PARTITION_FORMS = ("pq_adc.gathered", "pq_adc.gathered_l2", "pq_adc.dense", "topk_select.rank",
                   "topk_select.long", "flat_l2.gathered", "pq_encode")
# phase 10: the serving engine and the service over phase 9's collection
SERVE_BATCH, SERVE_WIDE_BATCH = 16, 64  # the engine's default max_batch; the top bucket
SERVE_QUERIES, SERVE_QUERIES_MIN, SERVE_TURN = 1024, 256, 256  # micro-batched queries, in turns
# the micro-batched queries halve (to SERVE_QUERIES_MIN at the least) while
# projected past half of this; the rest of the phase takes about as long again
SERVE_BUDGET_S = 120.0
SERVE_RATE_QPS = 100_000.0  # offered far above what the card serves: a backlog forms the batches
SERVE_WIDE, SERVE_SINGLE, SERVE_EXACT = 256, 64, 16  # queries at max_batch 64; single; exact
SERVE_INGEST, SERVE_INGEST_QUERIES = 1000, 512  # documents upserted while queries flow
SERVE_NEW_BASE = 1_000_000  # the upserted documents' first id
SERVE_CPU_REQUESTS = 16
# the forms phase 10 must launch
SERVE_FORMS = ("pq_adc.gathered", "pq_adc.gathered_l2", "pq_adc.dense", "topk_select.rank",
               "topk_select.long", "flat_l2.gathered", "flat_l2.dense", "pq_encode")
# the kernel forms each part of phase 8 must launch
UPDATE_FORMS = {
    "delete": ("flat_l2.gathered", "topk_select.rank"),
    "pages": ("pq_adc.gathered", "pq_adc.gathered_l2", "topk_select.rank", "flat_l2.gathered"),
    "durable": ("pq_encode", "pq_adc.gathered_l2", "pq_adc.gathered", "topk_select.rank",
                "flat_l2.gathered"),
}


def host_ms(torch, fn, iters: int) -> float:
    """CUDA events around iters back-to-back warmed calls, over iters: the
    wrapper's enqueue cost per call where the device work is shorter, the
    device time where it is longer."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)


def graph_ms(torch, fn, iters: int) -> float:
    """CUDA events around one replay of a CUDA graph of iters calls, over
    iters: device time with no host gaps between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def window_whole(named: int, iters: int, per_call: int) -> bool:
    """Whether a profiler window of iters calls kept every kernel they
    launched: exactly iters x per_call named kernel events. The profiler now
    and then loses a window's device events; a window with fewer is
    refused, and one with more ran something else."""
    return per_call >= 1 and named == iters * per_call


def _window(torch, fn, iters: int, kernels: tuple) -> tuple[int, float]:
    """One profiler window of iters calls: the device kernel events whose
    names contain one of ``kernels`` (or all), and their self device us. A
    window that recorded device kernels but none named in ``kernels`` is an
    error: a kernel missing from the filter must not be timed as something
    else."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    found = [e for e in device if not kernels or any(k in e.key for k in kernels)]
    check(not device or bool(found),
          f"device kernels {sorted({e.key[:60] for e in device})} but none named in {kernels}")
    return sum(e.count for e in found), sum(_device_us(e) for e in found)


def kernels_per_call(torch, fn, kernels: tuple = ()) -> int:
    """The named kernels one call launches: single calls profiled until two
    windows that recorded any agree."""
    seen = set()
    for _ in range(2 * PROFILE_TRIES):
        n, _ = _window(torch, fn, 1, kernels)
        if n > 0 and n in seen:
            return n
        seen.add(n)
    raise AssertionError(f"kernels per call not settled in {2 * PROFILE_TRIES} windows: {seen}")


def device_ms(torch, fn, iters: int, kernels: tuple = (), per_call: int | None = None) -> float:
    """Device time per call: the self device time of the kernels that iters
    warmed calls launch (those whose names contain one of ``kernels``, or
    all), summed under torch.profiler, over iters. ``per_call`` is the named
    kernels one call launches (given by the caller for the port's own forms,
    else learnt by kernels_per_call); a window is taken only when it holds
    all of them (window_whole), else taken again, at most PROFILE_TRIES
    times; after that one CUDA graph of the calls is timed with events, and
    a note says so."""
    # each window is a profile of its own: the note that events do not carry over is moot
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if per_call is None:
        per_call = kernels_per_call(torch, fn, kernels)
    for _ in range(PROFILE_TRIES):
        named, us = _window(torch, fn, iters, kernels)
        if us > 0 and window_whole(named, iters, per_call):
            return us / iters / 1e3
    print(f"note: no whole profiler window of {iters} x {per_call} kernels in {PROFILE_TRIES} "
          "tries; timing one CUDA graph of the calls instead", flush=True)
    return graph_ms(torch, fn, iters)


def timed(torch, kernel, plain, library, iters: int, per_call: int = 1) -> dict:
    """A kernel's device and host times, its plain version's and a library
    call's (None where no single PyTorch call computes the same function),
    all as device time per call. ``per_call``: the port's kernels one call
    of ``kernel`` launches; the plain and library calls' are learnt."""
    return dict(ms=device_ms(torch, kernel, iters, OUR_KERNELS, per_call),
                host_ms_per_call=host_ms(torch, kernel, iters),
                plain_ms=device_ms(torch, plain, max(iters // 4, 3)),
                library_ms=None if library is None else device_ms(torch, library, iters))


def bound(nbytes: float, ops: float, rate: float = FP32_FLOPS) -> tuple[float, str]:
    """The larger of bytes over the memory rate and ops over ``rate``, in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_data(torch, n: int, dim: int, seed: int, device):
    """Clustered points on a low-rank latent, projected to dim, plus small
    noise: 1000 clusters on a rank-32 latent, centres 2.0 N(0, 1) apart,
    points 0.6 N(0, 1) around their centre. Real embeddings have a low
    intrinsic dimension and topical clusters; isotropic noise in 768-D has
    no meaningful neighbours. How close this comes to real embeddings is not
    known until such a file is in the repository.
    Returns (n points, a function drawing more from the same distribution)."""
    g = torch.Generator(device=device).manual_seed(seed)
    proj = torch.randn(LATENT, dim, generator=g, device=device) / math.sqrt(LATENT)
    centers = CENTER_SCALE * torch.randn(N_CLUSTERS, LATENT, generator=g, device=device)

    def draw(m: int):
        assign = torch.randint(N_CLUSTERS, (m,), generator=g, device=device)
        z = centers[assign] + SPREAD * torch.randn(m, LATENT, generator=g, device=device)
        return z @ proj + NOISE * torch.randn(m, dim, generator=g, device=device)

    return draw(n), draw


def round_tf32(torch, t):
    """t (f32) with its mantissa rounded to TF32's 10 bits, kept as f32."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def encode_same(torch, K, xe, cbe, what: str) -> tuple[float, int, int]:
    """pq_encode's kernel against its plain version: at most 0.1 % of codes
    differ, each a near-tie within 1e-5 relative (the two centroids' squared
    distances in float64). Returns (the largest gap of a differing code,
    codes differing, codes)."""
    from repro_torch.kernels.pq_encode.ref import pq_encode_ref

    c1, c2 = K.pq_encode(xe, cbe), pq_encode_ref(xe, cbe)
    bad = c1 != c2
    gap = 0.0
    if bad.any():
        nn, mm = bad.nonzero(as_tuple=True)
        sub = xe.double().reshape(xe.shape[0], cbe.shape[0], -1)[nn, mm]  # (n_bad, dsub)
        s1 = ((sub - cbe.double()[mm, c1[nn, mm].long()]) ** 2).sum(-1)
        s2 = ((sub - cbe.double()[mm, c2[nn, mm].long()]) ** 2).sum(-1)
        rel = float(((s1 - s2).abs() / s2.abs().clamp_min(1e-12)).max())
        gap = float((s1 - s2).abs().max())
        check(rel <= 1e-5, f"pq_encode {what}: a differing code is no near-tie (rel {rel})")
    n_bad = int(bad.sum())
    check(n_bad <= 1e-3 * bad.numel(), f"pq_encode {what}: {n_bad}/{bad.numel()} codes differ")
    return gap, n_bad, bad.numel()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_checks(torch, K, dev, N: int) -> dict:
    """One entry per kernel (the keys of K.launch_counts())."""
    from repro_torch.kernels.flat_l2.ref import flat_l2_gathered_ref, flat_l2_ref
    from repro_torch.kernels.pq_adc.ref import pq_adc_ref
    from repro_torch.kernels import _build
    from repro_torch.kernels.pq_adc.ops import FORMS as ADC_FORMS, adc_form
    from repro_torch.kernels.pq_encode.ref import pq_encode_ref
    from repro_torch.kernels.topk_select.ops import (LONG_MAX_L, RANK_MAX_N, SORT_MAX_N,
                                                     kernels_per_call, long_chunks, radix_plan,
                                                     topk_form)
    from repro_torch.kernels.topk_select.ref import topk_select_ref

    g = torch.Generator(device=dev).manual_seed(1)
    B, V, M, Kc, D, dsub = 128, 2, 96, 256, 768, 8
    C = 4 * 41  # W * R_slack candidates per beam round
    out = {}

    # -- pq_adc: gathered/versioned (beam round) and dense (Q-Flat) --------
    def adc_l2(luts, codes, versions, ids):
        """The l2 form's launcher called directly, whatever adc_form would
        pick: no launch counted (a comparison, not the main path)."""
        B_, V_, M_, K_ = luts.shape
        out = torch.empty(ids.shape, dtype=torch.float32, device=luts.device)
        _build.launch("repro_pq_adc", luts.data_ptr(), codes.data_ptr(), versions.data_ptr(),
                      ids.data_ptr(), out.data_ptr(), B_, V_, M_, K_, codes.shape[0],
                      ids.shape[1], ADC_FORMS["gathered_l2"])
        return out

    def adc_same(luts, codes, versions, ids, what, l2=False):
        """The kernel (adc_form's pick, or with ``l2`` the l2 form) against
        the plain version where ids are rows; +inf where they are not (< 0 or
        >= N). Returns the largest error."""
        got = (adc_l2 if l2 and luts.is_cuda else K.pq_adc)(luts, codes, versions, ids)
        ok = (ids >= 0) & (ids < codes.shape[0])
        want = pq_adc_ref(luts, codes, versions, torch.where(ok, ids, torch.zeros_like(ids)))
        err = float((got - want).abs()[ok].max()) if bool(ok.any()) else 0.0
        check(torch.allclose(got[ok], want[ok], rtol=1e-5, atol=1e-5), f"pq_adc {what}: err {err}")
        # the kernels write +inf there (the plain version, on a CPU rehearsal, any value)
        check(not got.is_cuda or bool(torch.isinf(got[~ok]).all()),
              f"pq_adc {what}: an id outside [0, N) not +inf")
        return err

    luts = torch.randn(B, V, M, Kc, generator=g, device=dev)
    codes = torch.randint(0, Kc, (N, M), generator=g, device=dev, dtype=torch.uint8)
    versions = torch.randint(0, V, (N,), generator=g, device=dev, dtype=torch.uint8)
    ids = torch.randint(0, N, (B, C), generator=g, device=dev, dtype=torch.int32)
    ids[:, ::7] = -1  # padding lanes, masked by the caller
    check(adc_form(C, V, M, Kc, True) == "gathered", "a beam round does not take the staged form")
    check(adc_form(1, V, M, Kc, True) == "gathered_l2", "the start node does not take the l2 form")
    err_g = adc_same(luts, codes, versions, ids, "gathered")
    err_gl = adc_same(luts, codes, versions, ids, "search round (l2)", l2=True)
    start = torch.randint(0, N, (B, 1), generator=g, device=dev, dtype=torch.int32)
    err_s = adc_same(luts, codes, versions, start, "start node")
    check(adc_form(N, V, M, Kc, False) == "dense", "Q-Flat does not take the dense form")
    got_d = K.pq_adc(luts, codes, versions)
    want_d = pq_adc_ref(luts, codes, versions)
    err_d = float((got_d - want_d).abs().max())
    check(torch.allclose(got_d, want_d, rtol=1e-5, atol=1e-5), f"pq_adc dense err {err_d}")
    # the dense form at its edges: M not a multiple of 32 (the last slot
    # part empty), odd M and codes at an odd address (no 2-byte code loads),
    # V=1, K < 256, rows not a multiple of a warp's 32, B past the SM count
    dense_edges = []
    for what, nb, nv, nm, nk, n_rows in (
            ("V=1", 8, 1, M, Kc, 5000), ("M=37", 8, 2, 37, Kc, 5000),
            ("M=100, a pair group and singles", 8, 2, 100, 64, 5000),
            ("M=8 K=16", 8, 2, 8, 16, 5000), ("K=16", 8, 2, M, 16, 5000),
            ("M=3 K=16", 8, 2, 3, 16, 777), ("N=1003", 8, 2, M, Kc, 1003),
            ("B=200, past the SM count", 200, 2, M, Kc, 3000),
            ("codes at an odd address", 8, 2, M, Kc, 2000)):
        el = torch.randn(nb, nv, nm, nk, generator=g, device=dev)
        buf = torch.randint(0, nk, (n_rows * nm + 1,), generator=g, device=dev,
                            dtype=torch.uint8)
        ec = buf[1:].view(n_rows, nm) if "odd" in what else buf[:-1].view(n_rows, nm)
        ev = torch.randint(0, nv + 1, (n_rows,), generator=g, device=dev, dtype=torch.uint8)
        check(adc_form(n_rows, nv, nm, nk, False) == "dense", f"pq_adc dense edge {what}: form")
        got_e, want_e = K.pq_adc(el, ec, ev), pq_adc_ref(el, ec, ev)
        err = float((got_e - want_e).abs().max())
        check(torch.allclose(got_e, want_e, rtol=1e-5, atol=1e-5), f"pq_adc dense {what}: err {err}")
        dense_edges.append(dict(case=what, max_abs_err=err))
    print("pq_adc dense edges: " + "; ".join(f"{e['case']} err {e['max_abs_err']:.2e}"
                                             for e in dense_edges), flush=True)
    # the gathered forms at their edges; each case takes the form adc_form gives it
    edges = []
    for what, nb, nc, nv, nm, nk, setup in (
            ("one schema of V=2", 8, C, 2, M, Kc, "one"), ("V=1", 8, C, 1, M, Kc, ""),
            ("every id -1", 8, C, V, M, Kc, "none"), ("ids >= N", 8, C, V, M, Kc, "past"),
            ("C=1", 8, 1, V, M, Kc, ""), ("C=193, past one tile", 8, 193, V, M, Kc, ""),
            ("C=400, three tiles", 4, 400, V, M, Kc, ""), ("M=8", 8, C, V, 8, Kc, ""),
            ("M=37", 8, C, V, 37, Kc, ""), ("K=16", 8, C, V, M, 16, ""),
            ("M=192, past one block", 4, C, V, 192, Kc, "")):
        n_rows = 1000
        el = torch.randn(nb, nv, nm, nk, generator=g, device=dev)
        ec = torch.randint(0, nk, (n_rows, nm), generator=g, device=dev, dtype=torch.uint8)
        ev = torch.randint(0, nv, (n_rows,), generator=g, device=dev, dtype=torch.uint8)
        ei = torch.randint(0, n_rows, (nb, nc), generator=g, device=dev, dtype=torch.int32)
        if setup == "one":
            ev.fill_(1)
        elif setup == "none":
            ei.fill_(-1)
        elif setup == "past":
            ei[:, ::3] = n_rows + torch.arange(ei[:, ::3].numel(), device=dev,
                                               dtype=torch.int32).reshape(nb, -1)
        form = adc_form(nc, nv, nm, nk, True)
        # each case through the form adc_form gives it, and through the l2 form
        edges.append(dict(case=what, form=form,
                          max_abs_err=adc_same(el, ec, ev, ei, f"{what} ({form})"),
                          l2_max_abs_err=adc_same(el, ec, ev, ei, f"{what} (l2)", l2=True)))
    check(edges[-1]["form"] == "gathered_l2", "an oversized table did not take the l2 form")
    # without ids (rows r = c): a dense call on fewer rows than STAGED_MIN_ROWS
    check(adc_form(50, V, M, Kc, False) == "gathered_l2", "50 dense rows do not take the l2 form")
    got_n = K.pq_adc(luts[:8], codes[:50], versions[:50])
    want_n = pq_adc_ref(luts[:8], codes[:50], versions[:50])
    err_n = float((got_n - want_n).abs().max())
    check(torch.allclose(got_n, want_n, rtol=1e-5, atol=1e-5),
          f"pq_adc l2 without ids: err {err_n}")
    edges.append(dict(case="no ids, N=50 (rows r = c)", form="gathered_l2", max_abs_err=err_n,
                      l2_max_abs_err=err_n))
    print("pq_adc gathered edges: " + "; ".join(f"{e['case']} -> {e['form']} err "
                                                f"{e['max_abs_err']:.2e}, l2 "
                                                f"{e['l2_max_abs_err']:.2e}" for e in edges),
          flush=True)

    def gathered_bound(codes, versions, ids, nv=V):
        """Bytes of one gathered call: ids, each valid row's code bytes and
        version, each table entry its lookups touch, the output."""
        Bq, Cq = ids.shape
        ok = ids >= 0
        valid = ids[ok].long()
        bq = torch.arange(Bq, device=dev)[:, None].expand(Bq, Cq)[ok]
        lut_idx = (((bq * nv + versions[valid].long())[:, None] * M + torch.arange(M, device=dev))
                   * Kc + codes[valid].long())
        n_ok = int(ok.sum())
        return bound(Bq * Cq * 4 + n_ok * (M + 1) + int(torch.unique(lut_idx).numel()) * 4
                     + Bq * Cq * 4, n_ok * M)

    gb, gby = gathered_bound(codes, versions, ids)
    db, dby = bound(N * (M + 1) + B * V * M * Kc * 4 + B * N * 4, B * N * M)
    # a page's round (one query, W * R_slack rows) and its start node (one row)
    luts1, ids1, start1 = luts[:1].contiguous(), ids[:1].contiguous(), start[:1].contiguous()
    check(adc_form(C, V, M, Kc, True) == "gathered", "a page's round does not take the staged form")
    err_p = adc_same(luts1, codes, versions, ids1, "page round B=1")
    err_p1 = adc_same(luts1, codes, versions, start1, "page start node B=1 C=1")
    pb, pby = gathered_bound(codes, versions, ids1)
    page_round = dict(form="page round", shape=f"B=1 C={C} V={V} M={M} K={Kc} N={N}",
                      bound_ms=pb, bound_by=pby, max_abs_err=err_p,
                      **timed(torch, lambda: K.pq_adc(luts1, codes, versions, ids1),
                              lambda: pq_adc_ref(luts1, codes, versions, ids1), None, 200))
    sb, sby = gathered_bound(codes, versions, start1)
    page_start = dict(form="page start node", shape=f"B=1 C=1 V={V} M={M} K={Kc} N={N}",
                      bound_ms=sb, bound_by=sby, max_abs_err=err_p1,
                      **timed(torch, lambda: K.pq_adc(luts1, codes, versions, start1),
                              lambda: pq_adc_ref(luts1, codes, versions, start1), None, 200))
    # the partition slice's stacked round: COLL_PARTS partitions of 128
    # lanes each over their concatenated rows, one schema (V=1)
    Bs, Ns = COLL_PARTS * 128, COLL_PARTS * COLL_CAPACITY
    luts_s = torch.randn(Bs, 1, M, Kc, generator=g, device=dev)
    codes_s = torch.randint(0, Kc, (Ns, M), generator=g, device=dev, dtype=torch.uint8)
    ver_s = torch.zeros(Ns, dtype=torch.uint8, device=dev)
    ids_s = torch.randint(0, Ns, (Bs, C), generator=g, device=dev, dtype=torch.int32)
    ids_s[:, ::7] = -1
    check(adc_form(C, 1, M, Kc, True) == "gathered", "the stacked round does not take the staged form")
    err_st = adc_same(luts_s, codes_s, ver_s, ids_s, "stacked round B=512 V=1")
    stb, stby = gathered_bound(codes_s, ver_s, ids_s, 1)
    stacked_round = dict(form="stacked round", shape=f"B={Bs} C={C} V=1 M={M} K={Kc} N={Ns}",
                         bound_ms=stb, bound_by=stby, max_abs_err=err_st,
                         **timed(torch, lambda: K.pq_adc(luts_s, codes_s, ver_s, ids_s),
                                 lambda: pq_adc_ref(luts_s, codes_s, ver_s, ids_s), None, 200))
    del luts_s, codes_s, ver_s, ids_s
    # the service's micro-batch (phase 10): a round of SERVE_BATCH lanes on one
    # partition's rows, and the stacked round of COLL_PARTS x SERVE_BATCH lanes
    serve_rounds = []
    for what, nb, nr in (("serving round", SERVE_BATCH, COLL_CAPACITY),
                         ("stacked serving round", COLL_PARTS * SERVE_BATCH,
                          COLL_PARTS * COLL_CAPACITY)):
        sl = torch.randn(nb, 1, M, Kc, generator=g, device=dev)
        sc = torch.randint(0, Kc, (nr, M), generator=g, device=dev, dtype=torch.uint8)
        sv = torch.zeros(nr, dtype=torch.uint8, device=dev)
        si = torch.randint(0, nr, (nb, C), generator=g, device=dev, dtype=torch.int32)
        si[:, ::7] = -1
        check(adc_form(C, 1, M, Kc, True) == "gathered", f"the {what} does not take the staged form")
        err_sr = adc_same(sl, sc, sv, si, f"{what} B={nb}")
        srb, srby = gathered_bound(sc, sv, si, 1)
        serve_rounds.append(dict(form=what, shape=f"B={nb} C={C} V=1 M={M} K={Kc} N={nr}",
                                 bound_ms=srb, bound_by=srby, max_abs_err=err_sr,
                                 **timed(torch, lambda: K.pq_adc(sl, sc, sv, si),
                                         lambda: pq_adc_ref(sl, sc, sv, si), None, 200)))
        del sl, sc, sv, si
    out["pq_adc.gathered"] = dict(
        max_abs_err=max([err_g, err_p, err_st] + [f["max_abs_err"] for f in serve_rounds]),
        bound_ms=gb, bound_by=gby, edges=edges,
        shape=f"B={B} C={C} V={V} M={M} K={Kc} N={N}",
        forms=[page_round, stacked_round] + serve_rounds,
        **timed(torch, lambda: K.pq_adc(luts, codes, versions, ids),
                lambda: pq_adc_ref(luts, codes, versions, ids), None, 200))
    # the l2 form at the build's beam rounds (W=1: C = R_slack = 41 rows for
    # each of a mini-batch's 100 inserts), rows of two schemas and of one
    Bb, Cb = 100, 41
    check(adc_form(Cb, V, M, Kc, True) == "gathered_l2", "a build round does not take the l2 form")
    luts_b = luts[:Bb].contiguous()
    ids_b = torch.randint(0, N, (Bb, Cb), generator=g, device=dev, dtype=torch.int32)
    ids_b[:, ::7] = -1
    one = torch.ones_like(versions)
    err_b2 = adc_same(luts_b, codes, versions, ids_b, "build round, two schemas")
    err_b1 = adc_same(luts_b, codes, one, ids_b, "build round, one schema")
    lb, lby = gathered_bound(codes, versions, ids_b)
    lb1, _ = gathered_bound(codes, one, ids_b)
    one_schema = dict(form="one schema", shape=f"B={Bb} C={Cb} V={V} M={M} K={Kc} N={N}",
                      bound_ms=lb1, max_abs_err=err_b1,
                      **timed(torch, lambda: K.pq_adc(luts_b, codes, one, ids_b),
                              lambda: pq_adc_ref(luts_b, codes, one, ids_b), None, 200))
    out["pq_adc.gathered_l2"] = dict(
        max_abs_err=max(err_b2, err_b1), start_node_max_abs_err=err_s,
        search_round_max_abs_err=err_gl, bound_ms=lb,
        bound_by=lby, shape=f"build round, two schemas B={Bb} C={Cb} V={V} M={M} K={Kc} N={N}",
        page_start_max_abs_err=err_p1, forms=[one_schema, page_start],
        **timed(torch, lambda: K.pq_adc(luts_b, codes, versions, ids_b),
                lambda: pq_adc_ref(luts_b, codes, versions, ids_b), None, 200))
    out["pq_adc.dense"] = dict(
        max_abs_err=max([err_d] + [e["max_abs_err"] for e in dense_edges]), edges=dense_edges,
        bound_ms=db, bound_by=dby, shape=f"B={B} N={N} V={V} M={M} K={Kc}",
        **timed(torch, lambda: K.pq_adc(luts, codes, versions),
                lambda: pq_adc_ref(luts, codes, versions), None, 10))
    del luts, codes, versions, got_d, want_d, luts_b, one, luts1

    # -- topk_select at every shape of the path, tie-heavy inputs ----------
    def topk_same(d, L, mark, what):
        v1, i1 = K.topk_select(d, L, mark_nonfinite=mark)
        v2, i2 = topk_select_ref(d, L, mark_nonfinite=mark)
        check(torch.equal(i1, i2), f"topk_select {what}: indices differ")
        # bit for bit: NaN equals NaN, -0.0 is told from +0.0
        check(torch.equal(v1.view(torch.int32), v2.view(torch.int32)),
              f"topk_select {what}: values differ")

    def tie_heavy(rows, n):
        d = torch.randint(0, 64, (rows, n), generator=g, device=dev).float()
        d[torch.rand(rows, n, generator=g, device=dev) < 0.3] = float("inf")
        return d

    def plan_of(rows, n, L):
        form = topk_form(n, L)
        if form == "long":
            return " S={} chunk={}".format(*long_chunks(rows, n, L))
        if form == "radix":
            p = radix_plan(rows, n, L)
            return (f" S={p['S']} chunk={p['chunk']} passes<={p['passes']} P={p['P']} "
                    f"runs={p['runs']}")
        return ""

    forms = {}
    # the path's shapes; the large-L forms (L > LONG_MAX_L) at the beam merge
    # of a k=250 search (L = k' = 1250 over 1250 + W * R_slack), Q-Flat's cut
    # at k'=1250, and N = 1e5 at L = 1025 (the iterating kernel's row in
    # PR 14), 5000 and 20 000 (merged runs); "normal" rows beside tie-heavy ones
    kw = WIDE_K * 5
    shapes = [("merge", B, 100 + C, 100, False), ("frontier", B, 100, 4, False),
              ("rerank", B, 50, 10, True), ("prune_cut", 100, 316, 32, False),
              ("brute", B, N, 10, True), ("qflat", B, N, 50, True),
              ("merge_k250", B, kw + C, kw, False), ("merge_k250 normal", B, kw + C, kw, False),
              ("wide", B, N, LONG_MAX_L + 1, True), ("wide normal", B, N, LONG_MAX_L + 1, True),
              ("qflat_k250", B, N, kw, True), ("wide L=5000", B, N, 5000, True),
              ("wide L=20000", B, N, 20_000, True),
              # a page (L=100, W=4, backup 512): the stable full sorts of the
              # refill (L + backup) and of a round (L + W * R_slack), the
              # backup's cut, the frontier pick, the pop and the rerank
              ("page_refill", 1, 100 + 512, 100 + 512, False),
              ("page_round", 1, 100 + C, 100 + C, False),
              ("page_backup", 1, 512 + C, 512, False), ("page_frontier", 1, 100, 4, False),
              ("page_pop", 1, 100, 100, False), ("page_rerank", 1, 10, 10, False),
              # a delete: the c=3 closest of N_out(p) to each b, for every b
              # of the hood at most (R_slack + R_slack^2), and each member's
              # closest sibling
              ("delete_splice", 41 + 41 * 41, 41, 3, False),
              ("delete_stitch", 41, 41, 1, False),
              # the partition slice: the stacked beam merge (COLL_PARTS x
              # 128 lanes) and distributed_search_fn's merge of COLL_PARTS
              # shards' top 10
              ("stacked_merge", COLL_PARTS * 128, 100 + C, 100, False),
              ("fanout_merge", 128, COLL_PARTS * 10, 10, False),
              # the service (phase 10): a micro-batch of SERVE_BATCH at the
              # engine's L = 5k = 50 (merge, frontier, rerank cut), its
              # stacked merge, and the exact plan's cut over one partition
              ("serve_merge", SERVE_BATCH, 50 + C, 50, False),
              ("serve_frontier", SERVE_BATCH, 50, 4, False),
              ("serve_rerank", SERVE_BATCH, 50, 10, True),
              ("serve_stacked_merge", COLL_PARTS * SERVE_BATCH, 50 + C, 50, False),
              ("serve_exact", SERVE_BATCH, COLL_CAPACITY, 10, True)]
    for name, rows, n, L, mark in shapes:
        form = topk_form(n, L)
        d = (torch.randn(rows, n, generator=g, device=dev) if "normal" in name
             else tie_heavy(rows, n))
        for m in (mark, not mark):
            topk_same(d, L, m, f"{name} B={rows} N={n} L={L} mark={m}")
        b_ms, b_by = bound(rows * n * 4 + rows * L * 8, rows * n)
        it = 200 if n < 10_000 else (3 if L > 10_000 else 20)
        forms.setdefault(form, []).append(dict(
            form=name, shape=f"B={rows} N={n} L={L}{plan_of(rows, n, L)}", bound_ms=b_ms,
            bound_by=b_by, max_abs_err=0.0,  # values equal bit for bit, checked above
            **timed(torch, lambda: K.topk_select(d, L, mark),
                    lambda: topk_select_ref(d, L, mark),
                    lambda: torch.topk(d, L, dim=1, largest=False), it,
                    per_call=kernels_per_call(rows, n, L))))
        del d
    # the rank form at its edges: L = 1 and L = N, tie-heavy rows and rows
    # all +inf, with NaN, with +-0.0 and -inf, both ways of marking
    for n in (1, 2, 33, 264, 316, RANK_MAX_N):
        check(topk_form(n, n) == "rank", f"N={n}: not a shape of the rank form")
        d = tie_heavy(5, n)
        for L in sorted({1, n}):
            for m in (False, True):
                topk_same(d, L, m, f"rank edge N={n} L={L} mark={m}")
    for n in (264, RANK_MAX_N):
        odd = torch.randn(4, n, generator=g, device=dev)
        odd[0] = float("inf")
        odd[1, ::7] = float("nan")
        odd[2, ::3] = 0.0
        odd[2, 1::3] = -0.0
        odd[3, ::5] = -float("inf")
        for L in (10, n):
            for m in (False, True):
                topk_same(odd, L, m, f"rank inf/NaN/-0 rows N={n} L={L} mark={m}")
    del odd
    # the long form at its edges, both ways of marking
    edges = [("N=1025", tie_heavy(3, 1025), 10), ("N prime", torch.randn(2, 99_991, generator=g,
                                                                          device=dev), 50)]
    _, chunk = long_chunks(1, 4096, LONG_MAX_L)
    check(chunk == LONG_MAX_L, f"long_chunks(1, 4096, {LONG_MAX_L}) gave chunk {chunk}")
    edges.append(("L = chunk", tie_heavy(1, 4096), LONG_MAX_L))
    odd = torch.randn(4, 5003, generator=g, device=dev)
    odd[0] = float("inf")  # a row all +inf
    odd[1, ::7] = float("nan")  # a row with NaN
    odd[2, ::3] = 0.0
    odd[2, 1::3] = -0.0  # -0.0 ties +0.0, lower position first
    odd[3, ::5] = -float("inf")
    edges.append(("inf/NaN/-0 rows", odd, 20))
    for what, d, L in edges:
        check(d.shape[1] > 1024 and L <= LONG_MAX_L, f"{what}: not a shape of the long form")
        for m in (False, True):
            topk_same(d, L, m, f"{what} N={d.shape[1]} L={L} mark={m}")
    del edges, odd
    # the sort and radix forms at their edges, both ways of marking: L = N
    # just past the rank form; N just past one sort block (L = 1025, and L =
    # N: merged runs); rows all +inf (ties past every value pass), with NaN,
    # +-0.0 and -inf, tie-heavy
    edges = [("L = N = 1025", tie_heavy(3, 1025), 1025),
             ("N just past a sort block", tie_heavy(3, SORT_MAX_N + 1), LONG_MAX_L + 1),
             ("L = N just past a sort block", tie_heavy(2, SORT_MAX_N + 1), SORT_MAX_N + 1)]
    for n, L in ((kw + C, kw), (20_000, kw), (20_000, 20_000)):
        odd = torch.randn(5, n, generator=g, device=dev)
        odd[0] = float("inf")
        odd[1, ::7] = float("nan")
        odd[2, ::3] = 0.0
        odd[2, 1::3] = -0.0
        odd[3, ::5] = -float("inf")
        odd[4] = tie_heavy(1, n)[0]
        edges.append((f"inf/NaN/-0/tie rows N={n}", odd, L))
    for what, d, L in edges:
        check(topk_form(d.shape[1], L) in ("sort", "radix"), f"{what}: not a large-L form")
        for m in (False, True):
            topk_same(d, L, m, f"{what} N={d.shape[1]} L={L} mark={m}")
    del edges, odd
    # rows up to RANK_MAX_N take the ranking kernel (the beam merge is the
    # main shape; the other short rows are listed beside it), longer rows the
    # two-stage long form (brute force and ground truth at L=10, Q-Flat at
    # k'=50), and L > LONG_MAX_L the sort form (rows up to SORT_MAX_N: the
    # beam merge at k=250) or the radix select (Q-Flat at k'=1250)
    for form, (main, *more) in forms.items():
        main["shape"] = f"{main.pop('form')} {main['shape']}"
        out[f"topk_select.{form}"] = dict(main, forms=more)

    # -- flat_l2: gathered difference form (rerank) and dense --------------
    x = torch.randn(N, D, generator=g, device=dev)
    q = torch.randn(B, D, generator=g, device=dev)
    rid = torch.randint(0, N, (B, 50), generator=g, device=dev, dtype=torch.int32)
    q64, x64 = q.double(), x.double()
    # the f32 kernels against float64: a few roundings of the largest sum,
    # grown as sqrt(D) over the D-term sums
    scale = float((q64 * q64).sum(1).max() + (x64 * x64).sum(1).max())
    f32_limit = 2 * math.sqrt(D) * torch.finfo(torch.float32).eps * scale
    got = K.flat_l2_gathered(q, x, rid)
    check(torch.allclose(got, flat_l2_gathered_ref(q, x, rid), rtol=1e-5, atol=1e-5),
          "flat_l2 gathered against its plain version")
    err_r = float((got.double() - ((q64[:, None] - x64[rid.long()]) ** 2).sum(-1)).abs().max())
    check(err_r <= f32_limit, f"flat_l2 gathered err {err_r} > f32 limit {f32_limit}")
    got_d = K.flat_l2(q, x)
    check(torch.allclose(got_d, flat_l2_ref(q, x), rtol=2e-3, atol=2e-3),
          "flat_l2 dense against its plain version")
    want64 = ((q64 * q64).sum(1)[:, None] + (x64 * x64).sum(1)[None]
              - 2 * (q64 @ x64.T)).clamp_min(0)
    del x64
    err_fd = float((got_d.double() - want64).abs().max())
    # the limit must tell f32 from reduced precision: the same product on
    # inputs rounded to bf16 (the kernel's bf16 mode) or to TF32's 10-bit
    # mantissa (what a TF32 tensor-core product rounds them to) exceeds it
    err_bf16 = float((K.flat_l2(q.bfloat16(), x.bfloat16()).double() - want64).abs().max())
    err_tf32 = float((K.flat_l2(round_tf32(torch, q), round_tf32(torch, x)).double()
                      - want64).abs().max())
    print(f"flat_l2 dense against float64: f32 kernel {err_fd:.3e}, limit {f32_limit:.3e}, "
          f"bf16 inputs {err_bf16:.3e}, TF32 inputs {err_tf32:.3e}", flush=True)
    check(err_fd <= f32_limit, f"flat_l2 dense err {err_fd} > f32 limit {f32_limit}")
    check(min(err_bf16, err_tf32) > f32_limit, "the f32 limit does not reject bf16 or TF32")
    del want64

    def ragged_held(qr, xr, what: str) -> list:
        """The dense kernel on qr, xr for l2 and ip, against its plain version
        and, within the f32 limit of these inputs, against float64 of them.
        Returns each metric's error and limit."""
        qr64, xr64 = qr.double(), xr.double()
        lim = (2 * math.sqrt(qr.shape[1]) * torch.finfo(torch.float32).eps
               * float((qr64 * qr64).sum(1).max() + (xr64 * xr64).sum(1).max()))
        held = []
        for metric in ("l2", "ip"):
            case = f"{metric} {what}"
            got_r = K.flat_l2(qr, xr, metric)
            check(torch.allclose(got_r, flat_l2_ref(qr, xr, metric), rtol=2e-3, atol=2e-3),
                  f"flat_l2 dense {case} against its plain version")
            dot = qr64 @ xr64.T
            want_r = (((qr64 * qr64).sum(1)[:, None] + (xr64 * xr64).sum(1)[None] - 2 * dot)
                      .clamp_min(0) if metric == "l2" else -dot)
            err = float((got_r.double() - want_r).abs().max())
            check(err <= lim, f"flat_l2 dense {case}: err {err} > f32 limit {lim}")
            held.append(dict(case=case, max_abs_err=err, f32_limit=lim))
        return held

    # ragged shapes: B and N past the 128x128 tiles, D past the 32-deep
    # slices; D % 4 != 0 takes the 4-byte copies
    for nq, nx, dd in ((129, 257, 100), (129, 257, 37)):
        ragged_held(torch.randn(nq, dd, generator=g, device=dev),
                    torch.randn(nx, dd, generator=g, device=dev), f"B={nq} N={nx} D={dd}")
    # bf16: two bf16 values multiply exactly in f32, so the kernel is held
    # to the f32 limit against float64 of the bf16-rounded inputs, at the
    # full shape and at ragged ones: B and N past the 128 x 128 tiles, D past
    # the 64-deep steps; D % 8 != 0 (100, 37) or a pointer not 16-byte
    # aligned takes the narrow copy path, N % 4 != 0 the 4-byte stores
    q16, x16 = q.bfloat16(), x.bfloat16()
    got_b = K.flat_l2(q16, x16)
    check(torch.allclose(got_b, flat_l2_ref(q16, x16), rtol=2e-3, atol=2e-3),
          "flat_l2 dense bf16 against its plain version")
    q16d, x16d = q16.double(), x16.double()
    want16 = ((q16d * q16d).sum(1)[:, None] + (x16d * x16d).sum(1)[None]
              - 2 * (q16d @ x16d.T)).clamp_min(0)
    del x16d
    err_b = float((got_b.double() - want16).abs().max())
    check(err_b <= f32_limit, f"flat_l2 dense bf16 err {err_b} > f32 limit {f32_limit}")
    del want16, got_b
    ragged = []
    for nq, nx, dd, aligned in ((129, 257, 100, True), (129, 257, 37, True), (129, 257, 96, True),
                                (129, 1000, 96, True), (129, 1000, 96, False)):
        qr = torch.randn(nq, dd, generator=g, device=dev).bfloat16()
        xr = torch.randn(nx, dd, generator=g, device=dev).bfloat16()
        if not aligned:  # the same values 2 bytes past a 16-byte boundary
            buf = torch.empty(nx * dd + 1, dtype=torch.bfloat16, device=dev)
            buf[1:] = xr.reshape(-1)
            xr = buf[1:].view(nx, dd)
        ragged += ragged_held(qr, xr, f"bf16 B={nq} N={nx} D={dd}"
                              + ("" if aligned else " x unaligned"))
    print("flat_l2 dense bf16 against float64 of the bf16 values: "
          f"B={B} N={N} D={D} {err_b:.3e} (limit {f32_limit:.3e}); "
          + "; ".join(f"{r['case']} {r['max_abs_err']:.2e} (limit {r['f32_limit']:.2e})"
                      for r in ragged), flush=True)
    rows_read = int(torch.unique(rid).numel())
    rb, rby = bound(B * D * 4 + rows_read * D * 4 + B * 50 * 8, 3 * B * 50 * D)
    # three TF32 products on the tensor cores; the f32 bound beside it
    fb, fby = bound((B + N) * D * 4 + B * N * 4, 3 * 2 * B * N * D, TF32_FLOPS)
    f32b, _ = bound((B + N) * D * 4 + B * N * 4, 2 * B * N * D)
    bfb, bfby = bound((B + N) * D * 2 + B * N * 4, 2 * B * N * D, BF16_FLOPS)
    precision = dict(f32_limit=f32_limit, bf16_inputs_err=err_bf16, tf32_inputs_err=err_tf32)
    gathered_forms = []
    # a delete: every b of the hood at most (R_slack + R_slack^2) to the
    # decoded rows of N_out(p); a page's rerank: one query, k rows
    nout = x[:41].contiguous()
    xs = torch.randn(COLL_PARTS * COLL_CAPACITY, D, generator=g, device=dev)
    for what, qg, xg, ig in (
            ("delete b to N_out(p)", x[41:41 + 41 + 41 * 41], nout,
             torch.arange(41, dtype=torch.int32, device=dev).expand(41 + 41 * 41, 41)),
            ("page rerank", q[:1], x, rid[:1, :10]),
            # the stacked rerank: COLL_PARTS x 128 lanes over the partitions' rows
            ("stacked rerank", q.repeat(COLL_PARTS, 1), xs,
             torch.randint(0, COLL_PARTS * COLL_CAPACITY, (COLL_PARTS * B, 50), generator=g,
                           device=dev, dtype=torch.int32)),
            # the service's micro-batch (phase 10): one partition's rows, and
            # the stacked rerank of COLL_PARTS x SERVE_BATCH lanes
            ("serving rerank", q[:SERVE_BATCH], xs[:COLL_CAPACITY],
             torch.randint(0, COLL_CAPACITY, (SERVE_BATCH, 50), generator=g, device=dev,
                           dtype=torch.int32)),
            ("stacked serving rerank", q[:SERVE_BATCH].repeat(COLL_PARTS, 1), xs,
             torch.randint(0, COLL_PARTS * COLL_CAPACITY, (COLL_PARTS * SERVE_BATCH, 50),
                           generator=g, device=dev, dtype=torch.int32))):
        qg, ig = qg.contiguous(), ig.contiguous()
        got_g = K.flat_l2_gathered(qg, xg, ig)
        check(torch.allclose(got_g, flat_l2_gathered_ref(qg, xg, ig), rtol=1e-5, atol=1e-5),
              f"flat_l2 gathered {what} against its plain version")
        err = float((got_g.double() - ((qg.double()[:, None] - xg.double()[ig.long()]) ** 2)
                     .sum(-1)).abs().max())
        check(err <= f32_limit, f"flat_l2 gathered {what}: err {err} > f32 limit {f32_limit}")
        nb_, nc_ = ig.shape
        gbd, gby_ = bound(nb_ * D * 4 + int(torch.unique(ig).numel()) * D * 4 + nb_ * nc_ * 8,
                          3 * nb_ * nc_ * D)
        gathered_forms.append(dict(
            form=what, shape=f"B={nb_} C={nc_} D={D}", bound_ms=gbd, bound_by=gby_,
            max_abs_err=err,
            **timed(torch, lambda: K.flat_l2_gathered(qg, xg, ig),
                    lambda: flat_l2_gathered_ref(qg, xg, ig), None, 200)))
    out["flat_l2.gathered"] = dict(
        max_abs_err=max([err_r] + [f["max_abs_err"] for f in gathered_forms]),
        f32_limit=f32_limit, bound_ms=rb, bound_by=rby, shape=f"B={B} C=50 D={D}",
        forms=gathered_forms,
        **timed(torch, lambda: K.flat_l2_gathered(q, x, rid),
                lambda: flat_l2_gathered_ref(q, x, rid), None, 200))
    # the exact plan of the service (phase 10): a micro-batch against one
    # partition's rows
    qe, xe = q[:SERVE_BATCH].contiguous(), xs[:COLL_CAPACITY]
    got_e = K.flat_l2(qe, xe)
    check(torch.allclose(got_e, flat_l2_ref(qe, xe), rtol=2e-3, atol=2e-3),
          "flat_l2 dense exact scan against its plain version")
    qe64, xe64 = qe.double(), xe.double()
    err_e = float((got_e.double() - ((qe64 * qe64).sum(1)[:, None] + (xe64 * xe64).sum(1)[None]
                                     - 2 * (qe64 @ xe64.T)).clamp_min(0)).abs().max())
    lim_e = (2 * math.sqrt(D) * torch.finfo(torch.float32).eps
             * float((qe64 * qe64).sum(1).max() + (xe64 * xe64).sum(1).max()))
    check(err_e <= lim_e, f"flat_l2 dense exact scan err {err_e} > f32 limit {lim_e}")
    del qe64, xe64, got_e
    eb_, eby_ = bound((SERVE_BATCH + COLL_CAPACITY) * D * 4 + SERVE_BATCH * COLL_CAPACITY * 4,
                      3 * 2 * SERVE_BATCH * COLL_CAPACITY * D, TF32_FLOPS)
    exact_scan = dict(form="serving exact scan", shape=f"B={SERVE_BATCH} N={COLL_CAPACITY} D={D}",
                      bound_ms=eb_, bound_by=eby_, max_abs_err=err_e, f32_limit=lim_e,
                      **timed(torch, lambda: K.flat_l2(qe, xe), lambda: flat_l2_ref(qe, xe),
                              lambda: torch.cdist(qe, xe), 50))
    del xs
    out["flat_l2.dense"] = dict(
        max_abs_err=max(err_fd, err_e), **precision, bound_ms=fb, bound_by=fby,
        f32_bound_ms=f32b, forms=[exact_scan],
        # the Euclidean distance itself (its square root), one call
        library="torch.cdist", shape=f"B={B} N={N} D={D}",
        **timed(torch, lambda: K.flat_l2(q, x), lambda: flat_l2_ref(q, x),
                lambda: torch.cdist(q, x), 5))
    # the two routes a caller has without the bf16 kernel, on the upcast
    # values: torch.cdist (the row's library call) and the f32 kernel
    qf, xf = q16.float(), x16.float()
    f32_on_bf16 = device_ms(torch, lambda: K.flat_l2(qf, xf), 5, OUR_KERNELS, 1)
    print(f"flat_l2.dense_bf16: the f32 kernel on the upcast values, device {f32_on_bf16:.4f} "
          f"ms/call at B={B} N={N} D={D}", flush=True)
    out["flat_l2.dense_bf16"] = dict(
        max_abs_err=err_b, f32_limit=f32_limit, ragged=ragged, bound_ms=bfb, bound_by=bfby,
        library="torch.cdist on the upcast values", f32_kernel_on_upcast_ms=f32_on_bf16,
        shape=f"B={B} N={N} D={D} bf16",
        **timed(torch, lambda: K.flat_l2(q16, x16), lambda: flat_l2_ref(q16, x16),
                lambda: torch.cdist(qf, xf), 5))
    del x, got_d, q16, x16, qf, xf

    # -- pq_encode: an insert mini-batch, the bootstrap, the refinement ---
    # edges: each dsub the kernel templates or stages (2, 4, 8; 3, 6, 16,
    # 32), K below 256, one row
    edges = []
    for what, n, nm, nds, nk in (("dsub=2", 1000, 32, 2, 256), ("dsub=3", 1000, 16, 3, 256),
                                 ("dsub=4", 1000, 16, 4, 256), ("dsub=6", 1000, 16, 6, 256),
                                 ("dsub=16", 1000, 8, 16, 256), ("dsub=32", 1000, 4, 32, 256),
                                 ("K=16", 1000, 96, 8, 16), ("K=64", 1000, 96, 8, 64),
                                 ("N=1", 1, 96, 8, 256)):
        gap, n_bad, n_all = encode_same(torch, K, torch.randn(n, nm * nds, generator=g, device=dev),
                                        torch.randn(nm, nk, nds, generator=g, device=dev), what)
        edges.append(dict(case=what, max_abs_err=gap, mismatches=n_bad, compared=n_all))
    print("pq_encode edges: " + "; ".join(f"{e['case']} {e['mismatches']}/{e['compared']} "
                                          f"differ (gap {e['max_abs_err']:.2e})" for e in edges),
          flush=True)
    cb = torch.randn(M, Kc, dsub, generator=g, device=dev)
    shapes = []
    for n in (100, 1000, 25_000):  # an insert mini-batch, the bootstrap, the refinement
        xe = torch.randn(n, D, generator=g, device=dev)
        gap, n_bad, n_all = encode_same(torch, K, xe, cb, f"N={n}")
        eb, eby = bound(n * D * 4 + M * Kc * dsub * 4 + n * M, n * M * Kc * 2 * dsub)
        shapes.append(dict(
            form=f"N={n}", rows=n, max_abs_err=gap, mismatches=n_bad, compared=n_all,
            bound_ms=eb, bound_by=eby, shape=f"N={n} D={D} M={M} K={Kc}",
            **timed(torch, lambda: K.pq_encode(xe, cb), lambda: pq_encode_ref(xe, cb), None,
                    200 if n < 10_000 else 20)))
        del xe
    main, *more = shapes
    out["pq_encode"] = dict(main, max_abs_err=max(e["max_abs_err"] for e in shapes + edges),
                            edges=edges, forms=more)
    check(set(out) == set(K.launch_counts()), "a kernel was not checked")
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def build_index(torch, data_np, seed: int, n_max: int, dev):
    from repro_torch.core import DiskANNIndex, GraphConfig

    cfg = GraphConfig(capacity=n_max + 1024, R=32, M=96, L_build=100, L_search=100, beam_width=4)
    idx = DiskANNIndex(cfg, data_np.shape[1], seed=seed, device=dev)
    stops = [s for s in N_STOPS if s < n_max] + [n_max]
    t0 = time.perf_counter()
    done, last_t, cut = 0, 0.0, None
    for i, stop in enumerate(stops):
        idx.insert(list(range(done, stop)), data_np[done:stop])
        torch.cuda.synchronize()
        now = time.perf_counter() - t0
        rate = (stop - done) / max(now - last_t, 1e-9)
        print(f"build: {stop} docs at {now:.1f} s ({rate:.1f} inserts/s in the last segment, "
              f"schemas={len(idx.schemas)})", flush=True)
        done, last_t = stop, now
        if i + 1 < len(stops):
            projected = now + (stops[i + 1] - stop) / rate
            if projected > BUILD_BUDGET_S:
                cut = (f"N cut to {stop}: building {stops[i + 1]} was projected at "
                       f"{projected:.0f} s > {BUILD_BUDGET_S:.0f} s budget")
                break
    return idx, done, time.perf_counter() - t0, cut


def main_path(torch, np, K, dev, args) -> dict:
    from repro_torch.core import recall as rec

    data, draw = make_data(torch, args.n, 768, args.seed, dev)
    data_np = data.cpu().numpy()
    queries = draw(8 * 128).cpu().numpy()
    del data

    K.reset_launch_counts()
    idx, n, build_s, cut = build_index(torch, data_np, args.seed, args.n, dev)
    check(len(idx.schemas) == 2, "requantization did not fire: search would run with V=1")
    print(f"build: N={n} in {build_s:.1f} s = {n / build_s:.1f} inserts/s"
          + (f"; {cut}" if cut else ""), flush=True)

    # the live rows by schema version while the searches run: the staged ADC
    # form copies only the versions a round's candidates carry
    ver = idx.pv.versions[:n][idx.pv.live[:n]]
    version_share = {int(v): float((ver == v).mean()) for v in np.unique(ver)}
    print(f"search: live rows by schema version {version_share}", flush=True)

    counts_before_search = K.launch_counts()
    lat, results, stats = [], [], []
    for i in range(8):
        qb = queries[i * 128:(i + 1) * 128]
        t = time.perf_counter()
        ids, dists, st = idx.search(qb, k=10)
        lat.append(time.perf_counter() - t)
        check(ids.shape == (128, 10) and np.isfinite(dists).all(), "search output")
        check((np.diff(dists, axis=1) >= 0).all(), "search results not sorted")
        results.append(ids)
        stats.append(st)
    per_batch = {k: (v - counts_before_search[k]) / 8 for k, v in K.launch_counts().items()}

    live = idx.pv.live.copy()
    filt = {}
    broad = (np.arange(idx.cfg.capacity) % 10) < 3  # ~30 % of documents
    narrow = (np.arange(idx.cfg.capacity) % 50) == 0  # < 5000 documents: Q-Flat
    q0 = queries[:128]
    for mode, mask in (("beta", broad), ("qflat", narrow), ("post", broad), ("brute", broad)):
        secs = []  # the first call, then FILTER_REPEATS warmed ones
        for _ in range(1 + FILTER_REPEATS):
            t = time.perf_counter()
            ids, dists, st = idx.filtered_search(q0, 10, mask, mode=mode)
            secs.append(time.perf_counter() - t)
            check(ids.shape == (128, 10) and st.plan == mode, f"filtered {mode}")
            check(bool(mask[ids[ids >= 0]].all()), f"filtered {mode} returned a non-matching doc")
        filt[mode] = dict(seconds=float(np.median(secs[1:])), first_seconds=secs[0],
                          plan=st.plan, ids=ids, mask=mask)
    counts = K.launch_counts()  # the main path ends here
    encode_rows = K.encode_launches_by_rows()

    # recall against exact ground truth on the card (flat_l2 + topk_select)
    vec_t = torch.from_numpy(idx.pv.vectors).to(dev)
    live_t = torch.from_numpy(live).to(dev)
    gt = np.concatenate([rec.ground_truth(torch.from_numpy(queries[i:i + 128]).to(dev),
                                          vec_t, live_t, 10) for i in range(0, 1024, 128)])
    gt_docs = idx.slot_to_doc[gt]
    q64 = torch.from_numpy(queries[:128]).to(dev).double()
    d64 = torch.cdist(q64, vec_t.double()).square()
    d64[:, ~live_t] = float("inf")
    gt64 = d64.topk(10, dim=1, largest=False).indices.cpu().numpy()
    gt_agree = rec.recall_at_k(gt[:128], gt64, 10)
    check(gt_agree >= 0.999, f"ground truth disagrees with float64 ({gt_agree})")
    found = np.concatenate(results)
    recall = rec.recall_at_k(found, gt_docs, 10)
    # the same beam (L = 100) reranked at k' = 10k: what the beam holds
    wide = np.concatenate([idx.search(queries[i:i + 128], k=10,
                                      rerank_multiplier=WIDE_RERANK_MULTIPLIER)[0]
                           for i in range(0, 1024, 128)])
    recall_wide = rec.recall_at_k(wide, gt_docs, 10)
    for mode, f in filt.items():
        fm = torch.from_numpy(f["mask"] & live).to(dev)
        fgt = idx.slot_to_doc[rec.ground_truth(torch.from_numpy(q0).to(dev), vec_t, fm, 10)]
        f["recall"] = rec.recall_at_k(f["ids"], fgt, 10)
    lat_ms = np.asarray(lat) * 1e3
    out = dict(
        n=n, build_s=build_s, inserts_per_s=n / build_s, cut=cut,
        p50_ms=float(np.percentile(lat_ms, 50)), p95_ms=float(np.percentile(lat_ms, 95)),
        qps=1024 / float(np.sum(lat)), recall_at_10=recall,
        recall_at_10_wide_rerank=recall_wide,
        gt_float64_agreement=gt_agree,
        hops=float(np.mean([s.hops for s in stats])),
        cmps=float(np.mean([s.cmps for s in stats])),
        expansions=float(np.mean([s.expansions for s in stats])),
        launches=counts, launches_per_query_batch=per_batch, version_share=version_share,
        pq_encode_launches_by_rows=encode_rows,
        filtered={m: dict(seconds=f["seconds"], first_seconds=f["first_seconds"],
                          recall_at_10=f["recall"]) for m, f in filt.items()},
    )
    print("main path: " + json.dumps({k: v for k, v in out.items()}), flush=True)
    check(recall >= RECALL_FLOOR_DEFAULTS, f"recall@10 {recall} < {RECALL_FLOOR_DEFAULTS}")
    check(recall_wide >= RECALL_FLOOR_WIDE_RERANK,
          f"recall@10 at k'=10k {recall_wide} < {RECALL_FLOOR_WIDE_RERANK}")
    masks = {"qflat": narrow, "brute": broad}
    return out, idx, results[0], queries, gt_docs[:128], draw, masks


# ---------------------------------------------------------------------------
# phase 6: cuts wider than 1024
# ---------------------------------------------------------------------------


def wide_cut(torch, np, K, idx, q, masks: dict, gt: dict, cpu=None) -> dict:
    """search at k=WIDE_K and the qflat and brute plans at k=WIDE_K on idx
    (this tree's index or another tree's, restored from the same state):
    each call's first and median warmed wall time, rounds, the launches of
    each kernel form per call (counters reset just before), recall@WIDE_K
    against gt, and with ``cpu`` (an index on the CPU with the same state)
    the ids of WIDE_CPU_QUERIES queries compared."""
    from repro_torch.core import recall as rec

    out, counts = {}, {}
    K.reset_launch_counts()
    for name, call in (("search", lambda qq: idx.search(qq, k=WIDE_K)),
                       ("qflat", lambda qq: idx.filtered_search(qq, WIDE_K, masks["qflat"],
                                                                mode="qflat")),
                       ("brute", lambda qq: idx.filtered_search(qq, WIDE_K, masks["brute"],
                                                                mode="brute"))):
        before = K.launch_counts()
        secs = []
        for _ in range(1 + WIDE_REPEATS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ids, dists, st = call(q)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        after = K.launch_counts()
        check(ids.shape == (len(q), WIDE_K) and (name == "search" or st.plan == name),
              f"wide {name}: output {ids.shape}, plan {st.plan}")
        ok = ids >= 0
        check(bool(np.isfinite(dists[ok]).all()) and bool((np.diff(dists, axis=1)[ok[:, 1:]]
                                                            >= 0).all()),
              f"wide {name}: distances not finite and sorted")
        if name != "search":  # doc i lives in slot i here
            check(bool(masks[name][ids[ok]].all()), f"wide {name}: a non-matching doc")
        r = dict(ms=float(np.median(secs[1:])) * 1e3, first_ms=secs[0] * 1e3,
                 hops=float(st.hops), recall=rec.recall_at_k(ids, gt[name], WIDE_K),
                 launches_per_call={k: (after[k] - before[k]) / (1 + WIDE_REPEATS)
                                    for k in after if after[k] > before[k]})
        if cpu is not None:
            n = WIDE_CPU_QUERIES
            want = (cpu.search(q[:n], k=WIDE_K) if name == "search" else
                    cpu.filtered_search(q[:n], WIDE_K, masks[name], mode=name))[0]
            r["cpu_ids_equal"] = float((want == ids[:n]).mean())
        out[name] = r
        counts = K.launch_counts()
        print(f"wide {name} k={WIDE_K}: " + json.dumps(r), flush=True)
    return out, counts


def wide_state(path: Path, idx, q, masks, gt) -> None:
    """Everything another tree needs to run phase 6 on the same index."""
    import numpy as np

    snap = idx.snapshot()
    schemas = snap.pop("schemas")
    np.savez(path, **snap, **{f"schema_{i}": s for i, s in enumerate(schemas)}, queries=q,
             **{f"mask_{k}": v for k, v in masks.items()}, **{f"gt_{k}": v for k, v in gt.items()},
             cfg=np.asarray(json.dumps(idx.cfg._asdict())), dim=idx.dim)


def wide_tree(tree: Path, state: Path) -> int:
    """Phase 6 on tree's package (DIR/src/repro_torch), restored from state."""
    sys.path.insert(0, str(tree.resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.core import DiskANNIndex, GraphConfig

    z = np.load(state)
    cfg = json.loads(str(z["cfg"]))
    idx = DiskANNIndex(GraphConfig(**{k: v for k, v in cfg.items() if k in GraphConfig._fields}),
                       int(z["dim"]), device="cuda")
    snap = {k: z[k] for k in ("neighbors", "codes", "versions", "live", "vectors",
                              "slot_to_doc")}
    snap.update(count=int(z["count"]), medoid=int(z["medoid"]),
                graph_built=bool(z["graph_built"]),
                schemas=[z[f"schema_{i}"] for i in range(8) if f"schema_{i}" in z])
    idx.restore(snap)
    masks = {k: z[f"mask_{k}"] for k in ("qflat", "brute")}
    gt = {k: z[f"gt_{k}"] for k in ("search", "qflat", "brute")}
    out, counts = wide_cut(torch, np, K, idx, z["queries"], masks, gt)
    print(json.dumps(dict(tree=str(tree), wide=out, launches=counts)), flush=True)
    return 0


def profile(torch, np, idx, queries, draw, out_dir: Path) -> dict:
    """One query batch and three insert mini-batches, profiled (profile_runs)."""
    extra = draw(6 * idx.cfg.batch_size).cpu().numpy()
    first = idx.count
    half = 3 * idx.cfg.batch_size
    return profile_runs(torch, {
        "search": [lambda: idx.search(queries, k=10)] * 2,
        "insert": [lambda: idx.insert(list(range(first, first + half)), extra[:half]),
                   lambda: idx.insert(list(range(first + half, first + 2 * half)),
                                      extra[half:])],
    }, out_dir)


def profile_runs(torch, runs: dict, out_dir: Path) -> dict:
    """Each named pair of calls: the first timed once on the host clock
    without the profiler, the second under torch.profiler: the time the
    card's kernels take against that unprofiled wall time (the device's busy
    share; the profiler itself slows the host), and the kernels that take
    it. A table per name goes to out_dir."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    out_dir.mkdir(parents=True, exist_ok=True)
    summary = {}
    for name, (unprofiled, profiled) in runs.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        unprofiled()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        (out_dir / f"profile_{name}.txt").write_text(
            ka.table(sort_by="self_device_time_total", row_limit=40))
        kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
        busy = sum(_device_us(e) for e in kernels)
        ours = {}  # the port's kernels by name: (device ms, launches)
        for e in kernels:
            for k in OUR_KERNELS:
                if k in e.key:
                    ms, n = ours.get(k, (0.0, 0))
                    ours[k] = (ms + _device_us(e) / 1e3, n + e.count)
        top = sorted(kernels, key=_device_us, reverse=True)[:6]
        summary[name] = dict(
            wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
            busy_share=busy / wall_us if busy else "not measured",
            port_kernels_ms=sum(ms for ms, _ in ours.values()), port_kernels=ours,
            device_launches=sum(e.count for e in kernels),
            top=[(e.key[:60], _device_us(e) / 1e3, e.count) for e in top])
        print(f"profile {name}: " + json.dumps(summary[name]), flush=True)
    return summary


def cpu_compare(np, idx, gpu_ids, q, gt_docs) -> dict:
    from repro_torch.core import DiskANNIndex
    from repro_torch.core import recall as rec

    cpu = DiskANNIndex(idx.cfg, idx.dim, device="cpu")
    cpu.restore(idx.snapshot())
    t = time.perf_counter()
    ids, dists, _ = cpu.search(q, k=10)
    secs = time.perf_counter() - t
    same = float((ids == gpu_ids).mean())
    r_cpu, r_gpu = rec.recall_at_k(ids, gt_docs, 10), rec.recall_at_k(gpu_ids, gt_docs, 10)
    out = dict(ids_equal=same, recall_cpu=r_cpu, recall_gpu=r_gpu, cpu_seconds=secs)
    print("card vs cpu: " + json.dumps(out), flush=True)
    check(same >= 0.99, f"card and CPU ids agree in only {same:.4f} of slots")
    check(abs(r_cpu - r_gpu) <= 0.01, "card and CPU recall differ by more than 0.01")
    return out, cpu


def wide_phase(torch, np, K, idx, q, masks: dict, cpu, parent: str) -> tuple:
    """Phase 6 on this tree's index: ground truth at k=WIDE_K for each cut,
    the cuts (wide_cut) with the CPU comparison, and with ``parent`` the
    turns parent, this, this, parent in processes of their own."""
    from repro_torch.core import recall as rec

    dev = torch.device("cuda")
    vec_t = torch.from_numpy(idx.pv.vectors).to(dev)
    live = idx.pv.live.copy()
    qt = torch.from_numpy(q).to(dev)
    gt = {name: idx.slot_to_doc[rec.ground_truth(qt, vec_t, torch.from_numpy(m).to(dev), WIDE_K)]
          for name, m in (("search", live), ("qflat", masks["qflat"] & live),
                          ("brute", masks["brute"] & live))}
    del vec_t, qt
    out, counts = wide_cut(torch, np, K, idx, q, masks, gt, cpu)
    for name, r in out.items():
        check(r["cpu_ids_equal"] >= 0.99,
              f"wide {name}: card and CPU ids agree in only {r['cpu_ids_equal']:.4f} of slots")
    check(out["brute"]["recall"] >= 0.99, f"wide brute: recall {out['brute']['recall']} < 0.99")
    for form in ("topk_select.sort", "topk_select.radix"):
        check(counts[form] > 0, f"{form} did not launch in the wide cuts")
    turns = []
    if parent:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            state = Path(tmp) / "wide_state.npz"
            wide_state(state, idx, q, masks, gt)
            for tree in (Path(parent), ROOT, ROOT, Path(parent)):
                p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--wide-tree",
                                    str(tree), "--wide-state", str(state)],
                                   capture_output=True, text=True)
                check(p.returncode == 0, f"wide cuts on {tree}: {p.stdout[-2000:]} "
                                         f"{p.stderr[-2000:]}")
                turns.append(json.loads(p.stdout.strip().splitlines()[-1]))
                turns[-1]["tree"] = "parent" if tree != ROOT else "this"
                print("wide turn: " + json.dumps(turns[-1]), flush=True)
    return out, counts, turns


# ---------------------------------------------------------------------------
# phase 8: in-place deletes, pagination and a durable partition
# ---------------------------------------------------------------------------


def live_truth(torch, idx, queries, k: int):
    """Exact top-k documents over the index's live set, on the card."""
    import numpy as np

    from repro_torch.core import recall as rec

    dev = torch.device("cuda")
    vec_t = torch.from_numpy(idx.pv.vectors).to(dev)
    live_t = torch.from_numpy(idx.pv.live).to(dev)
    gt = np.concatenate([rec.ground_truth(torch.from_numpy(queries[i:i + 128]).to(dev), vec_t,
                                          live_t, k) for i in range(0, len(queries), 128)])
    return idx.slot_to_doc[gt]


def delete_phase(torch, np, K, idx, queries, recall_before: float) -> tuple[dict, dict]:
    """DELETES documents deleted in place, each its own timed call, in groups
    of DELETE_CALL; the consolidation sweep over every row; the medoid
    recomputed; 8 x 128 queries searched (no deleted document may come back;
    recall@10 over the live set); the first DELETE_CPU deletes again on the
    CPU from the same state, rows compared. Returns (results, launches of
    the deletes and the sweep)."""
    from repro_torch.core import DiskANNIndex
    from repro_torch.core import recall as rec

    snap = idx.snapshot()
    victims = np.random.RandomState(17).choice(idx.slot_to_doc[idx.pv.live], DELETES,
                                               replace=False)
    K.reset_launch_counts()
    secs, card_rows = [], None
    for i in range(0, DELETES, DELETE_CALL):
        for d in victims[i:i + DELETE_CALL]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            idx.delete([int(d)])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            if len(secs) == DELETE_CPU:
                card_rows = idx.pv.neighbors.copy()
    t = time.perf_counter()
    for _ in range(-(-idx.count // 1024)):
        idx.consolidate(1024)
    idx.recompute_medoid()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t
    counts = K.launch_counts()
    dead = ~idx.pv.live[: idx.count]
    nb = idx.pv.neighbors[: idx.count]
    check(not dead[nb[nb >= 0]].any(), "an edge to a dead node survived the sweep")

    found = np.concatenate([idx.search(queries[i:i + 128], k=10)[0]
                            for i in range(0, len(queries), 128)])
    check(not set(found.ravel().tolist()) & set(victims.tolist()),
          "a deleted document came back from search")
    recall = rec.recall_at_k(found, live_truth(torch, idx, queries, 10), 10)

    cpu = DiskANNIndex(idx.cfg, idx.dim, device="cpu")
    cpu.restore(snap)
    for d in victims[:DELETE_CPU]:
        cpu.delete([int(d)])
    before = snap["neighbors"]
    touched = (cpu.pv.neighbors != before).any(1) | (card_rows != before).any(1)
    same = float((cpu.pv.neighbors[touched] == card_rows[touched]).all(1).mean())
    ms = np.asarray(secs) * 1e3
    out = dict(deletes=DELETES, p50_ms=float(np.percentile(ms, 50)),
               p95_ms=float(np.percentile(ms, 95)), sweep_s=sweep_s,
               recall_at_10=recall, recall_at_10_before=recall_before, medoid=idx.medoid,
               cpu_deletes=DELETE_CPU, rows_touched=int(touched.sum()), cpu_rows_equal=same,
               launches_per_delete={k: v / DELETES for k, v in counts.items() if v})
    print("deletes: " + json.dumps(out), flush=True)
    check(recall >= RECALL_FLOOR_DEFAULTS, f"recall@10 after deletes {recall} < "
                                           f"{RECALL_FLOOR_DEFAULTS}")
    check(same >= 0.99, f"card and CPU rows agree in only {same:.4f} of those touched")
    return out, counts


def page_phase(torch, np, K, idx, queries, deleted: set) -> tuple[dict, dict]:
    """PAGE_QUERIES queries, PAGES pages of PAGE_K each (L and W of the
    index's config, reranked): pages disjoint and free of deleted documents;
    their union against the exact top PAGES * PAGE_K over the live set; host
    ms and rounds per page; PAGE_CPU_QUERIES queries again on the CPU from
    the same state."""
    from repro_torch.core import DiskANNIndex

    qs = queries[:PAGE_QUERIES]
    K.reset_launch_counts()
    page_ms, rounds, streams = [], [], []
    for q in qs:
        st = idx.start_pagination(q)
        seen = []
        for _ in range(PAGES):
            prev = st
            torch.cuda.synchronize()
            t = time.perf_counter()
            ids, dists, st = idx.next_page(q, st, PAGE_K)
            torch.cuda.synchronize()
            page_ms.append((time.perf_counter() - t) * 1e3)
            rounds.append(int(st.hops) - int(prev.hops))
            got = ids[ids >= 0]
            check(not set(got.tolist()) & set(np.concatenate(seen).tolist() if seen else []),
                  "a page repeated a result")
            check(not set(got.tolist()) & deleted, "a page returned a deleted document")
            seen.append(ids)
        streams.append(np.concatenate(seen))
    counts = K.launch_counts()
    gt = live_truth(torch, idx, qs, PAGES * PAGE_K)
    overlap = [len(set(s[s >= 0].tolist()) & set(g.tolist())) / (PAGES * PAGE_K)
               for s, g in zip(streams, gt)]
    cpu = DiskANNIndex(idx.cfg, idx.dim, device="cpu")
    cpu.restore(idx.snapshot())
    same = []
    for q, stream in zip(qs[:PAGE_CPU_QUERIES], streams):
        st = cpu.start_pagination(q)
        cpu_ids = []
        for _ in range(PAGES):
            ids, _, st = cpu.next_page(q, st, PAGE_K)
            cpu_ids.append(ids)
        same.append(np.concatenate(cpu_ids) == stream)
    same = float(np.mean(same))
    n_pages = PAGE_QUERIES * PAGES
    out = dict(queries=PAGE_QUERIES, pages=PAGES, k=PAGE_K, L=idx.cfg.L_search,
               W=idx.cfg.beam_width, overlap_mean=float(np.mean(overlap)),
               overlap_min=float(np.min(overlap)), host_ms_per_page_p50=float(np.median(page_ms)),
               host_ms_per_page_p95=float(np.percentile(page_ms, 95)),
               rounds_per_page_mean=float(np.mean(rounds)),
               rounds_first_page_mean=float(np.mean(rounds[::PAGES])), cpu_ids_equal=same,
               launches_per_page={k: v / n_pages for k, v in counts.items() if v})
    print("pages: " + json.dumps(out), flush=True)
    check(out["overlap_mean"] >= PAGE_OVERLAP_FLOOR,
          f"pages overlap the exact top {PAGES * PAGE_K} by {out['overlap_mean']:.3f} < "
          f"{PAGE_OVERLAP_FLOOR}")
    check(same >= 0.99, f"card and CPU page ids agree in only {same:.4f} of slots")
    return out, counts


def durable_phase(torch, np, K, idx_main, queries, inserts_per_s_main: float, seed: int
                  ) -> tuple[dict, dict]:
    """A partition on a StoreProviderSet (Bw-Tree terms, WAL, paged tier at a
    quarter of its pages) at phase 4's widths, built through ``insert`` from
    phase 4's first vectors, each mini-batch and each delete call an
    operation window: snapshot at DURABLE_SNAPSHOT_AT documents, the rest
    inserted, DURABLE_DELETES deleted, the sweep; then recovery into a fresh
    provider (recovery_invariants, the same ids for 128 queries) and from a
    WAL torn inside its last record."""
    from repro_torch.core import DiskANNIndex
    from repro_torch.store import StoreProviderSet
    from repro_torch.store import faults

    dim = idx_main.dim
    vecs = idx_main.pv.vectors[:DURABLE_N].copy()  # slot i holds document i
    cfg = idx_main.cfg._replace(capacity=DURABLE_N + 1024)

    def provider():
        return StoreProviderSet(cfg.capacity, cfg.R_slack, cfg.M, dim, device="cuda")

    pv = provider()
    pv.pages.set_budget(pv.pages.n_pages // 4)
    idx = DiskANNIndex(cfg, dim, providers=pv, seed=seed)

    def op(fn, *a) -> float:
        pv.begin_op()
        fn(*a)
        return pv.end_op()[0]

    insert_ru = []

    def build(lo: int, hi: int) -> None:
        for s in range(lo, hi, cfg.batch_size):
            e = min(s + cfg.batch_size, hi)
            insert_ru.append(op(idx.insert, list(range(s, e)), vecs[s:e]))

    K.reset_launch_counts()
    t0 = time.perf_counter()
    build(0, DURABLE_SNAPSHOT_AT)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t = time.perf_counter()
    snap = pv.snapshot_bytes()
    snapshot_s = time.perf_counter() - t
    n, cut = DURABLE_N, None
    rate = DURABLE_SNAPSHOT_AT / first_s
    while n > DURABLE_SNAPSHOT_AT and first_s + (n - DURABLE_SNAPSHOT_AT) / rate > DURABLE_BUDGET_S:
        n = max(n // 2, DURABLE_SNAPSHOT_AT)
    if n < DURABLE_N:
        cut = (f"N_durable cut to {n}: {DURABLE_N} was projected at "
               f"{first_s + (DURABLE_N - DURABLE_SNAPSHOT_AT) / rate:.0f} s > "
               f"{DURABLE_BUDGET_S:.0f} s")
    t = time.perf_counter()
    build(DURABLE_SNAPSHOT_AT, n)
    torch.cuda.synchronize()
    build_s = first_s + time.perf_counter() - t
    build_counts = K.launch_counts()
    victims = np.random.RandomState(seed + 1).choice(n, DURABLE_DELETES, replace=False)
    delete_ru = [op(idx.delete, victims[i:i + DELETE_CALL].tolist())
                 for i in range(0, DURABLE_DELETES, DELETE_CALL)]
    sweep_ru = op(lambda: [idx.consolidate(1024) for _ in range(-(-idx.count // 1024))])
    q = queries[:128]
    ids, dists, st = idx.search(q, k=10)
    counts = K.launch_counts()  # the build, the deletes, the sweep and one search batch
    check(not set(ids.ravel().tolist()) & set(victims.tolist()),
          "the durable index returned a deleted document")
    wal = pv.wal_bytes()
    fresh = provider()
    t = time.perf_counter()
    applied = fresh.recover(snap, wal)
    recover_s = time.perf_counter() - t
    check(applied == pv.committed, f"recovery applied {applied} of {pv.committed} records")
    invariants = faults.recovery_invariants(fresh, pv)
    rec = DiskANNIndex(cfg, dim, providers=fresh)
    for name in ("schemas", "count", "medoid", "doc_to_slot", "slot_to_doc", "_graph_built"):
        setattr(rec, name, getattr(idx, name))
    rec_ids = rec.search(q, k=10)[0]
    same = float((rec_ids == ids).mean())
    check(same == 1.0, f"the recovered index returned other ids ({same:.4f} equal)")
    torn = faults.torn_tail(wal, np.random.RandomState(seed))
    fresh = provider()
    applied_torn = fresh.recover(snap, torn)
    check(fresh.recovered_torn_tail, "a WAL torn inside its last record was not reported")
    check(applied_torn == pv.committed - 1,
          f"a torn tail applied {applied_torn}, not {pv.committed - 1}")
    out = dict(n=n, cut=cut, build_s=build_s, inserts_per_s=n / build_s,
               inserts_per_s_phase4=inserts_per_s_main, snapshot_s=snapshot_s,
               snapshot_bytes=len(snap), wal_bytes=len(wal), wal_records=pv.committed,
               ru_per_insert=float(np.sum(insert_ru)) / n,
               ru_per_delete=float(np.sum(delete_ru)) / DURABLE_DELETES, sweep_ru=sweep_ru,
               recover_s=recover_s, recovery_invariants=invariants, recovered_ids_equal=same,
               torn_tail_applied=applied_torn, budget_pages=pv.pages.budget_pages,
               n_pages=pv.pages.n_pages, tier_hits_per_query=st.tier_hits,
               tier_misses_per_query=st.tier_misses, pages_state=pv.pages.state(),
               launches_per_insert={k: v / n for k, v in build_counts.items() if v})
    print("durable: " + json.dumps(out), flush=True)
    return out, counts


def update_phase(torch, np, K, idx, queries, path: dict, seed: int) -> tuple[dict, dict]:
    """Phase 8: (a) deletes, (b) pages, (c) a durable partition; each part's
    launches counted from 0, and each form of UPDATE_FORMS launched there."""
    deletes, c_del = delete_phase(torch, np, K, idx, queries, path["recall_at_10"])
    deleted = set(np.setdiff1d(np.arange(path["n"]), idx.slot_to_doc[idx.pv.live]).tolist())
    pages, c_page = page_phase(torch, np, K, idx, queries, deleted)
    durable, c_dur = durable_phase(torch, np, K, idx, queries, path["inserts_per_s"], seed)
    counts = {}
    for part, c in (("delete", c_del), ("pages", c_page), ("durable", c_dur)):
        missing = [f for f in UPDATE_FORMS[part] if c[f] <= 0]
        check(not missing, f"phase 8 {part}: {missing} did not launch")
        counts[part] = c
    return dict(deletes=deletes, pages=pages, durable=durable), counts


# ---------------------------------------------------------------------------
# phase 9: a collection of partitions, its fan-outs, replicas and a split
# ---------------------------------------------------------------------------


def sync(torch, dev) -> None:
    """Wait for the card (phase 9 also rehearses on the CPU, where there is
    nothing to wait for)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()


def coll_doc(i: int) -> dict:
    """Document i of the collections: its properties cat and tier."""
    return {"id": i, "cat": i % 10, "tier": i % 3}


def grown(torch, dev, insert, step: int, n_max: int) -> tuple:
    """``insert(lo, hi)`` in calls of ``step`` documents: N_COLL_MIN first,
    then the rest unless the whole is projected past COLL_BUDGET_S (halving,
    to N_COLL_MIN at the least). Returns (n, seconds, cut, seconds of each
    call)."""
    call_s = []

    def build(lo: int, hi: int) -> None:
        for s in range(lo, hi, step):
            t = time.perf_counter()
            insert(s, min(s + step, hi))
            sync(torch, dev)
            call_s.append(time.perf_counter() - t)

    first = min(N_COLL_MIN, n_max)
    t0 = time.perf_counter()
    build(0, first)
    first_s = time.perf_counter() - t0
    n, cut, rate = n_max, None, first / first_s
    while n > first and first_s + (n - first) / rate > COLL_BUDGET_S:
        n = max(n // 2, first)
    if n < n_max:
        cut = (f"N_coll cut to {n}: {n_max} was projected at "
               f"{first_s + (n_max - first) / rate:.0f} s > {COLL_BUDGET_S:.0f} s")
    build(first, n)
    return n, time.perf_counter() - t0, cut, call_s


def collection_build(torch, dev, cfg, vecs, n_max: int, max_per: int, parts: int) -> tuple:
    """A Collection on the card built through ``insert`` in calls of parts x
    batch_size documents (document i: key pk{i % COLL_KEYS}, properties cat
    and tier), as ``grown`` sizes it. Returns (collection, n, seconds, cut,
    seconds of each call)."""
    from repro_torch.partition import Collection, CollectionConfig
    from repro_torch.serve.predicate import property_items

    col = Collection(CollectionConfig(dim=vecs.shape[1], graph=cfg,
                                      max_vectors_per_partition=max_per,
                                      initial_partitions=parts), device=dev)
    insert = lambda s, e: col.insert(
        list(range(s, e)), [f"pk{i % COLL_KEYS}" for i in range(s, e)], vecs[s:e],
        props=[property_items({"cat": i % 10, "tier": i % 3}) for i in range(s, e)])
    return (col,) + grown(torch, dev, insert, parts * cfg.batch_size, n_max)


def service_build(torch, dev, cfg, vecs, n_max: int, max_per: int, parts: int) -> tuple:
    """A VectorCollectionService on the card built through ``upsert`` (the
    engine's ingest queue, one chunk of parts x batch_size documents a call,
    so each reaches the collection's ``insert`` at collection_build's size):
    document i is coll_doc(i) under key pk{i % COLL_KEYS}. Returns (service,
    n, seconds, cut, seconds of each call)."""
    from repro_torch.serve import EngineConfig, VectorCollectionService

    step = parts * cfg.batch_size
    svc = VectorCollectionService(dim=vecs.shape[1], graph=cfg, max_vectors_per_partition=max_per,
                                  initial_partitions=parts, replicas=REPLICAS,
                                  engine_cfg=EngineConfig(ingest_chunk=step), device=dev)
    insert = lambda s, e: svc.upsert([coll_doc(i) for i in range(s, e)], vecs[s:e],
                                     partition_keys=[f"pk{i % COLL_KEYS}" for i in range(s, e)])
    return (svc,) + grown(torch, dev, insert, step, n_max)


def same_fanout(np, a, b) -> bool:
    """Two fan-out results equal bit for bit: ids, dists, RU, and each
    partition's stats but for the plan's name."""
    stat = lambda s: (s.hops, s.cmps, s.expansions, s.full_reads, s.tier_hits, s.tier_misses)
    return (np.array_equal(a[0], b[0]) and np.array_equal(a[1].view(np.int32), b[1].view(np.int32))
            and a[2]["ru_per_partition"] == b[2]["ru_per_partition"]
            and [stat(s) for s in a[2]["stats_per_partition"]]
            == [stat(s) for s in b[2]["stats_per_partition"]])


def shard_stack(torch, dev, parts) -> tuple:
    """distributed_search_fn's shard-stacked arguments from built partitions."""
    mats = [p.index.pv.materialize() for p in parts]
    return tuple(torch.stack([m[i] for m in mats]) for i in range(5)) + (
        torch.stack([torch.from_numpy(p.index.slot_to_doc).to(dev) for p in parts]),
        torch.tensor([p.index.medoid for p in parts], dtype=torch.int32, device=dev),
        torch.stack([p.index.schemas[0].codebooks for p in parts]))


def per_shard(torch, args, q, L: int, k: int, W: int):
    """distributed_search_fn's work one shard at a time on the card: search
    with the shard's version-0 tables, rerank the beam's first 2k, and one
    topk_select merge over the shards' partial results."""
    from repro_torch.core import flat as fmod
    from repro_torch.core import pq as pqmod
    from repro_torch.core import search as smod
    from repro_torch.kernels.topk_select.ops import topk_select

    nb, codes, versions, live, vectors, docs, medoid, books = args
    out_i, out_d = [], []
    for s in range(nb.shape[0]):
        luts = pqmod.adc_lut(pqmod.PQSchema(books[s], 0), q)[:, None].contiguous()
        res = smod.batch_greedy_search(nb[s], codes[s], versions[s], live[s], luts,
                                       int(medoid[s]), L=L, beam_width=W)
        ids, d = fmod.rerank(q, res.beam_ids[:, :2 * k], vectors[s], k=k)
        out_i.append(torch.where(ids >= 0, docs[s][ids.long().clamp(min=0)], -1))
        out_d.append(torch.where(ids >= 0, d, float("inf")))
    vals, pos = topk_select(torch.cat(out_d, 1).contiguous(), k)
    return torch.cat(out_i, 1).gather(1, pos.long()), vals


def collection_phase(torch, np, K, dev, idx_main, queries, seed: int,
                     prof_dir: Path | None = None) -> tuple[dict, dict, object]:
    """Phase 9. A Collection of COLL_PARTS partitions on StoreProviderSets
    at phase 4's widths, built from phase 4's first N_COLL vectors through a
    VectorCollectionService's ``upsert`` (returned for phase 10); 8 batches
    of 128 through the serial fan-out and the stacked one in turns (equal
    bit for bit); distributed_search_fn over the shard-stacked partitions;
    the filtered fan-out (a qflat and a beta predicate); the paged fan-out;
    a replica set on partition 0 (quorum insert, failover, hedged fan-out,
    a rebuild through probe_dead); a 1-partition collection split by its
    inserts. The launches of all of it are counted from 0, and every form of
    PARTITION_FORMS must launch; then recall against exact ground truth,
    distributed_search_fn against its per-shard composition, and the card
    against the CPU. With ``prof_dir``, one serial and one stacked batch
    are profiled after the launch check (profile_runs)."""
    from repro_torch.core import DiskANNIndex
    from repro_torch.core import recall as rec
    from repro_torch.core import search as smod
    from repro_torch.partition import (ReplicaSet, SpmdFanout, distributed_search_fn,
                                       fanout_search, paged_fanout_search, start_paged_fanout)
    from repro_torch.partition.fanout import (batched_fanout_search,
                                              batched_filtered_fanout_search, merge_topk)
    from repro_torch.serve.predicate import F, property_items
    from repro_torch.store import faults

    vecs = idx_main.pv.vectors[:N_COLL + REPLICA_INSERTS].copy()  # slot i holds document i
    cfg = idx_main.cfg._replace(capacity=COLL_CAPACITY)
    L, W, k = cfg.L_search, cfg.beam_width, 10
    K.reset_launch_counts()
    svc, n, build_s, cut, call_s = service_build(torch, dev, cfg, vecs, N_COLL, COLL_MAX_PER,
                                                 COLL_PARTS)
    col = svc.collection
    parts = col.partitions
    check(col.splits == 0 and len(parts) == COLL_PARTS, "a split fired during the build")
    sizes = [p.num_docs for p in parts]
    print(f"collection: {n} documents in {build_s:.1f} s = {n / build_s:.1f} inserts/s, "
          f"partitions {sizes}" + (f"; {cut}" if cut else ""), flush=True)

    # serial and stacked fan-out, in turns; the stacked call's first apart
    batches = [queries[i * 128:(i + 1) * 128] for i in range(COLL_BATCHES)]
    spmd = SpmdFanout(device=dev)
    t = time.perf_counter()
    spmd.search(parts, batches[0], k)
    sync(torch, dev)
    stacked_first_s = time.perf_counter() - t
    ser_s, stk_s, ser_runs, lat_model = [], [], [], []
    ser_launch = {f: 0 for f in K.launch_counts()}
    stk_launch = dict(ser_launch)
    for qb in batches:
        for runs, secs, launches, fn in (
                (ser_runs, ser_s, ser_launch,
                 lambda: batched_fanout_search(parts, qb, k, batch_buckets=smod.BATCH_BUCKETS)),
                (None, stk_s, stk_launch, lambda: spmd.search(parts, qb, k))):
            c0 = K.launch_counts()
            sync(torch, dev)
            t = time.perf_counter()
            res = fn()
            sync(torch, dev)
            secs.append(time.perf_counter() - t)
            for f, v in K.launch_counts().items():
                launches[f] += v - c0[f]
            if runs is not None:
                runs.append(res)
            else:
                check(same_fanout(np, res, ser_runs[-1]),
                      "the stacked fan-out differs from the serial one")
                check(res[2]["spmd"]["partitions_in_program"] == COLL_PARTS,
                      "a partition left the stacked call")
        lat_model.append(ser_runs[-1][2]["service_latency_ms"])
    ser_ms, stk_ms = np.asarray(ser_s) * 1e3, np.asarray(stk_s) * 1e3
    ru_batch = [r[2]["ru_total"] for r in ser_runs]

    # the card against the CPU: each partition's index restored on the CPU
    snaps = [p.index.snapshot() for p in parts]
    qc = batches[0][:COLL_CPU_QUERIES]
    cpu_l, cpu_d = [], []
    for snap in snaps:
        cpu = DiskANNIndex(cfg, vecs.shape[1], device="cpu")
        cpu.restore(snap)
        ids, dists, _ = cpu.search(qc, k)
        cpu_l.append(ids)
        cpu_d.append(dists)
    cpu_ids, _ = merge_topk(cpu_l, cpu_d, k)
    del snaps, cpu
    cpu_same = float((cpu_ids == ser_runs[0][0][:COLL_CPU_QUERIES]).mean())

    # distributed_search_fn over the shard-stacked partitions
    shards = shard_stack(torch, dev, parts)
    dfn = distributed_search_fn(L=L, k=k, beam_width=W, device=dev)
    q0 = torch.from_numpy(batches[0]).to(dev)
    dist_s = []
    for _ in range(3):
        sync(torch, dev)
        t = time.perf_counter()
        d_ids, d_d = dfn(*shards, q0)
        sync(torch, dev)
        dist_s.append(time.perf_counter() - t)

    # the filtered fan-out: ~10 % (Q-Flat) and ~60 % (beta) of each partition
    preds = {"eq_cat_3": (3,), "in_cat_6": (0, 1, 2, 4, 5, 6)}  # the cat values each matches
    filt, filt_ids = {}, {}
    for name, cats in preds.items():
        pred = F.eq("cat", cats[0]) if len(cats) == 1 else F.in_("cat", list(cats))
        secs = []
        for _ in range(1 + COLL_FILTER_REPEATS):
            t = time.perf_counter()
            ids, dists, info = batched_filtered_fanout_search(parts, batches[0], k, pred)
            sync(torch, dev)
            secs.append(time.perf_counter() - t)
        filt[name] = dict(plan=info["plan"], first_ms=secs[0] * 1e3,
                          ms=float(np.median(secs[1:])) * 1e3, ru=info["ru_total"])
        filt_ids[name] = ids
        check(info["complete"] and ids.shape == (128, k), f"filtered fan-out {name}")

    # the paged fan-out: 5 pages of 10 for COLL_PAGE_QUERIES queries
    page_ms, page_fetches, page_ru, streams = [], [], [], []
    for qi in batches[0][:COLL_PAGE_QUERIES]:
        st = start_paged_fanout(parts, qi)
        seen, hwm = [], -np.inf
        for _ in range(PAGES):
            sync(torch, dev)
            t = time.perf_counter()
            ids, dists, info = paged_fanout_search(parts, qi, st, PAGE_K)
            sync(torch, dev)
            page_ms.append((time.perf_counter() - t) * 1e3)
            page_fetches.append(info["pages_fetched"])
            page_ru.append(info["ru_total"])
            got = ids[ids >= 0]
            check(not set(got.tolist()) & set(seen), "a merged page repeated a result")
            check(info["emit_hwm"] >= hwm, "the emitted high-water mark went down")
            hwm = info["emit_hwm"]
            seen += got.tolist()
        streams.append(seen)

    # a replica set on partition 0: quorum insert, failover, hedged fan-out,
    # a dead secondary rebuilt through probe_dead
    p0 = parts[0]
    sets = [ReplicaSet(p, num_replicas=REPLICAS) for p in parts]
    rs = sets[0]
    new = list(range(N_COLL, N_COLL + REPLICA_INSERTS))
    t = time.perf_counter()
    rs.insert(new, [p0.lo] * len(new), vecs[new],
              props=[property_items({"cat": i % 10, "tier": i % 3}) for i in new])
    sync(torch, dev)
    quorum_insert_s = time.perf_counter() - t
    old_primary = rs.primary
    rs.kill(old_primary, now_s=1e9)  # killed last: not yet due for a re-probe
    check(rs.failovers == 1 and rs.primary != old_primary and rs.replicas[rs.primary].alive,
          "killing the primary did not fail over")
    slow = lambda p, rr: float(np.exp(rr.normal(np.log(20.0), 0.8)))
    _, _, hedged = fanout_search(sets, batches[-1], k, latency_model=slow, hedge_at_ms=40.0,
                                 rng=np.random.RandomState(seed))
    victim = next(r.rid for r in rs.replicas if r.alive and r.rid != rs.primary)
    rs.kill(victim, now_s=0.0)
    rebuilt = []
    rebuild = rs.rebuild
    rs.rebuild = lambda rid, capture=None: rebuilt.append(rebuild(rid, capture)) or rebuilt[-1]
    t = time.perf_counter()
    revived = rs.probe_dead(now_s=rs.reprobe_after_s)
    sync(torch, dev)
    rebuild_s = time.perf_counter() - t
    check(revived == [victim] and rs.replicas[victim].alive, f"probe_dead revived {revived}")
    check(rebuilt[0].committed == p0.providers.committed,
          f"the rebuild applied {rebuilt[0].committed} of {p0.providers.committed} records")
    invariants = faults.recovery_invariants(rebuilt[0], p0.providers)
    check(rebuilt[0].device == p0.device, "the rebuilt replica is on another device")
    del rebuilt

    # a split: a 1-partition collection past its limit
    t = time.perf_counter()
    scol, _, split_build_s, _, split_calls = collection_build(
        torch, dev, cfg._replace(capacity=SPLIT_MAX + 1024), vecs, SPLIT_N, SPLIT_MAX, 1)
    check(scol.splits == 1 and len(scol.partitions) == 2, f"{scol.splits} splits, not 1")
    mid = 1 << 31
    check([(p.lo, p.hi) for p in scol.partitions] == [(0, mid), (mid, 1 << 32)],
          "the split's children do not halve the range")
    held = sorted(d for p in scol.partitions for d in p.index.slot_to_doc[p.providers.live])
    check(held == list(range(SPLIT_N)) and scol.num_docs == SPLIT_N,
          "the split lost or duplicated a document")
    split_ids, _, _ = fanout_search(scol.partitions, batches[-1], k)
    counts = K.launch_counts()  # phase 9's path ends here
    missing = [f for f in PARTITION_FORMS if counts[f] <= 0]
    check(not missing, f"phase 9: {missing} did not launch")
    if prof_dir is not None:
        spmd.search(parts, batches[0], k)  # restack after the replica's inserts, unprofiled
    prof = None if prof_dir is None else profile_runs(torch, {
        "fanout_serial": [lambda: batched_fanout_search(parts, batches[0], k,
                                                        batch_buckets=smod.BATCH_BUCKETS)] * 2,
        "fanout_stacked": [lambda: spmd.search(parts, batches[0], k)] * 2}, prof_dir)

    # checks against exact ground truth, on the card
    vec_t = torch.from_numpy(vecs[:n]).to(dev)
    live_t = torch.ones(n, dtype=torch.bool, device=dev)
    gt = lambda qb, live, kk: rec.ground_truth(torch.from_numpy(qb).to(dev), vec_t, live, kk)
    gts = np.concatenate([gt(qb, live_t, k) for qb in batches])
    recall = rec.recall_at_k(np.concatenate([r[0] for r in ser_runs]), gts, k)
    recall_dist = rec.recall_at_k(d_ids.cpu().numpy(), gts[:128], k)
    want_i, want_d = per_shard(torch, shards, q0, L, k, W)
    dist_same = bool(torch.equal(d_ids, want_i) and torch.equal(d_d.view(torch.int32),
                                                                   want_d.view(torch.int32)))
    cat = np.arange(n) % 10
    for name, cats in preds.items():
        fm = torch.from_numpy(np.isin(cat, cats)).to(dev)
        filt[name]["recall_at_10"] = rec.recall_at_k(filt_ids[name], gt(batches[0], fm, k), k)
    gt50 = gt(batches[0][:COLL_PAGE_QUERIES], live_t, PAGES * PAGE_K)
    overlap = [len(set(s) & set(g.tolist())) / (PAGES * PAGE_K) for s, g in zip(streams, gt50)]
    svec = torch.from_numpy(vecs[:SPLIT_N]).to(dev)
    split_gt = rec.ground_truth(torch.from_numpy(batches[-1]).to(dev), svec,
                                torch.ones(SPLIT_N, dtype=torch.bool, device=dev), k)
    split_recall = rec.recall_at_k(split_ids, split_gt, k)

    per_batch = lambda c: {f: v / COLL_BATCHES for f, v in c.items() if v}
    out = dict(
        n=n, cut=cut, partitions=sizes, build_s=build_s, inserts_per_s=n / build_s,
        insert_call_ms_p50=float(np.median(call_s)) * 1e3,
        serial=dict(p50_ms=float(np.percentile(ser_ms, 50)),
                    p95_ms=float(np.percentile(ser_ms, 95)),
                    qps=COLL_BATCHES * 128 / float(np.sum(ser_s)),
                    ru_per_batch=float(np.mean(ru_batch)),
                    service_latency_ms=float(np.mean(lat_model)),
                    launches_per_batch=per_batch(ser_launch)),
        stacked=dict(first_ms=stacked_first_s * 1e3, p50_ms=float(np.percentile(stk_ms, 50)),
                     p95_ms=float(np.percentile(stk_ms, 95)),
                     qps=COLL_BATCHES * 128 / float(np.sum(stk_s)),
                     serial_over_stacked_p50=float(np.percentile(ser_ms, 50)
                                                   / np.percentile(stk_ms, 50)),
                     equal_to_serial=True, launches_per_batch=per_batch(stk_launch)),
        recall_at_10=recall, cpu_ids_equal=cpu_same, cpu_queries=COLL_CPU_QUERIES,
        distributed=dict(recall_at_10=recall_dist, first_ms=dist_s[0] * 1e3,
                         ms=float(np.median(dist_s[1:])) * 1e3, equal_to_per_shard=dist_same),
        filtered=filt,
        paged=dict(queries=COLL_PAGE_QUERIES, pages=PAGES, k=PAGE_K,
                   ms_p50=float(np.percentile(page_ms, 50)),
                   ms_p95=float(np.percentile(page_ms, 95)),
                   first_page_ms_mean=float(np.mean(page_ms[::PAGES])),
                   fetches_per_page=float(np.mean(page_fetches)),
                   ru_per_page=float(np.mean(page_ru)),
                   overlap_mean=float(np.mean(overlap)), overlap_min=float(np.min(overlap))),
        replicas=dict(replicas=REPLICAS, quorum_insert_ms=quorum_insert_s * 1e3,
                      failovers=rs.failovers, hedges=hedged["hedges"],
                      hedge_ru=hedged["hedge_ru"], ru_total=hedged["ru_total"],
                      client_latency_ms=hedged["client_latency_ms"], rebuild_s=rebuild_s,
                      wal_records=p0.providers.committed, recovery_invariants=invariants),
        split=dict(n=SPLIT_N, max_per=SPLIT_MAX, build_s=split_build_s,
                   split_call_s=float(max(split_calls)), recall_at_10=split_recall,
                   partitions=[p.num_docs for p in scol.partitions]),
        launches=counts, profile=prof,
    )
    print("collection: " + json.dumps(out), flush=True)
    check(svc.collection.partitions == parts and len(svc.docs) == n,
          "the service's collection is not the one phase 9 ran on")
    check(recall >= RECALL_FLOOR_DEFAULTS, f"fan-out recall@10 {recall} < {RECALL_FLOOR_DEFAULTS}")
    check(dist_same, "distributed_search_fn differs from its per-shard composition")
    check(out["paged"]["overlap_mean"] >= PAGE_OVERLAP_FLOOR,
          f"merged pages overlap the exact top {PAGES * PAGE_K} by "
          f"{out['paged']['overlap_mean']:.3f} < {PAGE_OVERLAP_FLOOR}")
    check(split_recall >= SPLIT_RECALL_FLOOR,
          f"recall@10 after the split {split_recall} < {SPLIT_RECALL_FLOOR}")
    check(cpu_same >= 0.99, f"card and CPU fan-out ids agree in only {cpu_same:.4f} of slots")
    return out, counts, svc


def collection_truth(torch, np, dev, parts, qs, k: int) -> np.ndarray:
    """Exact top-k document ids of qs over every live document of parts."""
    from repro_torch.core import recall as rec

    docs = np.concatenate([p.index.slot_to_doc[p.providers.live] for p in parts])
    vec = torch.from_numpy(np.concatenate([p.providers.vectors[p.providers.live]
                                           for p in parts])).to(dev)
    live = torch.ones(len(docs), dtype=torch.bool, device=dev)
    out = np.concatenate([docs[rec.ground_truth(torch.from_numpy(qs[i:i + 128]).to(dev), vec,
                                                live, k)] for i in range(0, len(qs), 128)])
    del vec
    return out


def service_state(svc) -> dict:
    """The plain state of a service's collection (each partition's bounds, its
    index ``snapshot()``, its store's bytes, doc_pk, doc_props), the form
    ``VectorCollectionService.from_reference_state`` takes. Checkpointing the
    store clears its WAL: the snapshot holds everything."""
    col = svc.collection
    return dict(next_pid=col._next_pid, splits=col.splits, merges=col.merges, partitions=[
        dict(lo=p.lo, hi=p.hi, pid=p.pid, index=p.index.snapshot(),
             snapshot=p.providers.snapshot_bytes(), wal=p.providers.wal_bytes(),
             doc_pk=dict(p.doc_pk), doc_props=dict(p.doc_props)) for p in col.partitions])


def wall_stats(np, ms: list) -> dict:
    return dict(n=len(ms), p50_ms=float(np.percentile(ms, 50)),
                p95_ms=float(np.percentile(ms, 95)), mean_ms=float(np.mean(ms)))


def serve_phase(torch, np, K, dev, svc, queries, draw, seed: int, plans: dict,
                prof_dir: Path | None = None) -> tuple[dict, dict]:
    """Phase 10. Phase 9's service on the card: micro-batched queries in the
    serial and stacked dispatch modes in turns (equal bit for bit), a pass at
    max_batch 64, single requests, the exact plan, the filtered plans, paged
    queries with their tokens through bytes, throttling, a deadline and a
    degraded fan-out, interleaved ingest, then 16 requests again on the CPU.
    Every wall time is the host clock with the card synced; the engine's own
    latencies are SimClock models and are not reported as card times. The
    launches are counted from 0, and every form of SERVE_FORMS must launch."""
    from repro_torch.core import search as smod
    from repro_torch.partition.fanout import batched_fanout_search
    from repro_torch.serve import (DeadlineExceeded, EngineConfig, F, Throttled,
                                   VectorCollectionService, VectorQuery, VectorServeEngine,
                                   decode_continuation, encode_continuation, poisson_arrivals)
    from repro_torch.serve.vector_engine import serving_jit_cache_size

    parts = svc.collection.partitions
    k = 10
    t_phase = time.perf_counter()
    K.reset_launch_counts()

    def engine(mode: str, max_batch: int = SERVE_BATCH, on=svc):
        # admission off: these passes measure what the card serves, not governance
        return VectorServeEngine(on.collection, cfg=EngineConfig(
            max_batch=max_batch, dispatch_mode=mode, admission_control=False),
            resolver=on._partitions_for, replica_sets=on.replica_sets)

    def instrument(eng, log: list) -> None:
        """Each dispatched micro-batch: (size, bucket, wall ms, signatures it
        added to serving_jit_cache_size)."""
        inner = eng._dispatch_chunk

        def timed_chunk(key, batch):
            sync(torch, dev)
            sigs = serving_jit_cache_size()
            t = time.perf_counter()
            inner(key, batch)
            sync(torch, dev)
            log.append((len(batch), smod.next_bucket(len(batch)),
                        (time.perf_counter() - t) * 1e3, serving_jit_cache_size() - sigs))
        eng._dispatch_chunk = timed_chunk

    def served(eng, qs, turn: int, **kw) -> tuple[list, float]:
        """qs submitted at once, stamped with seeded Poisson arrivals far above
        what the card serves (so micro-batches form from a backlog, alike in
        every mode), then drained. Returns (responses, wall seconds)."""
        arr = eng.clock.now() + poisson_arrivals(np.random.RandomState(seed + turn), len(qs),
                                                 SERVE_RATE_QPS)
        sync(torch, dev)
        t = time.perf_counter()
        rids = [eng.submit_query(qi, k=k, arrival_s=float(a), **kw) for qi, a in zip(qs, arr)]
        eng.drain()
        sync(torch, dev)
        secs = time.perf_counter() - t
        return [eng.pop_response(r) for r in rids], secs

    def same(a, b) -> bool:
        return (np.array_equal(a.ids, b.ids) and np.array_equal(a.dists.view(np.int32),
                                                                 b.dists.view(np.int32))
                and (a.status, a.ru, a.latency_ms, a.batch_size, a.complete)
                == (b.status, b.ru, b.latency_ms, b.batch_size, b.complete)
                and a.plan == b.plan.removesuffix("-spmd"))

    # -- micro-batched queries: serial and stacked in turns ----------------
    modes = ("serial", "spmd")
    engines = {m: engine(m) for m in modes}
    logs = {m: [] for m in modes}
    for m in modes:
        instrument(engines[m], logs[m])
    resp = {m: [] for m in modes}
    secs = {m: 0.0 for m in modes}
    launches = {m: {f: 0 for f in K.launch_counts()} for m in modes}
    n_micro, cut, turn = SERVE_QUERIES, None, 0
    while turn * SERVE_TURN < n_micro:
        qs = queries[turn * SERVE_TURN:(turn + 1) * SERVE_TURN]
        for m in modes:
            c0 = K.launch_counts()
            r, s_ = served(engines[m], qs, turn)
            resp[m] += r
            secs[m] += s_
            for f, v in K.launch_counts().items():
                launches[m][f] += v - c0[f]
        turn += 1
        if turn == 1:
            turn_s = secs["serial"] + secs["spmd"]
            while n_micro > SERVE_QUERIES_MIN and turn_s * n_micro / SERVE_TURN > SERVE_BUDGET_S / 2:
                n_micro //= 2
            if n_micro < SERVE_QUERIES:
                cut = (f"micro-batched queries cut to {n_micro}: {SERVE_QUERIES} were projected at "
                       f"{turn_s * SERVE_QUERIES / SERVE_TURN:.0f} s > {SERVE_BUDGET_S / 2:.0f} s")
    qm = queries[:n_micro]
    check(all(r.status == 200 for m in modes for r in resp[m]), "a micro-batched query failed")
    check(all(same(a, b) for a, b in zip(resp["serial"], resp["spmd"])),
          "the stacked mode's responses differ from the serial mode's")
    check({r.plan for r in resp["spmd"]} == {"graph-spmd"}, "a stacked batch left the program")
    # one bucket of the engine against the fan-out it calls
    L = max(k, int(round(EngineConfig().search_list_multiplier * k)))
    direct, _, _ = batched_fanout_search(parts, qm[:SERVE_BATCH], k, L=L,
                                         batch_buckets=smod.BATCH_BUCKETS,
                                         beam_width=EngineConfig().beam_width)
    check(np.array_equal(np.stack([r.ids for r in resp["serial"][:SERVE_BATCH]]), direct),
          "the engine's ids differ from a direct batched_fanout_search of the bucket")
    # signatures: none new after the first micro-batch of each (mode, bucket)
    late = [(m, bucket) for m in modes for i, (_, bucket, _, added) in enumerate(logs[m])
            if added and bucket in {b for _, b, _, _ in logs[m][:i]}]
    check(not late, f"micro-batches minted a signature after their bucket's first: {late}")
    micro = {}
    for m in modes:
        ms = [w for _, _, w, _ in logs[m]]
        by_bucket = {}
        for size, bucket, w, _ in logs[m]:
            by_bucket.setdefault(bucket, []).append(w)
        micro[m] = dict(queries=n_micro, qps=n_micro / secs[m], seconds=secs[m],
                        batches=len(ms), **wall_stats(np, ms),
                        first_ms=ms[0], by_bucket={b: wall_stats(np, w)
                                                   for b, w in sorted(by_bucket.items())},
                        launches_per_query={f: v / n_micro for f, v in launches[m].items() if v})

    # -- one pass at max_batch 64 in each mode ------------------------------
    wide = {}
    wide_resp = {}
    for m in modes:
        log = []
        eng = engine(m, SERVE_WIDE_BATCH)
        instrument(eng, log)
        served(eng, qm[:SERVE_WIDE_BATCH], 90)  # the bucket's signature first
        log.clear()
        r, s_ = served(eng, qm[:SERVE_WIDE], 91)
        wide_resp[m] = r
        wide[m] = dict(queries=len(r), qps=len(r) / s_, batches=len(log),
                       **wall_stats(np, [w for _, _, w, _ in log]))
    check(all(same(a, b) for a, b in zip(wide_resp["serial"], wide_resp["spmd"])),
          "at max_batch 64 the stacked mode's responses differ from the serial mode's")

    # -- single requests (bucket 1), through the service's own engine -------
    gov = svc.engine
    gov.set_tenant_budget("load", 1e12)  # a tenant whose budget these requests never reach
    single_ms = []
    for qi in qm[:SERVE_SINGLE]:
        sync(torch, dev)
        t = time.perf_counter()
        res = svc.query(VectorQuery(vector=qi, k=k, tenant="load"))
        sync(torch, dev)
        single_ms.append((time.perf_counter() - t) * 1e3)
        check(res.plan == "graph" and res.complete and res.ids.shape == (k,), "svc.query")

    # -- the exact plan: one micro-batch of 16 on the partitions' mirrors ---
    mirrors = lambda: [p.providers.materialize(p.index.ctx)[4].data_ptr() for p in parts]
    ptrs = mirrors()
    c0 = K.launch_counts()
    ex_eng = engine("serial")
    served(ex_eng, qm[:SERVE_EXACT], 92, exact=True)  # warm
    exact_r, exact_s = served(ex_eng, qm[:SERVE_EXACT], 93, exact=True)
    exact_launch = {f: v - c0[f] for f, v in K.launch_counts().items()}
    check(mirrors() == ptrs, "the exact plan replaced a partition's device mirror")
    check({r.plan for r in exact_r} == {"exact"} and exact_r[0].batch_size == SERVE_EXACT,
          "the exact queries did not run as one exact micro-batch")
    check(exact_launch["flat_l2.dense"] > 0 and exact_launch["topk_select.long"] > 0,
          f"the exact plan did not launch flat_l2.dense and topk_select.long: {exact_launch}")

    # -- filtered: Q-Flat and beta predicates, one request each call --------
    filt = {}
    for name, pred in (("eq_cat_3", F.eq("cat", 3)), ("in_cat_6", F.in_("cat", [0, 1, 2, 4, 5, 6]))):
        times = []
        for _ in range(1 + COLL_FILTER_REPEATS):
            sync(torch, dev)
            t = time.perf_counter()
            res = svc.query(VectorQuery(vector=qm[0], k=k, filter=pred, tenant="load"))
            sync(torch, dev)
            times.append((time.perf_counter() - t) * 1e3)
        check(res.plan == plans[name], f"filtered {name}: plan {res.plan}, phase 9 ran "
                                       f"{plans[name]}")
        cats = [coll_doc(int(d))["cat"] for d in res.ids if d >= 0]
        check(bool(cats) and all(pred.matches({"cat": c}) for c in cats),
              f"filtered {name} returned a non-matching document")
        filt[name] = dict(plan=res.plan, first_ms=times[0], ms=float(np.median(times[1:])))

    # -- paged: tokens through bytes, decoded onto the card -----------------
    page_ms, streams, tokens = [], [], []
    for qi in qm[:COLL_PAGE_QUERIES]:
        tok, seen = None, []
        for _ in range(PAGES):
            sync(torch, dev)
            t = time.perf_counter()
            res = svc.query_page(VectorQuery(vector=qi, tenant="load"), continuation=tok,
                                 page_size=PAGE_K)
            sync(torch, dev)
            page_ms.append((time.perf_counter() - t) * 1e3)
            check(res.continuation is not None, "pagination ended before 5 pages")
            tok = bytes(res.continuation)
            tokens.append(tok)
            got = res.ids[res.ids >= 0].tolist()
            check(not set(got) & set(seen), "a page repeated a result")
            seen += got
        streams.append(seen)
    st = decode_continuation(tokens[-1], device=dev)
    again = encode_continuation(st)
    st2 = decode_continuation(again, device=dev)
    check(again == tokens[-1], "a decoded token does not encode to its own bytes")
    for c1, c2 in zip(st.cursors, st2.cursors):
        check((c1.pid, c1.exhausted, c1.fetch_hwm) == (c2.pid, c2.exhausted, c2.fetch_hwm)
              and np.array_equal(c1.buf_ids, c2.buf_ids)
              and np.array_equal(c1.buf_dists, c2.buf_dists), "a cursor differs after decoding")
        if c1.state is not None:
            for f1, f2 in zip(c1.state, c2.state):
                check(f1.device.type == dev.type and torch.equal(f1, f2),
                      "a decoded search state differs, or is not on the card")

    # -- governance and faults ----------------------------------------------
    gov.set_tenant_budget("poor", 0.5 * gov.cfg.admission_estimate_ru)
    throttled = deadline = False
    try:
        svc.query(VectorQuery(vector=qm[0], k=k, tenant="poor"))
    except Throttled:
        throttled = True
    try:
        svc.query(VectorQuery(vector=qm[0], k=k, deadline_ms=0.0))
    except DeadlineExceeded:
        deadline = True
    victim = svc.replica_sets[1]
    for rep in victim.replicas:
        rep.alive = False
    try:
        degraded = svc.query(VectorQuery(vector=qm[0], k=k))
    finally:
        for rep in victim.replicas:
            rep.alive = True
    pid = parts[1].pid
    check(throttled, "a tenant below one query's estimate was not throttled")
    check(deadline, "deadline_ms=0.0 did not raise DeadlineExceeded")
    check(not degraded.complete and degraded.plan == f"graph+degraded[{pid}]",
          f"a partition with every replica down gave {degraded.plan}, complete "
          f"{degraded.complete}")
    gsnap = gov.snapshot()
    governance = dict(throttled=gsnap["queries_throttled"], deadline=gsnap["queries_deadline"],
                      degraded=gsnap["queries_degraded"])

    # -- exact ground truth of what was served so far, on the card ---------
    truth = collection_truth(torch, np, dev, parts, qm, k)
    recall = rec_at(np, resp["serial"], truth, k)
    exact_same = all(set(r.ids.tolist()) == set(t.tolist())
                     for r, t in zip(exact_r, truth[:SERVE_EXACT]))
    gt50 = collection_truth(torch, np, dev, parts, qm[:COLL_PAGE_QUERIES], PAGES * PAGE_K)
    overlap = [len(set(s) & set(g.tolist())) / (PAGES * PAGE_K) for s, g in zip(streams, gt50)]

    # -- interleaved ingest: upsert_async while queries flow ----------------
    qi_ = qm[:min(SERVE_INGEST_QUERIES, n_micro)]
    recall_before = rec_at(np, resp["serial"][:len(qi_)], truth[:len(qi_)], k)
    new_ids = list(range(SERVE_NEW_BASE, SERVE_NEW_BASE + SERVE_INGEST))
    new_vecs = draw(SERVE_INGEST).cpu().numpy()
    ingest_s = []
    apply = svc._apply_upsert

    def timed_apply(*a):
        sync(torch, dev)
        t = time.perf_counter()
        ru = apply(*a)
        sync(torch, dev)
        ingest_s.append(time.perf_counter() - t)
        return ru

    svc._apply_upsert = timed_apply
    c0 = K.launch_counts()
    tally = svc.upsert_async([coll_doc(i) for i in new_ids], new_vecs,
                             partition_keys=[f"pk{i % COLL_KEYS}" for i in new_ids])
    during, during_s = served(gov, qi_, 94, tenant="load")
    del svc._apply_upsert
    check(gov.ingest_backlog == 0 and gov.metrics.ingest_ops >= SERVE_INGEST and tally.value > 0,
          "the ingest queue did not drain")
    check(all(r.status == 200 for r in during), "a query failed while ingest interleaved")
    check(K.launch_counts()["pq_encode"] > c0["pq_encode"], "ingest did not launch pq_encode")
    after, _ = served(engine("serial"), qi_, 95)
    recall_after = rec_at(np, after, collection_truth(torch, np, dev, parts, qi_, k), k)
    ingest = dict(docs=SERVE_INGEST, queries=len(qi_), inserts_per_s=SERVE_INGEST / sum(ingest_s),
                  chunks=len(ingest_s), wall_s=during_s, recall_before=recall_before,
                  recall_after=recall_after)
    counts = K.launch_counts()  # phase 10's path on the card ends here

    if prof_dir is not None:
        pe = {m: engine(m) for m in modes}
        prof = profile_runs(torch, {f"serve_{m}_16": [lambda m=m: served(pe[m], qm[:SERVE_BATCH],
                                                                         96)] * 2
                                    for m in modes}, prof_dir)
    else:
        prof = None

    # -- 16 requests again on the CPU, the collection carried across --------
    t = time.perf_counter()
    cpu_svc = VectorCollectionService.from_reference_state(
        service_state(svc), svc.docs, svc.cfg, device="cpu",
        engine_cfg=EngineConfig(admission_control=False))
    carry_s = time.perf_counter() - t
    qc = qm[:SERVE_CPU_REQUESTS]
    card_r, _ = served(engine("serial"), qc, 97)
    cpu_r, _ = served(engine("serial", on=cpu_svc), qc, 97)
    cpu_same = float((np.stack([r.ids for r in card_r]) == np.stack([r.ids for r in cpu_r])).mean())
    cpu_status = [r.status for r in card_r] == [r.status for r in cpu_r]
    cpu_ru = bool(np.allclose([r.ru for r in cpu_r], [r.ru for r in card_r], rtol=0.01, atol=0))
    del cpu_svc

    out = dict(
        queries=n_micro, cut=cut,
        rate_qps_offered=SERVE_RATE_QPS, micro=micro, max_batch_64=wide,
        stacked_equal_to_serial=True, recall_at_10=recall,
        single=dict(queries=SERVE_SINGLE, **wall_stats(np, single_ms)),
        exact=dict(queries=SERVE_EXACT, wall_ms=exact_s * 1e3, equal_to_truth=exact_same,
                   mirror_unchanged=True,
                   launches={f: v for f, v in exact_launch.items() if v}),
        filtered=filt,
        paged=dict(queries=COLL_PAGE_QUERIES, pages=PAGES, k=PAGE_K, **wall_stats(np, page_ms),
                   token_bytes=len(tokens[-1]), overlap_mean=float(np.mean(overlap)),
                   overlap_min=float(np.min(overlap))),
        governance=governance, ingest=ingest,
        cpu=dict(requests=SERVE_CPU_REQUESTS, ids_equal=cpu_same, statuses_equal=cpu_status,
                 ru_within_1pct=cpu_ru, carry_s=carry_s),
        signatures=serving_jit_cache_size(), seconds=time.perf_counter() - t_phase,
        launches=counts, profile=prof,
    )
    print("serve: " + json.dumps(out), flush=True)
    missing = [f for f in SERVE_FORMS if counts[f] <= 0]
    check(not missing, f"phase 10: {missing} did not launch")
    check(recall >= RECALL_FLOOR_DEFAULTS,
          f"served recall@10 {recall} < {RECALL_FLOOR_DEFAULTS}")
    check(exact_same, "the exact plan's ids differ from exact ground truth")
    check(out["paged"]["overlap_mean"] >= PAGE_OVERLAP_FLOOR,
          f"served pages overlap the exact top {PAGES * PAGE_K} by "
          f"{out['paged']['overlap_mean']:.3f} < {PAGE_OVERLAP_FLOOR}")
    check(abs(recall_after - recall_before) <= 0.01,
          f"recall@10 moved {recall_before:.4f} -> {recall_after:.4f} over the ingest")
    check(cpu_same >= 0.99 and cpu_status and cpu_ru,
          f"card and CPU requests: ids equal in {cpu_same:.4f}, statuses equal {cpu_status}, "
          f"RU within 1 % {cpu_ru}")
    return out, counts


def rec_at(np, responses, truth, k: int) -> float:
    from repro_torch.core import recall as rec

    return rec.recall_at_k(np.stack([r.ids for r in responses]), truth, k)


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"no src/repro_torch beside {Path(__file__).name}: run it from the repository")
    if args.wide_tree:
        return wide_tree(Path(args.wide_tree), Path(args.wide_state))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.kernels import _build

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "float32 matmuls must not use TF32")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 2. build
    _build.library()
    print(f"build: {'compiled' if _build.BuildInfo.built else 'loaded'} "
          f"{_build.BuildInfo.path} in {_build.BuildInfo.seconds:.1f} s", flush=True)
    for line in _build.BuildInfo.log.splitlines():
        if any(w in line for w in ("registers", "spill", "rror")) or line.startswith("=="):
            print("  " + line.strip(), flush=True)

    # 3. kernels against their plain versions, and the floor no launch beats:
    # one trivial PyTorch elementwise kernel on 128 elements
    kern = kernel_checks(torch, K, dev, args.n)
    tiny = torch.zeros(128, device=dev)
    floor_ms = device_ms(torch, lambda: tiny.add_(1), 200)
    print(f"launch floor: x.add_(1) on 128 elements, device {floor_ms:.5f} ms/call", flush=True)
    for name, k in kern.items():
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        print(f"kernel {name}: ok, device {k['ms']:.4f} ms, host {k['host_ms_per_call']:.4f} "
              f"ms/call (plain {k['plain_ms']:.4f} ms, library {lib}, bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']}) at {k['shape']}", flush=True)
        for f in k.get("forms", []):
            lib = "none" if f["library_ms"] is None else f"{f['library_ms']:.4f} ms"
            print(f"  {f['form']} {f['shape']}: device {f['ms']:.4f} ms, host "
                  f"{f['host_ms_per_call']:.4f} ms/call, plain {f['plain_ms']:.4f} ms, "
                  f"library {lib}, bound {f['bound_ms']:.5f} ms", flush=True)
    if args.only_kernels:
        print(json.dumps({"kernels": kern, "card": card, "launch_floor_ms": floor_ms}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    torch.cuda.empty_cache()

    # 4-7. main path, card against CPU, wide cuts, launches (phase 8 below)
    path, idx, gpu_ids, queries, gt_docs, draw, masks = main_path(torch, np, K, dev, args)
    q = queries[:128]
    versus, cpu = cpu_compare(np, idx, gpu_ids, q, gt_docs)
    wide, wide_counts, wide_turns = wide_phase(torch, np, K, idx, q, masks, cpu, args.wide_parent)
    del cpu
    counts = {k: v + wide_counts[k] for k, v in path["launches"].items()}
    for name, why in OFF_PATH.items():
        print(f"launch check: {name} is off the main path ({counts[name]} launches): {why}",
              flush=True)
    missing = [k for k, v in counts.items() if v <= 0 and k not in OFF_PATH]
    check(not missing, f"kernels not launched on the main path or the wide cuts: {missing}")

    sources = {"pq_adc": 49, "topk_select": 61, "flat_l2": 44, "pq_encode": 29}
    line = {"kernels": [], "card": card, "launch_floor_ms": floor_ms}
    for name, k in kern.items():
        kernel = name.split(".")[0]
        entry = dict(name=name, route="cuda",
                     source=f"src/repro_torch/kernels/{kernel}/kernel.cu",
                     replaces=f"src/repro/kernels/{kernel}/kernel.py:{sources[kernel]}",
                     launches=counts[name], launches_main_path=path["launches"][name],
                     launches_wide_cuts=wide_counts[name],
                     launches_per_query_batch=path["launches_per_query_batch"][name])
        entry.update(k)
        if name == "pq_encode":  # each timed shape's launches on the main path
            for f in [entry] + entry["forms"]:
                f["launches_at_rows"] = path["pq_encode_launches_by_rows"].get(f["rows"], 0)
        line["kernels"].append(entry)
    prof = profile(torch, np, idx, q, draw, Path(args.out).parent) if args.profile else None

    # 8. deletes, pages and a durable partition, after every earlier phase
    updates, update_counts = update_phase(torch, np, K, idx, queries, path, args.seed)
    for entry in line["kernels"]:
        for part, c in update_counts.items():
            entry[f"launches_{part}"] = c[entry["name"]]
            entry["launches"] += c[entry["name"]]
        entry["launches_per_delete"] = update_counts["delete"][entry["name"]] / DELETES
        entry["launches_per_page"] = update_counts["pages"][entry["name"]] / (PAGE_QUERIES * PAGES)
        entry["launches_per_durable_insert"] = updates["durable"]["launches_per_insert"].get(
            entry["name"], 0.0)
        print(f"launches {entry['name']}: {entry['launches_per_delete']:.2f} per delete, "
              f"{entry['launches_per_page']:.2f} per page, "
              f"{entry['launches_per_durable_insert']:.2f} per durable insert", flush=True)
    # 9. a collection: its fan-outs, replicas and a split
    collection, coll_counts, svc = collection_phase(
        torch, np, K, dev, idx, queries, args.seed,
        Path(args.out).parent if args.profile else None)
    for entry in line["kernels"]:
        name = entry["name"]
        entry["launches_collection"] = coll_counts[name]
        entry["launches"] += coll_counts[name]
        for way in ("serial", "stacked"):
            entry[f"launches_per_fanout_batch_{way}"] = (
                collection[way]["launches_per_batch"].get(name, 0.0))
        print(f"launches {name}: {coll_counts[name]} in phase 9, per fan-out batch "
              f"{entry['launches_per_fanout_batch_serial']:.1f} serial, "
              f"{entry['launches_per_fanout_batch_stacked']:.1f} stacked", flush=True)
    # 10. the service over phase 9's collection
    del idx
    torch.cuda.empty_cache()
    serve, serve_counts = serve_phase(
        torch, np, K, dev, svc, queries, draw, args.seed,
        {name: f["plan"] for name, f in collection["filtered"].items()},
        Path(args.out).parent if args.profile else None)
    del svc
    for entry in line["kernels"]:
        name = entry["name"]
        entry["launches_serve"] = serve_counts[name]
        entry["launches"] += serve_counts[name]
        for way in ("serial", "spmd"):
            entry[f"launches_per_served_query_{way}"] = (
                serve["micro"][way]["launches_per_query"].get(name, 0.0))
        print(f"launches {name}: {serve_counts[name]} in phase 10, per served query "
              f"{entry['launches_per_served_query_serial']:.2f} serial, "
              f"{entry['launches_per_served_query_spmd']:.2f} stacked", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(kernels=line["kernels"], main_path=path,
                                                  card_vs_cpu=versus, wide_cuts=wide,
                                                  wide_turns=wide_turns, profile=prof,
                                                  updates=updates, collection=collection,
                                                  serve=serve, card=card,
                                                  launch_floor_ms=floor_ms),
                                             indent=1))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=100_000, help="documents to build (target)")
    ap.add_argument("--only-kernels", action="store_true")
    ap.add_argument("--out", default="", help="also write the results as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="after the checks, profile one query batch and three insert "
                         "mini-batches (tables beside --out)")
    ap.add_argument("--wide-parent", default="",
                    help="also run the wide cuts on this directory's package (an unpacked "
                         "earlier commit), in turns with this tree's")
    ap.add_argument("--wide-tree", default="", help=argparse.SUPPRESS)  # one turn of --wide-parent
    ap.add_argument("--wide-state", default="", help=argparse.SUPPRESS)
    return run(ap.parse_args())


if __name__ == "__main__":
    sys.exit(main())
