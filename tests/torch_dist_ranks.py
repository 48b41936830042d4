"""Rank programs for tests/test_torch_distributed.py: each runs in a process
of its own (spawned), joins a gloo group through a shared file, runs one
job on the port's mesh path and writes what rank 0 saw as .npz. Imports
torch and the port only (no JAX)."""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np


def main(job: str, world: int, rank: int, init_file: str, out_dir: str, payload: str) -> None:
    import torch

    torch.set_num_threads(1)
    from repro_torch.launch.mesh import start_process_group, stop_process_group

    start_process_group("gloo", world_size=world, rank=rank, init_file=init_file)
    try:
        result = JOBS[job](rank, world, payload)
    finally:
        stop_process_group()
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{job}.npz"), **result)


def search(rank: int, world: int, payload: str) -> dict:
    """distributed_search_fn over a (world,) data mesh, every rank slicing
    its shard of the whole arrays."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.partition.fanout import distributed_search_fn

    a = np.load(payload)
    mesh = make_host_mesh((world,), ("data",), device="cpu")
    fn = distributed_search_fn(mesh, L=32, k=10)
    ids, dists = fn(*(a[k] for k in ARGS))
    return {"ids": ids.numpy(), "dists": dists.numpy()}


ARGS = ("neighbors", "codes", "versions", "live", "vectors", "doc_ids", "medoid", "codebooks",
        "queries")


def train(rank: int, world: int, payload: str) -> dict:
    """One train step on a (2, world // 2) mesh (or (1, 1)) of each of
    TRAIN_CASES: the loss, the gradient norm and the step's fallback and
    replication counts; in f32 also every gradient at the initial weights
    and every updated parameter's whole value."""
    import torch

    from repro_torch.configs import get_smoke_config, input_specs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import steps as steps_mod
    from repro_torch.models.sharding import ReplicateFallback
    from repro_torch.train.optimizer import OptConfig

    tokens = torch.from_numpy(np.load(payload)["tokens"])
    shape = (1, 1) if world == 1 else (2, world // 2)
    mesh = make_host_mesh(shape, ("data", "model"), device="cpu")
    out = {}
    for name, arch, f32, accum in TRAIN_CASES:
        cfg = get_smoke_config(arch)
        if f32:
            cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        toks = tokens % cfg.vocab_size
        specs = input_specs(cfg, ShapeSpec("t", toks.shape[1], toks.shape[0], "train"))
        b = steps_mod.make_train_step(cfg, mesh, specs, OptConfig(lr=LR, total_steps=10),
                                      accum=accum)
        state = b.init()
        if f32:
            batch = {"tokens": steps_mod._put(toks, b.arg_shardings[1]["tokens"])}
            with steps_mod._on_mesh(ReplicateFallback(), mesh):
                loss, _ = M.loss_fn(state.params, cfg, batch, "full")
                grads = torch.autograd.grad(loss, list(state.params.parameters()))
            out.update({f"{name}__g{i}": g.full_tensor().numpy() for i, g in enumerate(grads)})
        state, m = b.fn(state, {"tokens": toks})
        out[f"{name}_loss"] = np.float64(m["loss"])
        out[f"{name}_grad_norm"] = np.float64(m["grad_norm"])
        out[f"{name}_fallbacks"] = np.array(sum(b.reshards.values()) + sum(b.replicated.values()))
        if f32:
            out.update({f"{name}__p{i}": p.full_tensor().detach().numpy()
                        for i, p in enumerate(state.params.parameters())})
    return out


# (name, smoke arch, f32, accum): dense GQA with the kv heads over
# ``model``, with micro-batches, at the config's dtype; an MoE whose 2 kv
# heads do not divide ``model`` (the query sequence split over it); MLA
# (the heads split, the rotary key shared); the hybrid Mamba2 and the RWKV6
# blocks (the causal conv's channels and the scans' heads over ``model``)
TRAIN_CASES = (("dense", "qwen3-14b", True, 1), ("dense_accum2", "qwen3-14b", True, 2),
               ("dense_dtype", "qwen3-14b", False, 1), ("moe", "qwen3-moe-235b-a22b", True, 1),
               ("mla", "deepseek-v2-lite-16b", True, 1), ("zamba2", "zamba2-1.2b", True, 1),
               ("rwkv6", "rwkv6-7b", True, 1))
LR = 1e-3


def decode(rank: int, world: int, payload: str) -> dict:
    """The smoke starcoder2-15b's decode step with its 2 048-position cache
    sharded on the sequence over ``model`` of a (2, world // 2) mesh, and
    the same step unsharded; the logits of both."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import steps as steps_mod
    from repro_torch.models.sharding import distribute

    cfg = get_smoke_config("starcoder2-15b")
    tokens = torch.from_numpy(np.load(payload)["tokens"])
    B, S = tokens.shape
    model = M.init_params(torch.Generator("cpu").manual_seed(0), cfg, "cpu")
    cache = M.init_cache(cfg, B, 2048, torch.float32, "cpu")
    logits, cache = M.prefill(model, cfg, {"tokens": tokens}, cache)
    tok = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
    sharded_cache = [type(c)(*(t.clone() for t in c)) for c in cache]
    want, _ = M.decode_step(model, cfg, tok, cache, S)

    mesh = make_host_mesh((2, world // 2), ("data", "model"), device="cpu")
    bundle = steps_mod.make_decode_step(cfg, mesh, batch=B, s_max=2048,
                                        cache_dtype=torch.float32)
    steps_mod.distribute_model(model, bundle.arg_shardings[0])
    cache_sh = [type(c)(*(distribute(t, s) for t, s in zip(c, sh)))
                for c, sh in zip(sharded_cache, bundle.arg_shardings[1])]
    got, _ = bundle.fn(model, cache_sh, tok, torch.tensor(S))
    return {"got": got.full_tensor().numpy(), "want": want.numpy(),
            "seq_placements": np.array([str(cache_sh[0].k.placements)])}


def restore(rank: int, world: int, payload: str) -> dict:
    """A checkpoint restored onto a (world,) data mesh's placements: every
    leaf's whole value, and whether every leaf came back a DTensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke_config, input_specs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import steps as steps_mod
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.checkpoint import _flatten
    from repro_torch.train.optimizer import OptConfig

    cfg = get_smoke_config("smollm-135m")
    mesh = make_host_mesh((world,), ("data",), device="cpu")
    specs = input_specs(cfg, ShapeSpec("t", 32, 4, "train"))
    b = steps_mod.make_train_step(cfg, mesh, specs, OptConfig())
    tree, _ = ckpt.restore(payload, steps_mod.state_tree(b.init(), cfg),
                           shardings=b.arg_shardings[0])
    flat = _flatten(tree)
    out = {k.replace("/", "__"): v.full_tensor().float().numpy() for k, v in flat.items()}
    out["all_dtensors"] = np.array(all(isinstance(v, DTensor) for v in flat.values()))
    out["sharded"] = np.array(sum(any(p.is_shard() for p in v.placements)
                                  for v in flat.values()))
    return out


def launch(rank: int, world: int, payload: str) -> dict:
    """The launcher on the group's data mesh: the smoke smollm-135m in f32,
    6 steps unbroken, then 6 steps killed after 3 (a checkpoint at 3, rank
    0 writing it) and resumed; the losses of both runs."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import train

    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), param_dtype="float32",
                              compute_dtype="float32")
    run = dict(steps=6, global_batch=4, seq_len=32, lr=1e-3, log_every=100, device="cpu")
    full = train(cfg, **run)
    ckpt_dir = os.path.join(payload, "ckpt")
    part = train(cfg, ckpt_dir=ckpt_dir, ckpt_every=3, stop_after=3, **run)
    resumed = train(cfg, ckpt_dir=ckpt_dir, ckpt_every=3, **run)
    return {"full": np.array(full["losses"]), "part": np.array(part["losses"]),
            "resumed": np.array(resumed["losses"])}


def ssm_local(rank: int, world: int, payload: str) -> dict:
    """The causal conv and the Mamba2 and RWKV6 chunk scans on DTensors of
    a (2, world // 2) mesh (each input's batch over ``data``; the conv's
    input also with its channels over ``model``, the layout a sharded
    projection leaves; Mamba2's D over ``data``, as the rules shard a 1-D
    parameter), which run on each rank's shards, and the plain calls on the
    whole tensors: every output of both, whole."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ssm

    a = {k: torch.from_numpy(v) for k, v in np.load(payload).items()}
    mesh = make_host_mesh((2, world // 2), ("data", "model"), device="cpu")

    def put(t, pl):
        return distribute_tensor(t, mesh, pl)

    batch, whole = [Shard(0), Replicate()], [Replicate(), Replicate()]
    calls = {
        "conv": (ssm._causal_conv, ("x", "w", "b"), (batch, whole, whole), ()),
        "conv_channels": (ssm._causal_conv, ("x", "w", "b"), ([Shard(0), Shard(2)], whole,
                                                             whole), ()),
        "mamba2": (ssm._mamba2_scan, ("xh", "Bc", "Cc", "dt", "A", "D"),
                   (batch, batch, batch, batch, whole, [Shard(0), Replicate()]), (16, 48)),
        "rwkv6": (ssm._rwkv6_scan, ("r", "k", "v", "lw", "u"),
                  (batch, batch, batch, batch, whole), (8, 40)),
    }
    out = {}
    for name, (fn, keys, pls, rest) in calls.items():
        got = fn(*(put(a[k], pl) for k, pl in zip(keys, pls)), *rest)
        want = fn(*(a[k] for k in keys), *rest)
        got, want = ((got,), (want,)) if isinstance(want, torch.Tensor) else (got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            out[f"{name}_got{i}"] = g.full_tensor().numpy()
            out[f"{name}_want{i}"] = w.numpy()
    return out


def collection_state(col) -> dict:
    """A collection's plain state (arrays as numpy, store bytes, dicts): what
    ``Collection.from_reference_state`` takes, from a collection of either
    package."""
    parts = []
    for p in col.partitions:
        snap = {k: ([np.asarray(c) for c in v] if k == "schemas" else
                    np.asarray(v) if hasattr(v, "shape") else v)
                for k, v in p.index.snapshot().items()}
        parts.append(dict(lo=p.lo, hi=p.hi, pid=p.pid, index=snap,
                          snapshot=p.providers.snapshot_bytes(), wal=p.providers.wal_bytes(),
                          doc_pk=dict(p.doc_pk), doc_props=dict(p.doc_props)))
    return dict(partitions=parts, next_pid=col._next_pid, splits=col.splits,
                merges=col.merges)


def load_collection(payload: str, residency=None):
    """(a fresh collection on the CPU, the payload's dict) from a pickle the
    test wrote: ``graph`` and ``collection`` (the configs' fields), ``state``
    (``collection_state``), the queries and the rest; every partition's
    paged tier at ``residency``."""
    import pickle

    from repro_torch.core import GraphConfig
    from repro_torch.partition import Collection, CollectionConfig

    with open(payload, "rb") as f:
        d = pickle.load(f)  # written by the test itself
    cfg = CollectionConfig(graph=GraphConfig(**d["graph"]), **d["collection"])
    col = Collection.from_reference_state(cfg, d["state"], device="cpu")
    for p in col.partitions:
        p.set_residency(residency)
    return col, d


def fanout_parts(col, d: dict, case: str):
    """(partitions, health) of a fan-out case: ``four`` — three built
    partitions, the second down, and an unbuilt one (20 documents, under the
    bootstrap: the host fallback); ``five`` — all four built, the third
    down, and the unbuilt one; ``four_built`` — the four built partitions
    (4 over 3 ranks pads to 6)."""
    from repro_torch.partition import PhysicalPartition

    unbuilt = PhysicalPartition(col.cfg, 0, 0, 90, device="cpu")
    unbuilt.insert(list(range(5000, 5020)), [0] * 20, d["unbuilt"])
    built = col.partitions
    parts, down = {"four": (built[:3] + [unbuilt], 1), "five": (built + [unbuilt], 2),
                   "four_built": (built, None)}[case]
    dead = None if down is None else parts[down].pid
    return parts, (None if dead is None else (lambda p: p.pid != dead))


FANOUT_CASES = ("four", "five", "four_built")
FANOUT_RESIDENCY = 0.5  # the paged tier half resident: touches hit and miss


def fanout_record(res) -> dict:
    """A fan-out's (ids, dists, info) as plain data, every float exact."""
    ids, dists, info = res
    stats = [(s.hops, s.cmps, s.expansions, s.full_reads, s.tier_hits, s.tier_misses)
             for s in info["stats_per_partition"]]
    keep = ("partition_ids", "ru_per_partition", "ru_total", "server_latencies_ms",
            "service_latency_ms", "failed_partitions", "complete", "spmd")
    return {"ids": ids, "dists": dists,
            "info": {**{k: info.get(k) for k in keep}, "stats": stats}}


def fanout(rank: int, world: int, payload: str) -> dict:
    """``SpmdFanout`` on a (world,) data mesh over each of FANOUT_CASES,
    each on a fresh copy of the test's collection (the queries in two
    batches, the second not a bucket): every rank's records, gathered on
    rank 0 as a pickle of [rank][case][batch]."""
    import pickle

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.partition import SpmdFanout

    mesh = make_host_mesh((world,), ("data",), device="cpu")
    mine = {}
    for case in FANOUT_CASES:
        col, d = load_collection(payload, FANOUT_RESIDENCY)
        parts, health = fanout_parts(col, d, case)
        spmd = SpmdFanout(device="cpu", mesh=mesh)
        mine[case] = [fanout_record(spmd.search(parts, q, 10, health=health))
                      for q in d["batches"]]
    every = [None] * world
    dist.all_gather_object(every, mine)
    return {"records": np.frombuffer(pickle.dumps(every), np.uint8)}


def serve_requests(engine, batches) -> list:
    """Each batch submitted and drained; the responses in order."""
    out = []
    for q in batches:
        rids = [engine.submit_query(qi, k=10, arrival_s=0.001 * i) for i, qi in enumerate(q)]
        engine.drain()
        out += [engine.pop_response(r) for r in rids]
    return out


def response_record(r) -> tuple:
    return (r.ids, r.dists, r.status, r.ru, r.plan, r.latency_ms, r.batch_size, r.complete)


def engine(rank: int, world: int, payload: str) -> dict:
    """``VectorServeEngine(dispatch_mode="spmd")`` under the group, once
    with ``spmd_mesh`` a (world,) data mesh and once with none (it takes
    ``make_serve_mesh()``), each on a fresh copy of the collection: every
    rank's responses, the ranks each fan-out spans, and the launch
    signatures after each batch."""
    import pickle

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.vector_engine import (EngineConfig, VectorServeEngine,
                                                 serving_jit_cache_size)

    mine = {}
    for name in ("explicit", "default"):
        col, d = load_collection(payload, FANOUT_RESIDENCY)
        mesh = make_host_mesh((world,), ("data",), device="cpu") if name == "explicit" else None
        eng = VectorServeEngine(col, EngineConfig(dispatch_mode="spmd"), spmd_mesh=mesh)
        marks, resp = [], []
        for q in d["serve_batches"]:
            resp += serve_requests(eng, [q])
            marks.append(serving_jit_cache_size())
        mine[name] = {"responses": [response_record(r) for r in resp], "marks": marks,
                      "mesh_devices": eng._spmd().n_devices}
    every = [None] * world
    dist.all_gather_object(every, mine)
    return {"records": np.frombuffer(pickle.dumps(every), np.uint8)}


def fanout_reference(rank: int, world: int, payload: str) -> dict:
    """``SpmdFanout`` on a (world,) data mesh over the reference's
    collection carried across (all its partitions, every one built): every
    rank's record of the query batch."""
    import pickle

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.partition import SpmdFanout

    col, d = load_collection(payload)
    mesh = make_host_mesh((world,), ("data",), device="cpu")
    mine = fanout_record(SpmdFanout(device="cpu", mesh=mesh).search(col.partitions,
                                                                     d["queries"], 10))
    every = [None] * world
    dist.all_gather_object(every, mine)
    return {"records": np.frombuffer(pickle.dumps(every), np.uint8)}


JOBS = {"search": search, "train": train, "decode": decode, "restore": restore,
        "launch": launch, "ssm_local": ssm_local, "fanout": fanout, "engine": engine,
        "fanout_reference": fanout_reference}

if __name__ == "__main__":
    main(*sys.argv[1:2], *map(int, sys.argv[2:4]), *sys.argv[4:])
