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
# (the heads split, the rotary key shared)
TRAIN_CASES = (("dense", "qwen3-14b", True, 1), ("dense_accum2", "qwen3-14b", True, 2),
               ("dense_dtype", "qwen3-14b", False, 1), ("moe", "qwen3-moe-235b-a22b", True, 1),
               ("mla", "deepseek-v2-lite-16b", True, 1))
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


JOBS = {"search": search, "train": train, "decode": decode, "restore": restore,
        "launch": launch}

if __name__ == "__main__":
    main(*sys.argv[1:2], *map(int, sys.argv[2:4]), *sys.argv[4:])
