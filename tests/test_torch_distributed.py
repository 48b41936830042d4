"""The port's multi-rank paths on real gloo groups of CPU ranks (the
counterparts of tests/test_distributed.py): each job runs in spawned
processes, one per rank (``tests/torch_dist_ranks.py``), that meet through
a shared file, and rank 0's results come back as .npz.

- the 8-way ``distributed_search_fn(mesh)`` equals the one-card stacked
  call on the same 8 shards bit for bit (the reference test's data: P = 8,
  N_per = 250, D = 16), recall ≥ 0.7;
- a train step on (2, 4) equals that on (1, 1) (the smoke qwen3-14b in
  f32 at accum 1 and 2, and within the reference test's 2e-2 at its
  dtype; the smoke qwen3-moe and deepseek-v2-lite in f32): its loss,
  gradient norm and, in f32, updated parameters;
- the smoke starcoder2-15b decode with its 2 048-position cache sharded on
  the sequence matches the unsharded decode within 1e-2;
- a checkpoint restored onto a 2-rank mesh's placements equals the
  unsharded restore;
- the launcher on a 2-rank group trains on its data mesh as the mesh-free
  launcher does, and a killed run resumes.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

import torch_dist_ranks
from repro_torch.configs import get_smoke_config, input_specs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import DiskANNIndex, GraphConfig
from repro_torch.core import recall as rec
from repro_torch.models import steps as steps_mod
from repro_torch.partition.fanout import distributed_search_fn
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.checkpoint import _flatten
from repro_torch.train.optimizer import OptConfig


def _spawn(job: str, world: int, tmp_path, payload: str, timeout: float) -> dict:
    """Run ``job`` on ``world`` spawned ranks; rank 0's results."""
    ctx = mp.get_context("spawn")
    init = os.path.join(tmp_path, f"{job}_{world}.init")
    procs = [ctx.Process(target=torch_dist_ranks.main,
                         args=(job, world, r, init, str(tmp_path), payload))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
        assert not any(p.is_alive() for p in procs), f"{job}: a rank did not finish"
        assert [p.exitcode for p in procs] == [0] * world, f"{job}: rank exit codes"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    with np.load(os.path.join(tmp_path, f"{job}.npz")) as f:
        return {k: f[k] for k in f.files}


def test_distributed_search_8way_matches_single(tmp_path):
    rng = np.random.RandomState(0)
    P, N_per, D = 8, 250, 16
    centers = rng.randn(12, D).astype(np.float32)
    shards, all_data = [], []
    for p in range(P):
        data = (centers[rng.randint(0, 12, N_per)]
                + 0.15 * rng.randn(N_per, D)).astype(np.float32)
        cfg = GraphConfig(capacity=N_per, R=12, M=8, L_build=32, L_search=32,
                          bootstrap_sample=64, refine_sample=10**9, batch_size=50)
        idx = DiskANNIndex(cfg, D, seed=p, device="cpu")
        idx.insert(list(range(p * N_per, (p + 1) * N_per)), data)
        shards.append(idx)
        all_data.append(data)
    full = np.concatenate(all_data)
    mats = [[np.asarray(a) for a in s.pv.materialize(s.ctx)] for s in shards]
    arrays = dict(
        neighbors=np.stack([m[0] for m in mats]), codes=np.stack([m[1] for m in mats]),
        versions=np.stack([m[2] for m in mats]), live=np.stack([m[3] for m in mats]),
        vectors=np.stack([m[4] for m in mats]),
        doc_ids=np.stack([np.asarray(s.slot_to_doc) for s in shards]),
        medoid=np.asarray([s.medoid for s in shards], np.int32),
        codebooks=np.stack([np.asarray(s.schemas[0].codebooks) for s in shards]),
        queries=(full[rng.choice(len(full), 8)] + 0.02).astype(np.float32))
    payload = os.path.join(tmp_path, "shards.npz")
    np.savez(payload, **arrays)
    want_ids, want_d = distributed_search_fn(L=32, k=10, device="cpu")(
        *(arrays[k] for k in torch_dist_ranks.ARGS))

    got = _spawn("search", 8, tmp_path, payload, timeout=240)
    np.testing.assert_array_equal(got["ids"], want_ids.numpy())
    np.testing.assert_array_equal(got["dists"], want_d.numpy())
    gt = rec.ground_truth(arrays["queries"], full, np.ones(len(full), bool), 10, device="cpu")
    assert rec.recall_at_k(got["ids"], gt, 10) >= 0.7


def test_sharded_train_step_8way_matches_single_device(tmp_path):
    """One step on (2, 4) against (1, 1) (``torch_dist_ranks.TRAIN_CASES``:
    the smoke qwen3-14b at accum 1 and 2 and at its dtype, the smoke
    qwen3-moe and deepseek-v2-lite). In f32: the loss and the gradient
    norm within 1e-5 relative; every gradient at the initial weights within
    1e-5 of its leaf's max-abs; every updated parameter within 1e-5 of its
    leaf's max-abs, except where Adam's normalisation g / (|g| + eps)
    magnifies a rounding of the gradient (|g| within the two meshes'
    difference of zero, or within 10 eps of it), there within 2 lr. At the
    config's dtype: the loss and the gradient norm within 2e-2. On (2, 4)
    no op falls back and no parameter is replicated."""
    rng = np.random.RandomState(0)
    payload = os.path.join(tmp_path, "tokens.npz")
    np.savez(payload, tokens=rng.randint(0, 1 << 16, (4, 32)).astype(np.int32))
    one = _spawn("train", 1, tmp_path, payload, timeout=240)
    os.replace(os.path.join(tmp_path, "train.npz"), os.path.join(tmp_path, "train_1.npz"))
    eight = _spawn("train", 8, tmp_path, payload, timeout=300)
    for name, _, f32, _ in torch_dist_ranks.TRAIN_CASES:
        rel = 1e-5 if f32 else 2e-2
        for key in ("loss", "grad_norm"):
            got, want = eight[f"{name}_{key}"], one[f"{name}_{key}"]
            assert abs(got - want) <= rel * abs(want), (name, key, got, want)
        assert int(eight[f"{name}_fallbacks"]) == 0, name
        n = len([k for k in one if k.startswith(f"{name}__g")])
        assert n > 0 or not f32, name
        for i in range(n):
            g1, g8 = one[f"{name}__g{i}"], eight[f"{name}__g{i}"]
            gscale = float(np.abs(g1).max()) or 1.0
            assert float(np.abs(g8 - g1).max()) <= 1e-5 * gscale, (name, "gradient", i)
            near = (np.abs(g1) <= np.abs(g8 - g1)) | (np.abs(g1) <= 10 * OptConfig().eps)
            d = np.abs(eight[f"{name}__p{i}"] - one[f"{name}__p{i}"])
            scale = float(np.abs(one[f"{name}__p{i}"]).max()) or 1.0
            assert float(d[~near].max(initial=0.0)) <= 1e-5 * scale, (name, i)
            assert float(d[near].max(initial=0.0)) <= 2 * torch_dist_ranks.LR, (name, i)


def test_decode_step_sharded_cache(tmp_path):
    cfg = get_smoke_config("starcoder2-15b")
    rng = np.random.RandomState(0)
    payload = os.path.join(tmp_path, "tokens.npz")
    np.savez(payload, tokens=rng.randint(0, cfg.vocab_size, (8, 16)).astype(np.int32))
    res = _spawn("decode", 8, tmp_path, payload, timeout=300)
    assert "Shard(dim=2)" in str(res["seq_placements"])  # (seg, B, S, ...): S over model
    assert float(np.abs(res["got"] - res["want"]).max()) < 1e-2


def test_restore_onto_two_rank_mesh_equals_unsharded(tmp_path):
    cfg = get_smoke_config("smollm-135m")
    specs = input_specs(cfg, ShapeSpec("t", 32, 4, "train"))
    b = steps_mod.make_train_step(cfg, specs, OptConfig(), seed=5, device="cpu")
    state = b.init()
    d = os.path.join(tmp_path, "ckpt")
    tree = steps_mod.state_tree(state, cfg)
    ckpt.save(d, 3, tree, extra={"step": 3})
    want, _ = ckpt.restore(d, tree)
    res = _spawn("restore", 2, tmp_path, d, timeout=240)
    assert bool(res["all_dtensors"]) and int(res["sharded"]) > 0
    for path, leaf in _flatten(want).items():
        np.testing.assert_array_equal(res[path.replace("/", "__")], leaf.float().numpy(),
                                      err_msg=path)


def test_launcher_trains_and_resumes_on_a_two_rank_mesh(tmp_path):
    """``launch.train.train`` under a 2-rank group trains on its data mesh:
    its losses equal the mesh-free launcher's (1e-5 relative), and a run
    killed after a checkpoint (written by rank 0) resumes to them."""
    from repro_torch.launch.train import train

    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), param_dtype="float32",
                              compute_dtype="float32")
    want = np.array(train(cfg, steps=6, global_batch=4, seq_len=32, lr=1e-3, log_every=100,
                          device="cpu")["losses"])
    got = _spawn("launch", 2, tmp_path, str(tmp_path), timeout=240)
    for key in ("full", "resumed"):
        assert len(got[key]) == (6 if key == "full" else 3)
    np.testing.assert_allclose(got["full"], want, rtol=1e-5)
    np.testing.assert_allclose(got["part"], want[:3], rtol=1e-5)
    np.testing.assert_allclose(got["resumed"], want[3:], rtol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
