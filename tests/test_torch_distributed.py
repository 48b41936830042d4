"""The port's multi-rank paths on real gloo groups of CPU ranks (the
counterparts of tests/test_distributed.py): each job runs in spawned
processes, one per rank (``tests/torch_dist_ranks.py``), that meet through
a shared file, and rank 0's results come back as .npz.

- the 8-way ``distributed_search_fn(mesh)`` equals the one-card stacked
  call on the same 8 shards bit for bit (the reference test's data: P = 8,
  N_per = 250, D = 16), recall ≥ 0.7;
- a train step on (2, 4) equals that on (1, 1) (the smoke qwen3-14b in
  f32 at accum 1 and 2, and within the reference test's 2e-2 at its
  dtype; the smoke qwen3-moe, deepseek-v2-lite, zamba2 and rwkv6 in f32): its loss,
  gradient norm and, in f32, updated parameters; zamba2's and rwkv6's
  (1, 1) step equals the mesh-free step;
- the causal conv and the Mamba2 and RWKV6 chunk scans on each rank's
  shards equal the plain calls bit for bit;
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
from conftest import clustered_data
from repro_torch.configs import get_smoke_config, input_specs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import DiskANNIndex, GraphConfig
from repro_torch.core import recall as rec
from repro_torch.core import search as tsearch
from repro_torch.models import steps as steps_mod
from repro_torch.partition import Collection, CollectionConfig, SpmdFanout
from repro_torch.partition import fanout as tfan
from repro_torch.partition.fanout import distributed_search_fn
from repro_torch.serve.vector_engine import EngineConfig, VectorServeEngine
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
    qwen3-moe, deepseek-v2-lite, zamba2 and rwkv6). In f32: the loss and the gradient
    norm within 1e-5 relative; every gradient at the initial weights within
    1e-5 of its leaf's max-abs; every updated parameter within 1e-5 of its
    leaf's max-abs, except where Adam's normalisation g / (|g| + eps)
    magnifies a rounding of the gradient (|g| within the two meshes'
    difference of zero, or within 10 eps of it), there within 2 lr. At the
    config's dtype: the loss and the gradient norm within 2e-2. On (2, 4)
    no op falls back and no parameter is replicated. zamba2's and rwkv6's
    (1, 1) step, whose scans run on local shards as on (2, 4), is held
    against the mesh-free step at the same limits."""
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
    # the SSM blocks scan on local shards on every mesh, (1, 1) too: hold
    # that step's gradients and updated parameters against the mesh-free
    # step's (itself held against the reference), at the same limits
    for name, arch, _, _ in torch_dist_ranks.TRAIN_CASES:
        if name not in ("zamba2", "rwkv6"):
            continue
        free = _mesh_free_train_step(arch, np.load(payload)["tokens"])
        _assert_step_matches(one, free, name)


def _mesh_free_train_step(arch: str, tokens: np.ndarray) -> dict:
    """What ``torch_dist_ranks.train`` records of an f32 case, from the
    mesh-free ``make_train_step`` on the CPU with the same seed."""
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32")
    toks = torch.from_numpy(tokens % cfg.vocab_size)
    specs = input_specs(cfg, ShapeSpec("t", toks.shape[1], toks.shape[0], "train"))
    b = steps_mod.make_train_step(cfg, specs, OptConfig(lr=torch_dist_ranks.LR, total_steps=10),
                                  device="cpu")
    state = b.init()
    loss, _ = M.loss_fn(state.params, cfg, {"tokens": toks}, "full")
    grads = torch.autograd.grad(loss, list(state.params.parameters()))
    state, m = b.fn(state, {"tokens": toks})
    out = {"loss": np.float64(m["loss"]), "grad_norm": np.float64(m["grad_norm"])}
    out.update({f"_g{i}": g.numpy() for i, g in enumerate(grads)})
    out.update({f"_p{i}": p.detach().numpy() for i, p in enumerate(state.params.parameters())})
    return out


def _assert_step_matches(one: dict, free: dict, name: str) -> None:
    """The (1, 1) step of case ``name`` in ``one`` against the mesh-free
    step ``free``: the loss and the gradient norm within 1e-5 relative,
    every gradient within 1e-5 of its leaf's max-abs, every updated
    parameter within 1e-5 of its leaf's max-abs bar Adam's magnified
    near-zero gradients (there within 2 lr)."""
    for key in ("loss", "grad_norm"):
        got, want = one[f"{name}_{key}"], free[key]
        assert abs(got - want) <= 1e-5 * abs(want), (name, key, got, want)
    n = len([k for k in free if k.startswith("_g")])
    assert n == len([k for k in one if k.startswith(f"{name}__g")]) > 0, name
    for i in range(n):
        g0, g1 = free[f"_g{i}"], one[f"{name}__g{i}"]
        assert g1.shape == g0.shape, (name, i)
        gscale = float(np.abs(g0).max()) or 1.0
        assert float(np.abs(g1 - g0).max()) <= 1e-5 * gscale, (name, "gradient vs mesh-free", i)
        near = (np.abs(g0) <= np.abs(g1 - g0)) | (np.abs(g0) <= 10 * OptConfig().eps)
        d = np.abs(one[f"{name}__p{i}"] - free[f"_p{i}"])
        scale = float(np.abs(free[f"_p{i}"]).max()) or 1.0
        assert float(d[~near].max(initial=0.0)) <= 1e-5 * scale, (name, "param vs mesh-free", i)
        assert float(d[near].max(initial=0.0)) <= 2 * torch_dist_ranks.LR, (name, i)


def test_ssm_conv_and_scans_on_local_shards_equal_the_plain_calls(tmp_path):
    """On a (2, 4) mesh the causal conv (channels over ``model``) and the
    Mamba2 and RWKV6 chunk scans (heads over ``model``; sequences that pad
    to a chunk multiple) run on each rank's shards, and their outputs and
    final states equal the plain calls' on the whole tensors bit for bit."""
    rng = np.random.RandomState(0)
    B, S, nh, hd, ds = 4, 40, 8, 16, 16

    def f32(*shape):
        return rng.randn(*shape).astype(np.float32)

    payload = os.path.join(tmp_path, "ssm.npz")
    np.savez(payload, x=f32(B, 24, 32), w=f32(4, 32), b=f32(32),
             xh=f32(B, S, nh, hd), Bc=f32(B, S, ds), Cc=f32(B, S, ds),
             dt=np.log1p(np.exp(f32(B, S, nh))), A=-np.exp(f32(nh)), D=f32(nh),
             r=f32(B, S, nh, hd), k=f32(B, S, nh, hd), v=f32(B, S, nh, hd),
             lw=-np.exp(f32(B, S, nh, hd)), u=f32(nh, hd))
    got = _spawn("ssm_local", 8, tmp_path, payload, timeout=240)
    names = sorted(k for k in got if "_got" in k)
    assert len(names) == 6, names  # two conv layouts, each scan's output and state
    for key in names:
        want = got[key.replace("_got", "_want")]
        assert got[key].shape == want.shape, key
        np.testing.assert_array_equal(got[key].view(np.int32), want.view(np.int32), err_msg=key)


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


# the collections of the fan-out cases: one partition past its refine sample
# (V = 2 beside V = 1), as tests/test_torch_fanout.py's
GKW = dict(capacity=480, R=16, M=8, L_build=32, L_search=48, bootstrap_sample=64,
           refine_sample=300, batch_size=40)
FAN_D, FAN_K, SAME_SLOTS, RECALL_TOL, RU_REL = 16, 10, 0.99, 0.01, 0.01


def _queries(rng, data, n):
    pick = rng.choice(len(data), n, replace=False)
    return (data[pick] + 0.05 * rng.randn(n, data.shape[1])).astype(np.float32)


@pytest.fixture(scope="module")
def fanout_payload(tmp_path_factory):
    """A port collection of 4 partitions (900 clustered documents, D = 16;
    one partition past its refine sample, so V = 2 beside V = 1) pickled as plain state with its queries: two fan-out batches (12, not a
    bucket, and 16), three served micro-batches of 16, and the unbuilt
    partition's 20 vectors."""
    import pickle

    rng = np.random.RandomState(0)
    n = 900
    data = clustered_data(rng, n, FAN_D)
    cc = dict(dim=FAN_D, max_vectors_per_partition=450, initial_partitions=4)
    col = Collection(CollectionConfig(graph=GraphConfig(**GKW), **cc), device="cpu")
    # the last 200 under one key: its partition passes the refine sample
    col.insert(list(range(n)), [f"pk{i % 101 if i < 700 else 0}" for i in range(n)], data)
    assert len(col.partitions) == 4
    assert all(p.index._graph_built for p in col.partitions)
    assert sorted({len(p.index.schemas) for p in col.partitions}) == [1, 2]
    path = os.path.join(tmp_path_factory.mktemp("fanout"), "collection.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(graph=GKW, collection=cc, state=torch_dist_ranks.collection_state(col),
                         batches=[_queries(rng, data, 12), _queries(rng, data, 16)],
                         serve_batches=[_queries(rng, data, 16) for _ in range(3)],
                         unbuilt=(data[:20] + 0.3).astype(np.float32)), f)
    return path


def _gathered(res: dict) -> list:
    import pickle

    return pickle.loads(res["records"].tobytes())  # written by the ranks


def _same_fanout(got: dict, want: dict, what: str, spmd: bool = True):
    np.testing.assert_array_equal(got["ids"], want["ids"], err_msg=what)
    np.testing.assert_array_equal(got["dists"].view(np.int32), want["dists"].view(np.int32),
                                  err_msg=what)
    for key, value in want["info"].items():
        if key != "spmd":
            assert got["info"][key] == value, (what, key)
    if spmd:
        assert {**got["info"]["spmd"], "mesh_devices": 1} == want["info"]["spmd"], what


@pytest.mark.parametrize("world", [2, 3])
def test_spmd_fanout_across_ranks_bit_equal(tmp_path, fanout_payload, world):
    """``SpmdFanout(mesh)`` on a 2- and a 3-rank gloo group, on 4 and 5
    partitions with one unbuilt and one down, and on the 4 built (padded to
    6 over 3 ranks), the paged tier half resident: every rank returns the
    one-rank call's ids, dists, RU, stats, modelled latencies and
    ``failed_partitions`` bit for bit, and ``batched_fanout_search``'s;
    ``info["spmd"]`` is the reference's, with ``mesh_devices`` R."""
    got = _gathered(_spawn("fanout", world, tmp_path, fanout_payload, timeout=240))
    assert len(got) == world
    for case in torch_dist_ranks.FANOUT_CASES:
        want = {}
        for way in ("one", "serial"):
            col, d = torch_dist_ranks.load_collection(fanout_payload,
                                                      torch_dist_ranks.FANOUT_RESIDENCY)
            parts, health = torch_dist_ranks.fanout_parts(col, d, case)
            one = SpmdFanout(device="cpu")
            want[way] = [torch_dist_ranks.fanout_record(
                one.search(parts, q, FAN_K, health=health) if way == "one" else
                tfan.batched_fanout_search(parts, q, FAN_K, batch_buckets=tsearch.BATCH_BUCKETS,
                                           health=health)) for q in d["batches"]]
        in_prog = {"four": 2, "five": 3, "four_built": 4}[case]
        for b, w in enumerate(want["one"]):
            assert w["info"]["spmd"] == {"partitions_in_program": in_prog, "mesh_devices": 1}
            assert w["info"]["complete"] == (case == "four_built")
            _same_fanout(w, want["serial"][b], f"{case} one-rank vs serial", spmd=False)
            for r, rank in enumerate(got):
                _same_fanout(rank[case][b], w, f"{case} batch {b} rank {r}")
                assert rank[case][b]["info"]["spmd"]["mesh_devices"] == world


def test_spmd_engine_across_ranks_equals_one_rank(tmp_path, fanout_payload):
    """``VectorServeEngine(dispatch_mode="spmd")`` on a 2-rank group, with
    ``spmd_mesh`` a 2-rank mesh and with none (it takes
    ``make_serve_mesh()`` over both ranks): each rank's responses equal a
    one-rank engine's on the same requests bit for bit, and the launch
    signatures stay flat after the bucket's first batch."""
    got = _gathered(_spawn("engine", 2, tmp_path, fanout_payload, timeout=240))
    col, d = torch_dist_ranks.load_collection(fanout_payload, torch_dist_ranks.FANOUT_RESIDENCY)
    eng = VectorServeEngine(col, EngineConfig(dispatch_mode="spmd"))
    want = [torch_dist_ranks.response_record(r)
            for r in torch_dist_ranks.serve_requests(eng, d["serve_batches"])]
    assert eng._spmd().n_devices == 1 and {w[4] for w in want} == {"graph-spmd"}
    for r, rank in enumerate(got):
        for name in ("explicit", "default"):
            rec = rank[name]
            assert rec["mesh_devices"] == 2, (r, name)
            assert rec["marks"][1:] == rec["marks"][:1] * (len(rec["marks"]) - 1), rec["marks"]
            assert len(rec["responses"]) == len(want)
            for g, w in zip(rec["responses"], want):
                np.testing.assert_array_equal(g[0], w[0])
                np.testing.assert_array_equal(g[1].view(np.int32), w[1].view(np.int32))
                assert g[2:] == w[2:], (r, name)


def test_spmd_fanout_refuses_a_mesh_without_running_ranks():
    """A mesh the fan-out cannot use raises: one of axis sizes only."""
    from repro_torch.launch.mesh import AbstractMesh

    with pytest.raises(ValueError, match="running ranks"):
        SpmdFanout(device="cpu", mesh=AbstractMesh((2,), ("data",)))


def test_spmd_fanout_4_ranks_against_the_reference(tmp_path):
    """The reference's ``SpmdFanout(make_serve_mesh(4))`` on 4 emulated
    devices, in a subprocess, over a collection of 5 partitions (padded to
    8) built from seeded data, and the port's on a 4-rank gloo group over
    the same collection carried across: on every rank ids equal in 99 % of
    slots, recall within 0.01 and RU within 1 % (``test_torch_fanout.py``'s
    tolerances), ``info["spmd"]`` equal."""
    import pickle
    import subprocess
    import sys
    import textwrap

    from repro_torch.core import recall as rec

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    payload = os.path.join(tmp_path, "reference.pkl")
    code = textwrap.dedent(f"""
        import pickle
        import numpy as np
        from conftest import clustered_data
        from torch_dist_ranks import collection_state
        from repro.core import GraphConfig
        from repro.launch.mesh import make_serve_mesh
        from repro.partition import Collection, CollectionConfig
        from repro.partition.fanout import SpmdFanout
        gkw, n, D = {GKW!r}, 1000, {FAN_D}
        cc = dict(dim=D, max_vectors_per_partition=450, initial_partitions=5)
        rng = np.random.RandomState(1)
        data = clustered_data(rng, n, D)
        col = Collection(CollectionConfig(graph=GraphConfig(**gkw), **cc))
        col.insert(list(range(n)), [f"pk{{i % 101}}" for i in range(n)], data)
        pick = rng.choice(n, 32, replace=False)
        q = (data[pick] + 0.05 * rng.randn(32, D)).astype(np.float32)
        mesh = make_serve_mesh()
        assert mesh.devices.size == 4
        ids, dists, info = SpmdFanout(mesh).search(col.partitions, q, {FAN_K})
        with open({payload!r}, "wb") as f:
            pickle.dump(dict(graph=gkw, collection=cc, state=collection_state(col), queries=q,
                             data=data, ids=np.asarray(ids), dists=np.asarray(dists),
                             ru=[float(r) for r in info["ru_per_partition"]],
                             spmd=dict(info["spmd"])), f)
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(root, "src"), os.path.join(root, "tests")]),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(payload, "rb") as f:
        ref = pickle.load(f)  # written by the subprocess above
    assert ref["spmd"] == {"partitions_in_program": 5, "mesh_devices": 4}
    got = _gathered(_spawn("fanout_reference", 4, tmp_path, payload, timeout=240))
    truth = rec.ground_truth(ref["queries"], ref["data"], np.ones(len(ref["data"]), bool), FAN_K,
                             device="cpu")
    for r, rank in enumerate(got):
        assert rank["info"]["spmd"] == ref["spmd"], r
        same = float((rank["ids"] == ref["ids"]).mean())
        assert same >= SAME_SLOTS, (r, same)
        r_got, r_want = (rec.recall_at_k(i, truth, FAN_K) for i in (rank["ids"], ref["ids"]))
        assert abs(r_got - r_want) <= RECALL_TOL, (r, r_got, r_want)
        assert np.allclose(rank["info"]["ru_per_partition"], ref["ru"], rtol=RU_REL, atol=0), r


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
