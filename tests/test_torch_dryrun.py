"""The port's dry-run (``repro_torch.launch.dryrun``) on fake process
groups in this process: the cosmosann cell's argument bytes on both
production meshes, an exact per-device FLOP count of a sharded product,
the layer-variant identity F(full) = F(L1) + (L−1)·(F(L2) − F(L1)), the
incremental records (a finished cell is skipped, ``force`` redoes it), a
failing cell recorded as data with exit code 1, a smoke train cell's
argument bytes against the reference's ``memory_analysis()`` (compiled in
a subprocess with 8 host devices), smoke cells (MoE and dense train, MoE
prefill, MLA decode) with no fallback and no parameter gathered over
``model``, the fallback's count of such a gather, and a cell with one
recorded as failed."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.models import sharding as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one rank's shard-stacked index arrays and the replicated queries
# (10 M rows over 256 / 512 ranks: 39 062 / 19 531 rows)
COSMOS_ARG_BYTES = {"single": 131_724_856, "multi": 66_452_254}


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_cosmos_cell_argument_bytes(tmp_path, mesh_name):
    r = dryrun.run_cell("cosmosann", "query", mesh_name, str(tmp_path))
    assert r["ok"], r.get("error")
    assert r["devices"] == (256 if mesh_name == "single" else 512)
    rec = r["records"][0]
    assert rec["memory"]["argument_size_in_bytes"] == COSMOS_ARG_BYTES[mesh_name]
    # the (B, S_local·k) partials gathered once per mesh axis, ids and dists
    n_axes = 2 if mesh_name == "single" else 3
    assert rec["collectives"]["all-gather"]["count"] == 2 * n_axes
    assert rec["flops"] > 0 and rec["flops_global"] == rec["flops"] * r["devices"]


def test_per_device_flops_of_a_sharded_product():
    mesh = dryrun.production_mesh("single")
    a = torch.empty((256, 4096), device="meta")
    b = torch.empty((4096, 14336), device="meta")

    def build():
        return (torch.matmul,
                (S.empty_dtensor(a, S.Sharding(mesh, (Shard(0), Replicate()))),
                 S.empty_dtensor(b, S.Sharding(mesh, (Replicate(), Shard(1))))), {})

    rec = dryrun.trace(build, "mm", want_memory=True)
    assert rec["flops"] == 2 * 16 * 4096 * 896  # one rank's (16, 4096) @ (4096, 896)
    assert rec["flops_global"] == 2 * 256 * 4096 * 14336
    assert sum(c["count"] for c in rec["collectives"].values()) == 0
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == (16 * 4096 + 4096 * 896) * 4
    assert mem["output_size_in_bytes"] == 16 * 896 * 4


def test_layer_variants_add_up_for_a_uniform_arch():
    """The eager counter sees every layer: the reference's extrapolation
    from L1 and L2 is an identity here."""
    mesh = _mesh_2x4()
    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), num_layers=4)
    assert cfg.uniform and cfg.ssm is None
    shape = ShapeSpec("t", 32, 8, "train")
    f = {}
    for tag, vcfg in (("full", cfg), ("L1", dryrun._variant_cfg(cfg, 1, unroll=True)),
                      ("L2", dryrun._variant_cfg(cfg, 2, unroll=True))):
        f[tag] = dryrun.trace(lambda vcfg=vcfg: dryrun._build_step(vcfg, shape, mesh),
                              tag, False)["flops"]
    L = cfg.num_layers
    assert f["full"] == f["L1"] + (L - 1) * (f["L2"] - f["L1"]), f


def test_finished_cell_is_skipped_and_force_redoes_it(tmp_path, monkeypatch):
    calls = []
    real = dryrun._run_cosmos_cell
    monkeypatch.setattr(dryrun, "_run_cosmos_cell", lambda mesh: calls.append(1) or real(mesh))
    first = dryrun.run_cell("cosmosann", "query", "single", str(tmp_path))
    again = dryrun.run_cell("cosmosann", "query", "single", str(tmp_path))
    assert len(calls) == 1 and again["records"] == json.loads(json.dumps(first["records"]))
    dryrun.run_cell("cosmosann", "query", "single", str(tmp_path), force=True)
    assert len(calls) == 2


def test_failing_cell_is_recorded_and_exits_1(tmp_path, monkeypatch):
    def broken(mesh):
        raise RuntimeError("injected")

    monkeypatch.setattr(dryrun, "_run_cosmos_cell", broken)
    rc = dryrun.main(["--arch", "cosmosann", "--mesh", "single", "--out", str(tmp_path)])
    assert rc == 1
    with open(tmp_path / "cosmosann__query__single.json") as f:
        rec = json.load(f)
    assert rec["ok"] is False and "injected" in rec["error"] and "Traceback" in rec["traceback"]


def _mesh_2x4():
    dryrun.fake_group(8)
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh((2, 4), ("data", "model"), device="cpu")


def test_train_cell_argument_bytes_equal_the_reference(tmp_path):
    """A smoke train cell on a (2, 4) mesh: the port's argument bytes (the
    local shards of parameters, both moments, the step and the batch)
    against the reference's ``memory_analysis()`` for the same cell."""
    code = textwrap.dedent("""
        import json
        from repro import compat
        from repro.configs import get_smoke_config
        from repro.configs.shapes import ShapeSpec, input_specs
        from repro.models import steps
        cfg = get_smoke_config("qwen3-14b")
        specs = input_specs(cfg, ShapeSpec("t", 32, 8, "train"))
        mesh = compat.make_mesh((2, 4), ("data", "model"))
        b = steps.make_train_step(cfg, mesh, specs, accum=4, remat="full")
        ma = b.fn.lower(b.arg_shapes[0], specs).compile().memory_analysis()
        print(json.dumps({"arg": int(ma.argument_size_in_bytes)}))
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])["arg"]

    mesh = _mesh_2x4()
    cfg = get_smoke_config("qwen3-14b")
    rec = dryrun.trace(lambda: dryrun._build_step(cfg, ShapeSpec("t", 32, 8, "train"), mesh),
                       "full", True)
    assert rec["memory"]["argument_size_in_bytes"] == ref


def test_cell_past_its_time_limit_is_recorded(tmp_path, monkeypatch):
    import time

    monkeypatch.setattr(dryrun, "_run_cosmos_cell", lambda mesh: time.sleep(5))
    r = dryrun.run_cell("cosmosann", "query", "single", str(tmp_path), timeout_s=0.5)
    assert r["ok"] is False and r["error"].startswith("CellTimeout")


@pytest.mark.parametrize("arch,kind", [("qwen3-moe-235b-a22b", "train"), ("qwen3-14b", "train"),
                                       ("qwen3-moe-235b-a22b", "prefill"),
                                       ("deepseek-v2-lite-16b", "decode")])
def test_smoke_cell_replicates_no_parameter(arch, kind):
    """A smoke cell on a fake (2, 4) mesh (an MoE and a dense train step,
    an MoE prefill, an MLA decode): no op falls back to replicated inputs,
    and no parameter or cache leaf is gathered over ``model``."""
    mesh = _mesh_2x4()
    cfg = get_smoke_config(arch)
    shape = ShapeSpec("t", 32, 8, kind) if kind == "train" else ShapeSpec("s", 64, 8, kind)
    rec = dryrun.trace(lambda: dryrun._build_step(cfg, shape, mesh), "full", True)
    assert rec["reshards"] == {} and rec["replicated"] == {}, rec
    assert rec["memory"]["argument_size_in_bytes"] > 0


@pytest.mark.parametrize("arch,kind", [("zamba2-1.2b", "train"), ("zamba2-1.2b", "prefill"),
                                       ("rwkv6-7b", "train"), ("rwkv6-7b", "prefill")])
def test_ssm_smoke_cell_traces_ok(arch, kind, monkeypatch):
    """zamba2's and rwkv6's smoke cells on a fake (2, 4) mesh, whose
    channels and heads divide ``model``, through the dry-run's cell plan
    (the full depth and its cut variants): ok, no op falls back, no
    parameter or cache leaf gathered over ``model``, and the causal conv
    and the chunk scans ran on each rank's local shards."""
    from repro_torch.models import ssm

    calls = []
    real = ssm.local_split
    monkeypatch.setattr(ssm, "local_split",
                        lambda fn, *a: calls.append(fn.__name__) or real(fn, *a))
    mesh = _mesh_2x4()
    cfg = get_smoke_config(arch)
    s = cfg.ssm
    din = s.expand * cfg.d_model
    assert (din // s.head_dim) % 4 == 0 and (din + 2 * s.d_state) % 4 == 0
    shape = ShapeSpec("t", 32, 8, kind) if kind == "train" else ShapeSpec("s", 64, 8, kind)
    out = dryrun._run_lm_cell(arch, cfg, shape, kind, "2x4", mesh)
    assert out["ok"], out.get("error")
    assert all(r["reshards"] == {} and r["replicated"] == {} for r in out["records"]), out
    want = {"_causal_conv", "_mamba2_scan"} if s.kind == "mamba2" else {"_rwkv6_scan"}
    assert set(calls) == want, set(calls)


def test_fallback_counts_a_parameter_gathered_over_model():
    """``ReplicateFallback.replicated`` names a watched tensor (or a view of
    it) whose shard over ``model`` a reshape gathers; a gather over
    ``data`` (FSDP) is not counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = _mesh_2x4()
    fb = S.ReplicateFallback()
    with FakeTensorMode():
        w = torch.empty((8, 16), device="meta")
        on_model = S.empty_dtensor(w, S.Sharding(mesh, (Replicate(), Shard(1))))
        on_data = S.empty_dtensor(w, S.Sharding(mesh, (Shard(1), Replicate())))
        fb.watch([("on_model", on_model), ("on_data", on_data)])
        with fb:
            on_data.reshape(128)
            assert fb.replicated == {}
            on_model.unsqueeze(0).reshape(128)  # a view of it, flattened across its shard
    assert fb.replicated == {"on_model": 1} and fb.ops == {}


def test_cell_with_a_replicated_parameter_fails(monkeypatch):
    """A cell whose step gathered a parameter over ``model`` is recorded as
    failed, naming the parameter: its bytes are not the sharded layout's."""
    real = dryrun._build_step

    def build(*a, **kw):
        fn, args, bundle = real(*a, **kw)
        bundle.replicated["blocks.0.mixer.wq"] = 1
        return fn, args, bundle

    monkeypatch.setattr(dryrun, "_build_step", build)
    mesh = _mesh_2x4()
    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), num_layers=1)
    out = dryrun._run_lm_cell("qwen3-14b", cfg, ShapeSpec("d", 64, 8, "decode"), "decode",
                              "2x4", mesh)
    assert out["ok"] is False and "blocks.0.mixer.wq" in out["error"]
    assert all(r["replicated"] == {"blocks.0.mixer.wq": 1} for r in out["records"])
