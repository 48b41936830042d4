"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on the
production meshes with no device allocation (the port of
``repro.launch.dryrun``).

Run: ``python -m repro_torch.launch.dryrun --arch all --shape all --mesh
both`` (the host's CPU; no card needed). Each cell runs in this process
under a *fake* process group of the mesh's size (one process standing for
every rank: collectives move nothing) and ``FakeTensorMode`` (tensors
carry shapes and dtypes, no storage): the port's step factories build the
sharded step on the mesh (``models.steps``, DTensor placements from
``models.sharding``), and one step runs on arguments that are DTensors of
one rank's shards. A dispatch mode (``CellCounter``) reads that rank's
local ops as DTensor issues them, and gives per cell:

  * ``memory`` — ``argument_size_in_bytes`` (the arguments' local shard
    bytes), ``output_size_in_bytes`` (outputs in new storage),
    ``alias_size_in_bytes`` (outputs that are arguments written in place:
    the train state, a decode cache), ``temp_size_in_bytes`` (the peak of
    live storage less arguments and new outputs), and
    ``generated_code_size_in_bytes`` = 0;
  * ``flops`` — per device, from the local ops (``torch.utils.flop_counter``
    formulas; the kernels' own from ``kernels._ops``); ``flops_global`` —
    the DTensor ops' count at global shapes (a program of per-rank tensors,
    the cosmosann cell: the local count times the ranks);
  * ``bytes_accessed`` — operand plus result bytes of every local op that
    is not a view;
  * ``collectives`` — {count, bytes} per kind (all-gather / all-reduce /
    reduce-scatter / all-to-all / collective-permute), from the
    ``_c10d_functional`` / ``_dtensor`` ops; bytes are each one's per-rank
    result bytes, as the reference's HLO parse counts them;
  * ``compile_s`` — the seconds the trace took; ``reshards`` — ops DTensor
    could not shard, run on replicated inputs (``ReplicateFallback``);
    ``replicated`` — parameters and cache leaves whose shards a fallback
    or a reshape gathered. A cell with any such leaf fails: its bytes
    would not be the sharded layout's.

DTensor's sharding propagation runs ops of its own at global shapes under
the same fake mode; the counter skips them (they run inside
``_sharding_prop.py``), which is also why it keeps its own storage count
rather than ``MemTracker``'s: that tracker cannot tell those temporaries
from the step's under an ambient fake mode.

The variant plan (L1/L2 and, for zamba2, M1/M2/A1/A2 with a reduced
sequence) is the reference's. The eager counter sees every layer, so here
it is a consistency check: F(full) = F(L1) + (L−1)·(F(L2) − F(L1)) for a
uniform non-SSM arch. A cell that raises is recorded with ``ok: false``,
``error`` and ``traceback`` (cell failures are data); the summary's exit
code is 1 if any cell failed.

Results go to results/dryrun_torch/<arch>__<shape>__<mesh>.json,
incrementally (reruns skip finished cells unless ``--force``). The paper's
own workload (``--arch cosmosann``) traces the distributed vector search.
Nothing here runs at import: no environment variable, no process group.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import signal
import sys
import time
import traceback
import weakref
from typing import Callable, Optional

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_IDS, SHAPES, cell_supported, get_config, input_specs
from ..configs import cosmosann as cosmos_cfg
from ..models import model as M
from ..models import sharding as sh
from ..models import steps as steps_mod
from ..models.config import ModelConfig
from ..partition.fanout import distributed_search_fn
from ..train.optimizer import OptConfig, init_opt_state
from . import mesh as meshmod

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
# a collective op's name → its kind (first match)
_COLLECTIVE_NAMES = (
    ("all_gather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_reduce", "all-reduce"),
    ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"),
)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor", "c10d")


def collective_kind(func) -> Optional[str]:
    """The collective kind of an op, or None for a computation."""
    packet = str(func.overloadpacket)
    ns, _, name = packet.partition(".")
    if ns not in _COLLECTIVE_NAMESPACES or name.startswith("wait"):
        return None
    for key, kind in _COLLECTIVE_NAMES:
        if key in name:
            return kind
    return None


# ops that compute and allocate nothing (a device query, a collective's wait)
_NO_WORK = (torch.ops.prim.device.default, torch.ops._c10d_functional.wait_tensor.default)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _storage(t: torch.Tensor):
    return t.untyped_storage()


def _in_sharding_propagation() -> bool:
    """True inside DTensor's sharding propagation (its own ops at global
    shapes, which no rank runs)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class CellCounter(TorchDispatchMode):
    """Counts one rank's work: FLOPs, bytes accessed, collectives and live
    storage of the local ops (a DTensor op is let through to DTensor, which
    issues the local ops this mode then sees)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_global = 0
        self.bytes_accessed = 0
        self.collectives = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_OPS}
        self.current = 0
        self.peak = 0
        self._live: dict = {}  # id(storage) → (weakref, bytes)

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed (a tensor on the
        meta device, a stand-in for shapes only, holds none)."""
        t = _local(t)
        if t.device.type == "meta":
            return
        st = _storage(t)
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            if self._live.pop(key, None) is not None:
                self.current -= n

        self._live[key] = (weakref.ref(st, freed), n)
        self.current += n
        self.peak = max(self.peak, self.current)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _NO_WORK:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                self.flops_global += _global_flops(formula, func, args, kwargs)
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        kind = collective_kind(func)
        outs = [o for o in pytree.tree_leaves(out) if isinstance(o, torch.Tensor)]
        if kind is not None:
            rec = self.collectives[kind]
            rec["count"] += 1
            rec["bytes"] += sum(_nbytes(o) for o in outs)
        else:
            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            if not func.is_view:
                ins = [a for a in pytree.tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
                self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for o in outs:
            self.track(o)
        return out


def _global_flops(formula, func, args, kwargs) -> int:
    """The op's FLOPs at its DTensor arguments' global shapes (the output's
    shape, which few formulas read, from a meta run where they do)."""
    try:
        return int(formula(*args, **kwargs, out_val=None))
    except (TypeError, AttributeError, IndexError):
        pass

    def meta(a):
        if isinstance(a, torch.Tensor):
            return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device="meta")
        return a

    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        out = func(*pytree.tree_map(meta, args), **pytree.tree_map(meta, kwargs))
    return int(formula(*args, **kwargs, out_val=out))


def _args_bytes(tree) -> int:
    seen, total = set(), 0
    for t in pytree.tree_leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        if isinstance(t, torch.Tensor):
            st = _storage(_local(t))
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


def _leaves(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def trace(build: Callable, tag: str, want_memory: bool) -> dict:
    """Run ``build()`` -> (fn, args, its StepBundle or None) and one
    ``fn(*args)`` under a fresh ``FakeTensorMode`` and a ``CellCounter``;
    returns the record."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    counter = CellCounter()
    with FakeTensorMode():
        fn, args, bundle = build()
        arg_leaves = _leaves(args)
        for a in arg_leaves:
            counter.track(a)
        arg_storages = {id(_storage(_local(a))) for a in arg_leaves}
        args_bytes = _args_bytes(arg_leaves)
        counter.peak = counter.current
        with counter:
            out = fn(*args)
        new_out = alias = 0
        seen = set()
        for o in _leaves(out):
            st = _storage(_local(o))
            if id(st) in seen:
                continue
            seen.add(id(st))
            if id(st) in arg_storages:
                alias += st.nbytes()
            else:
                new_out += st.nbytes()
        del out
    rec: dict = {"tag": tag, "compile_s": round(time.time() - t0, 2),
                 "flops": counter.flops,
                 "flops_global": counter.flops_global,
                 "bytes_accessed": counter.bytes_accessed,
                 "collectives": counter.collectives,
                 "reshards": dict(getattr(bundle, "reshards", None) or {}),
                 "replicated": dict(getattr(bundle, "replicated", None) or {})}
    if want_memory:
        rec["memory"] = {
            "argument_size_in_bytes": args_bytes,
            "output_size_in_bytes": new_out,
            "temp_size_in_bytes": max(0, counter.peak - args_bytes - new_out),
            "alias_size_in_bytes": alias,
            "generated_code_size_in_bytes": 0,
        }
    return rec


def _variant_cfg(cfg: ModelConfig, num_layers: int = None, unroll: bool = False,
                 pattern_kind: str = None) -> ModelConfig:
    """Cost-extraction variants: L layers of one kind, every layer its own
    segment and every chunk loop unrolled (the port loops in Python either
    way; the reference needs it for its while-body-once cost analysis)."""
    kw: dict = {}
    if num_layers is not None:
        kw["num_layers"] = num_layers
        if pattern_kind is not None:
            kw["block_pattern"] = (pattern_kind,) * num_layers
        elif cfg.block_pattern:
            kw["block_pattern"] = cfg.block_pattern[:num_layers]
    if unroll:
        kw["force_unroll"] = True
        if cfg.ssm is not None:
            kw["ssm"] = dataclasses.replace(cfg.ssm, unroll_chunks=True)
    return dataclasses.replace(cfg, **kw)


# production trains always microbatch at global_batch 256: activations and
# the (B,S,V) loss block shrink ×ACCUM
TRAIN_ACCUM = 4

# step-level knobs applied to every trace of a cell. Keys: remat
# ('full'|'dots'|'none'), accum (int), cfg (fn(ModelConfig) -> ModelConfig).
OVERRIDES: dict = {}


def _state_args(cfg: ModelConfig, mesh, opt_cfg: OptConfig):
    """The train state as DTensors of one rank's shards (no values)."""
    shapes = M.param_shapes(cfg)
    model = steps_mod.distribute_model(shapes, steps_mod.param_shardings(shapes, cfg, mesh),
                                       make=sh.empty_dtensor)
    opt = init_opt_state(list(model.parameters()), opt_cfg)
    step = sh.empty_dtensor(opt.step, steps_mod._shard_of(mesh, ()), zero=True)
    return steps_mod.TrainState(model, opt._replace(step=step))


def _build_step(cfg: ModelConfig, shape, mesh, seq_override: int = None):
    """(fn, args, bundle) of one step of ``cfg`` at ``shape`` on ``mesh``."""
    sh_ = shape if seq_override is None else dataclasses.replace(shape, seq_len=seq_override)
    if OVERRIDES.get("cfg"):
        cfg = OVERRIDES["cfg"](cfg)
    specs = input_specs(cfg, sh_)
    if sh_.kind == "train":
        opt_cfg = OptConfig()
        bundle = steps_mod.make_train_step(
            cfg, mesh, specs, opt_cfg,
            accum=OVERRIDES.get("accum", TRAIN_ACCUM),
            remat=OVERRIDES.get("remat", "full"),
        )
        batch = {k: sh.empty_dtensor(v, bundle.arg_shardings[1][k]) for k, v in specs.items()}
        return bundle.fn, (_state_args(cfg, mesh, opt_cfg), batch), bundle
    params = M.param_shapes(cfg)
    model = steps_mod.distribute_model(params, steps_mod.param_shardings(params, cfg, mesh),
                                       make=sh.empty_dtensor)
    if sh_.kind == "prefill":
        bundle = steps_mod.make_prefill_step(cfg, mesh, specs, s_max=sh_.seq_len)
        batch = {k: sh.empty_dtensor(v, bundle.arg_shardings[1][k]) for k, v in specs.items()}
        return bundle.fn, (model, batch), bundle
    bundle = steps_mod.make_decode_step(cfg, mesh, batch=sh_.global_batch, s_max=sh_.seq_len)
    _, _, tok, _ = bundle.arg_shapes
    cache = steps_mod.sharded_cache(cfg, sh_.global_batch, sh_.seq_len, torch.bfloat16, mesh)
    tokens = sh.empty_dtensor(tok, bundle.arg_shardings[2])
    # the cache holds every position but the last: the step writes the last
    return bundle.fn, (model, cache, tokens, sh_.seq_len - 1), bundle


def fake_group(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks
    (a fake group of another size is replaced; a real one raises)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run needs a process of its own: a real group is running")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    meshmod.start_process_group("fake", world_size=world_size)


def production_mesh(mesh_name: str):
    """The production mesh ("single" or "multi") over a fake group of its
    size, on the host's CPU."""
    multi = mesh_name == "multi"
    shape, _ = meshmod.production_shape(multi)
    fake_group(math.prod(shape))
    return meshmod.make_production_mesh(multi_pod=multi, device="cpu")


class CellTimeout(Exception):
    """A cell's trace ran past its time limit."""


@contextlib.contextmanager
def _time_limit(seconds: float):
    """Raise CellTimeout in this (main) thread after ``seconds`` (0: none)."""
    if not seconds:
        yield
        return

    def expire(signum, frame):
        raise CellTimeout(f"the trace ran past {seconds:.0f} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             force: bool = False, timeout_s: float = 0) -> dict:
    """Trace one cell (or read its finished record) and write its record; a
    cell whose traces run past ``timeout_s`` (0: no limit) is recorded as
    failed, with the reason."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    result: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    try:
        with _time_limit(timeout_s):
            _trace_cell(result, arch, shape_name, mesh_name)
    except Exception as e:  # noqa: BLE001 — cell failures are data
        result["ok"] = False
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
        print(f"  [{arch}|{shape_name}|{mesh_name}] FAILED: {result['error'][:300]}", flush=True)
    _write(path, result)
    return result


def _trace_cell(result: dict, arch: str, shape_name: str, mesh_name: str) -> None:
    """Fill ``result`` with the cell's records (or the reason it is skipped)."""
    mesh = production_mesh(mesh_name)
    result["devices"] = int(mesh.size())
    if arch == "cosmosann":
        result.update(_run_cosmos_cell(mesh))
        return
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        result["skipped"] = reason
        return
    result.update(_run_lm_cell(arch, cfg, shape, shape_name, mesh_name, mesh))


def _run_lm_cell(arch, cfg, shape, shape_name, mesh_name, mesh) -> dict:
    # Variant plan (the reference's):
    #   uniform non-SSM archs: L1/L2 at the real shape, so that
    #       F(full) = F(L1) + (L−1)·(F(L2) − F(L1));
    #   uniform SSM archs (rwkv6): the same at a reduced sequence
    #       S_v = 8·chunk (everything linear in S);
    #   hetero (zamba2): M1/M2 (all-mamba, reduced S_v) and A1/A2 (all-attn
    #       at the real S: attention is quadratic in S).
    variants: list = [("full", cfg, None)]
    seq_scaled = None
    if cfg.uniform and cfg.ssm is None:
        variants.append(("L1", _variant_cfg(cfg, 1, unroll=True), None))
        variants.append(("L2", _variant_cfg(cfg, 2, unroll=True), None))
    elif cfg.uniform:  # rwkv6-style pure SSM
        if shape.kind in ("train", "prefill"):
            seq_scaled = min(shape.seq_len, 8 * cfg.ssm.chunk)
        variants.append(("L1", _variant_cfg(cfg, 1, unroll=True), seq_scaled))
        variants.append(("L2", _variant_cfg(cfg, 2, unroll=True), seq_scaled))
    else:  # zamba2 hybrid
        if shape.kind in ("train", "prefill"):
            seq_scaled = min(shape.seq_len, 8 * cfg.ssm.chunk)
        m1 = _variant_cfg(cfg, 1, unroll=True, pattern_kind="mamba2")
        m2 = _variant_cfg(cfg, 2, unroll=True, pattern_kind="mamba2")
        a1 = _variant_cfg(cfg, 1, unroll=True, pattern_kind="attn")
        a2 = _variant_cfg(cfg, 2, unroll=True, pattern_kind="attn")
        variants += [("M1", m1, seq_scaled), ("M2", m2, seq_scaled),
                     ("A1", a1, None), ("A2", a2, None)]
    out: dict = {"seq_scaled": seq_scaled,
                 "accum": TRAIN_ACCUM if shape.kind == "train" else 1, "records": []}
    for tag, vcfg, seq in variants:
        rec = trace(lambda vcfg=vcfg, seq=seq: _build_step(vcfg, shape, mesh, seq),
                    tag, want_memory=(tag == "full"))
        out["records"].append(rec)
        print(f"  [{arch}|{shape_name}|{mesh_name}|{tag}] flops={rec['flops']:.3e} "
              f"trace={rec['compile_s']}s reshards={rec['reshards']} "
              f"replicated={rec['replicated']}", flush=True)
    replicated = sorted({n for r in out["records"] for n in r["replicated"]})
    out["ok"] = not replicated
    if replicated:
        out["error"] = f"parameters or cache leaves replicated: {', '.join(replicated[:8])}"
    out["model_params"] = cfg.param_count()
    out["active_params"] = cfg.active_param_count()
    return out


def _cosmos_args(cfg, mesh, shard_axes: tuple[str, ...]):
    """The shard-stacked arrays as DTensors sharded on dim 0 over
    ``shard_axes`` (one rank's shards each), the queries replicated."""
    specs = cosmos_cfg.shard_specs(cfg, int(mesh.size()))
    names = ("neighbors", "codes", "versions", "live", "vectors", "doc_ids", "medoid",
             "codebooks")
    args = [sh.empty_dtensor(specs[n], sh.Sharding(mesh, sh.placements(
        (shard_axes,) + (None,) * (specs[n].ndim - 1), mesh))) for n in names]
    args.append(sh.empty_dtensor(specs["queries"], sh.Sharding(mesh, sh.placements((), mesh))))
    return args


def cosmos_search_fn(cfg, mesh):
    """The cosmosann cell's step: ``distributed_search_fn`` over every mesh
    axis at the configuration's L, k, W and the reference's hop bound."""
    return distributed_search_fn(
        mesh, L=cfg.L_search, k=cfg.k, metric=cfg.metric,
        shard_axes=tuple(mesh.mesh_dim_names),
        max_hops=-(-2 * cfg.L_search // cfg.beam_width), beam_width=cfg.beam_width)


def _run_cosmos_cell(mesh) -> dict:
    cfg = cosmos_cfg.config()
    shard_axes = tuple(mesh.mesh_dim_names)
    fn = cosmos_search_fn(cfg, mesh)
    rec = trace(lambda: (fn, _cosmos_args(cfg, mesh, shard_axes), None), "full",
                want_memory=True)
    rec["flops_global"] = rec["flops"] * int(mesh.size())  # per-rank tensors, no DTensor op
    return {"ok": True, "records": [rec], "workload": dataclasses.asdict(cfg)}


def _write(path: str, result: dict):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1)
    os.replace(tmp, path)


def _run_one(cell: tuple, out: str, force: bool, timeout_s: float) -> dict:
    arch, shp, mesh_name = cell
    print(f"=== {arch} × {shp} × {mesh_name} ===", flush=True)
    return run_cell(arch, shp, mesh_name, out, force=force, timeout_s=timeout_s)


# a cell's relative trace time, to start the longest first (train steps
# trace forward and backward four times; MoE layers cost the most)
_KIND_COST = {"train_4k": 8, "prefill_32k": 2, "decode_32k": 1, "long_500k": 1, "query": 0}


def _cost(cell: tuple) -> int:
    arch, shp, _ = cell
    return _KIND_COST.get(shp, 1) * (4 if "moe" in arch or "deepseek" in arch else 1)


_PEAK = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes")


def table(out_dir: str) -> str:
    """The records in ``out_dir`` as a markdown table: status, one device's
    GiB (argument + output + temp; an aliased output is an argument), to
    hold against the H100's 80 GB, trace seconds (every variant), fallback
    ops and replicated leaves."""
    rows = ["| arch | shape | mesh | status | GiB / device | trace s | reshards | replicated |",
            "|---|---|---|---|---|---|---|---|"]
    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(out_dir, name)) as f:
            r = json.load(f)
        recs = r.get("records", [])
        mem = recs[0].get("memory") if recs else None
        gib = "" if not mem else f"{sum(mem[k] for k in _PEAK) / 2**30:.2f}"
        status = "skip" if r.get("skipped") else ("ok" if r.get("ok") else
                                                  "fail: " + r.get("error", "")[:60])
        reshards = sum(sum(x.get("reshards", {}).values()) for x in recs)
        replicated = sorted({n for x in recs for n in x.get("replicated", {})})
        rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {status} | {gib} | "
                    f"{sum(x['compile_s'] for x in recs):.1f} | {reshards} | "
                    f"{len(replicated)} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all",
                    help=f"arch id, 'all', or comma list; known: {ARCH_IDS + ['cosmosann']}")
    ap.add_argument("--shape", default="all",
                    help="train_4k|prefill_32k|decode_32k|long_500k|all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced side by side, each in a process of its own")
    ap.add_argument("--cell-timeout", type=float, default=0,
                    help="seconds a cell may trace before it is recorded as failed (0: no limit)")
    ap.add_argument("--table", action="store_true",
                    help="print the records in --out as a markdown table and exit")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return 0

    archs = (ARCH_IDS + ["cosmosann"]) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    cells = [(arch, shp, mesh_name) for arch in archs
             for shp in (["query"] if arch == "cosmosann" else shapes) for mesh_name in meshes]
    run = functools.partial(_run_one, out=args.out, force=args.force,
                            timeout_s=args.cell_timeout)
    if args.jobs > 1:  # a process a cell (one default group each), the costliest first
        import multiprocessing as mp
        order = sorted(cells, key=_cost, reverse=True)
        with mp.get_context("spawn").Pool(args.jobs, maxtasksperchild=1) as pool:
            done = dict(zip(order, pool.map(run, order, chunksize=1)))
        results = [done[c] for c in cells]
    else:
        results = [run(c) for c in cells]
    summary = []
    for (arch, shp, mesh_name), r in zip(cells, results):
        status = ("SKIP: " + r["skipped"]) if r.get("skipped") else (
            "OK" if r.get("ok") else "FAIL")
        summary.append((arch, shp, mesh_name, status))
    print("\n=== DRY-RUN SUMMARY ===")
    bad = 0
    for arch, shp, mesh_name, status in summary:
        print(f"{arch:24s} {shp:12s} {mesh_name:6s} {status}")
        bad += status == "FAIL"
    print(f"{len(summary)} cells, {bad} failures")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
