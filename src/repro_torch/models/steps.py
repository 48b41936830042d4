"""Step factories: train / prefill / decode (the port of
``repro.models.steps``).

Each factory returns a ``StepBundle``: the step function, stand-ins for
every argument as tensors on ``device="meta"`` (shapes and dtypes, no
storage: what the reference's ``ShapeDtypeStruct`` trees give a dry-run),
the arguments' and outputs' shardings, and, for the train step, ``init``,
which builds the real initial state.

With a ``mesh`` (a ``DeviceMesh`` with the reference's axis names) the
factories shard as the reference's do: ``init`` distributes the
parameters, both AdamW moments and the step as DTensors of
``models.sharding.param_specs``; the steps distribute a plain batch by
``batch_spec`` and caches by ``cache_specs``; each gradient is brought to
its parameter's placements (the reduction GSPMD inserts) before AdamW.
``arg_shardings`` / ``out_shardings`` hold ``sharding.Sharding``s, the
train state's keyed as ``state_tree`` is (what ``train.checkpoint.restore``
takes). Without a mesh (``mesh=None``, or the legacy calls that pass the
batch shapes, or the batch size, where the mesh goes) the steps run on one
``device`` (the card unless the caller asks otherwise) and both shardings
are None.

The train step updates its state in place (parameters and moments), the
port's counterpart of the reference's donated state. With ``accum`` > 1
the batch is split into ``accum`` micro-batches along its leading axis and
their gradients are summed in f32, as the reference sums them into f32
zeros, then averaged. On a mesh each rank splits its own rows, so a
micro-batch holds rows of every rank: the same mean loss and gradients
up to rounding, with no data moved.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor

from ..device import DeviceLike, resolve_device
from ..train.optimizer import OptConfig, OptState, adamw_update, init_opt_state
from . import model as M
from .config import ModelConfig
from .sharding import (ReplicateFallback, Sharding, batch_spec, cache_specs, distribute, empty_dtensor,
                       param_specs, placements, tree_map)


class TrainState(NamedTuple):
    params: M.Model
    opt: OptState  # one moment per parameter, in ``params.parameters()`` order


@dataclasses.dataclass
class StepBundle:
    fn: Callable  # the step
    arg_shapes: tuple  # meta-tensor stand-ins for fn's arguments
    arg_shardings: Any = None  # per argument: a tree of Shardings (None without a mesh)
    out_shardings: Any = None
    init: Optional[Callable] = None  # builds the real initial state
    # on a mesh: ops DTensor could not shard, run on replicated inputs (op → count)
    reshards: Optional[dict] = None
    # on a mesh: parameters and cache leaves whose shards were gathered by a
    # fallback or a reshape (name → count; ``ReplicateFallback.replicated``)
    replicated: Optional[dict] = None


@contextlib.contextmanager
def _on_mesh(fallback: ReplicateFallback, mesh=None):
    """DTensor ops take plain tensors (positions, masks, scalars) as
    replicated and, on a mesh of more than one rank, reshard through
    ``fallback`` where no rule fits (on one rank every shard is whole, so
    nothing reshards there)."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), (fallback if mesh is None or mesh.size() > 1
                                  else contextlib.nullcontext()):
        yield


def _shard_of(mesh, spec) -> Sharding:
    return Sharding(mesh, placements(spec, mesh))


def _batch_shardings(batch_shapes: dict, mesh) -> dict:
    return {k: _shard_of(mesh, batch_spec(mesh, v.shape[0], v.ndim))
            for k, v in batch_shapes.items()}


def _put(t, sharding: Optional[Sharding]):
    """A plain tensor distributed by ``sharding``; a DTensor (or no
    sharding) passes through."""
    if sharding is None or isinstance(t, DTensor) or not isinstance(t, torch.Tensor):
        return t
    return distribute(t, sharding)


def param_shardings(model: M.Model, cfg: ModelConfig, mesh) -> dict[str, Sharding]:
    """Each parameter's Sharding, keyed by its name (per layer)."""
    return {k: _shard_of(mesh, s) for k, s in param_specs(model, cfg, mesh).items()}


def distribute_model(model: M.Model, shardings: dict[str, Sharding], make=distribute) -> M.Model:
    """Replace every parameter of ``model`` by ``make(param, sharding)`` (a
    DTensor), in place; returns the model."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner).register_parameter(
            leaf, torch.nn.Parameter(make(p, shardings[name]), requires_grad=p.requires_grad))
    return model


def state_shardings(model: M.Model, cfg: ModelConfig, mesh) -> dict:
    """The train state's Shardings keyed as ``state_tree`` keys the state:
    a block leaf's placements are its layer's with the stack's leading axis
    prepended; the step is replicated."""
    specs = param_specs(model, cfg, mesh)
    tree: dict = {"blocks": [{} for _ in M.segments(cfg)]}
    for (name, _), (path, j) in zip(model.named_parameters(),
                                    M._reference_slots(model, cfg).values()):
        M._put(tree, path, _shard_of(mesh, specs[name] if j is None else (None, *specs[name])))
    return {"params": tree, "opt": {"m": tree, "v": tree, "step": _shard_of(mesh, ())}}


def state_tree(state: TrainState, cfg: ModelConfig) -> dict:
    """The state keyed as the reference's ``TrainState`` pytree is
    (``params/blocks/0/mixer/wq`` stacked, ``opt/m/...``, ``opt/v/...``,
    ``opt/step``): what a checkpoint holds."""
    model, opt = state
    return {"params": M.reference_tree(model, cfg),
            "opt": {"m": M.reference_tree(model, cfg, opt.m),
                    "v": M.reference_tree(model, cfg, opt.v), "step": opt.step}}


def load_state_tree(state: TrainState, cfg: ModelConfig, tree: dict) -> TrainState:
    """Copy a ``state_tree``-keyed tree (e.g. restored from a checkpoint)
    into ``state`` in place; returns the state with the tree's step."""
    model, opt = state
    M.load_reference_tree(model, cfg, tree["params"])
    M.load_reference_tree(model, cfg, tree["opt"]["m"], opt.m)
    M.load_reference_tree(model, cfg, tree["opt"]["v"], opt.v)
    step = tree["opt"]["step"]
    if not isinstance(step, DTensor):
        step = torch.as_tensor(step, dtype=torch.int32).to(opt.step.device)
        if isinstance(opt.step, DTensor):
            step = DTensor.from_local(step, opt.step.device_mesh, opt.step.placements,
                                      run_check=False)
    return TrainState(model, opt._replace(step=step))


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def _micro(v: torch.Tensor, accum: int, i: int) -> torch.Tensor:
    """Micro-batch ``i`` of ``accum``: rows [i·n, (i+1)·n) of the batch, or
    of each rank's shard of it on a mesh."""
    if isinstance(v, DTensor):
        local = v.to_local()
        n = local.shape[0] // accum
        return DTensor.from_local(local[i * n:(i + 1) * n], v.device_mesh, v.placements,
                                  run_check=False)
    return v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor's full value)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(
    cfg: ModelConfig,
    mesh=None,
    batch_shapes: dict = None,
    opt_cfg: OptConfig = OptConfig(),
    remat: str = "full",
    accum: int = 1,
    seed: int = 0,
    device: DeviceLike = None,
) -> StepBundle:
    """fn(state, batch) -> (state, {"loss", "grad_norm", "lr"}), the batch's
    tensors on the state's device (on a mesh: plain tensors, distributed
    by ``batch_spec``, or DTensors). ``init`` draws the weights from
    ``torch.Generator(device).manual_seed(seed)`` (on a mesh: on each
    rank's device, the same on every rank) and, on a mesh, distributes
    them. A call without a mesh may pass ``batch_shapes`` and ``opt_cfg``
    where ``mesh`` and ``batch_shapes`` go."""
    if isinstance(mesh, dict):  # (cfg, batch_shapes[, opt_cfg]): no mesh
        mesh, batch_shapes, opt_cfg = None, mesh, (
            opt_cfg if batch_shapes is None else batch_shapes)
    dev = _mesh_device(mesh) if mesh is not None else resolve_device(device)
    shapes = M.param_shapes(cfg)
    state_shapes = TrainState(shapes, init_opt_state(list(shapes.parameters()), opt_cfg))
    psh = state_sh = batch_sh = None
    fallback = ReplicateFallback()
    if mesh is not None:
        psh = param_shardings(shapes, cfg, mesh)
        state_sh = state_shardings(shapes, cfg, mesh)
        batch_sh = _batch_shardings(batch_shapes, mesh)

    def grads_of(model: M.Model, params: list, batch: dict):
        loss, _ = M.loss_fn(model, cfg, batch, remat)
        grads = torch.autograd.grad(loss, params)
        if mesh is not None:  # the reduction the reference's GSPMD inserts
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if tuple(g.placements) != tuple(p.placements) else g
                     for g, p in zip(grads, params)]
        return loss.detach(), grads

    def step(state: TrainState, batch: dict):
        model = state.params
        params = list(model.parameters())
        if mesh is not None:
            batch = {k: _put(v, batch_sh.get(k)) for k, v in batch.items()}
            fallback.watch(model.named_parameters())
        with (_on_mesh(fallback, mesh) if mesh is not None else contextlib.nullcontext()):
            if accum > 1:
                gsum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
                lsum = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(accum):
                    mb = {k: _micro(v, accum, i) for k, v in batch.items()}
                    loss, grads = grads_of(model, params, mb)
                    for s_, g in zip(gsum, grads):
                        s_.add_(g)
                    lsum = lsum + loss
                grads = [s_ / accum for s_ in gsum]
                loss = lsum / accum
            else:
                loss, grads = grads_of(model, params, batch)
            opt, metrics = adamw_update(params, grads, state.opt, opt_cfg,
                                        M.reference_ndims(model, cfg))
            metrics = {"loss": _plain(loss), **{k: _plain(v) for k, v in metrics.items()}}
        return TrainState(model, opt), metrics

    def init() -> TrainState:
        model = M.init_params(torch.Generator(dev).manual_seed(seed), cfg, dev)
        if mesh is not None:
            distribute_model(model, psh)
        opt = init_opt_state(list(model.parameters()), opt_cfg)
        if mesh is not None:
            opt = opt._replace(step=_put(opt.step, _shard_of(mesh, ())))
        return TrainState(model, opt)

    return StepBundle(fn=step, arg_shapes=(state_shapes, batch_shapes),
                      arg_shardings=None if mesh is None else (state_sh, batch_sh),
                      out_shardings=None if mesh is None else (state_sh, None), init=init,
                      reshards=None if mesh is None else fallback.ops,
                      replicated=None if mesh is None else fallback.replicated)


def _mesh_device(mesh) -> torch.device:
    from ..launch.mesh import mesh_device
    return mesh_device(mesh)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def sharded_cache(cfg: ModelConfig, batch: int, s_max: int, dtype, mesh) -> list:
    """``M.init_cache``'s zeros as DTensors of ``cache_specs``, each rank
    allocating only its shard."""
    return _zip_map(lambda t, s: empty_dtensor(t, s, zero=True),
                    M.cache_shapes(cfg, batch, s_max, dtype),
                    _cache_shardings(cfg, batch, s_max, dtype, mesh))


def _zip_map(fn, cache: list, shardings: list) -> list:
    """``fn(leaf, its Sharding)`` over a cache's leaves."""
    return [{k: fn(v, s[k]) for k, v in c.items()} if isinstance(c, dict)
            else type(c)(*(fn(v, sv) for v, sv in zip(c, s))) for c, s in zip(cache, shardings)]


def _cache_shardings(cfg: ModelConfig, batch: int, s_max: int, dtype, mesh) -> list:
    shapes = M.cache_shapes(cfg, batch, s_max, dtype)
    return tree_map(lambda s: _shard_of(mesh, s), cache_specs(shapes, cfg, mesh, batch),
                    is_leaf=lambda x: isinstance(x, tuple) and not hasattr(x, "_fields"))


def _named_state(model: M.Model, cache: list) -> list:
    """(name, tensor) of every parameter and cache leaf."""
    named = list(model.named_parameters())
    for i, c in enumerate(cache):
        items = c.items() if isinstance(c, dict) else zip(c._fields, c)
        named += [(f"cache.{i}.{k}", v) for k, v in items]
    return named


def make_prefill_step(
    cfg: ModelConfig,
    mesh=None,
    batch_shapes: dict = None,
    s_max: int = None,
    cache_dtype=torch.bfloat16,
    seed: int = 0,
    device: DeviceLike = None,
) -> StepBundle:
    """fn(model, batch) -> (last-position logits, a new cache of s_max
    positions holding the prompt); on a mesh the cache is made sharded by
    ``cache_specs``. A call without a mesh may pass (batch_shapes, s_max,
    cache_dtype) where (mesh, batch_shapes, s_max) go."""
    if isinstance(mesh, dict):  # (cfg, batch_shapes, s_max[, cache_dtype]): no mesh
        mesh, batch_shapes, s_max, cache_dtype = None, mesh, batch_shapes, (
            cache_dtype if s_max is None else s_max)
    B = next(iter(batch_shapes.values())).shape[0]
    shapes = M.param_shapes(cfg)
    if mesh is None:
        dev = resolve_device(device)

        def step(model: M.Model, batch: dict):
            return M.prefill(model, cfg, batch, M.init_cache(cfg, B, s_max, cache_dtype, dev))

        return StepBundle(fn=step, arg_shapes=(shapes, batch_shapes))

    psh = param_shardings(shapes, cfg, mesh)
    batch_sh = _batch_shardings(batch_shapes, mesh)
    cache_sh = _cache_shardings(cfg, B, s_max, cache_dtype, mesh)

    fallback = ReplicateFallback()

    def step(model: M.Model, batch: dict):
        batch = {k: _put(v, batch_sh.get(k)) for k, v in batch.items()}
        cache = sharded_cache(cfg, B, s_max, cache_dtype, mesh)
        fallback.watch(_named_state(model, cache))
        with _on_mesh(fallback, mesh):
            return M.prefill(model, cfg, batch, cache)

    return StepBundle(fn=step, arg_shapes=(shapes, batch_shapes), arg_shardings=(psh, batch_sh),
                      out_shardings=(_shard_of(mesh, batch_spec(mesh, B, 3)), cache_sh),
                      reshards=fallback.ops, replicated=fallback.replicated)


def make_decode_step(
    cfg: ModelConfig,
    mesh=None,
    batch: int = None,
    s_max: int = None,
    cache_dtype=torch.bfloat16,
    seed: int = 0,
    device: DeviceLike = None,
) -> StepBundle:
    """fn(model, cache, tokens, cache_len) -> (logits, the cache written in
    place), on the model's device; tokens (batch, 1) ids, or (batch, 1,
    d_model) frames. On a mesh plain tokens and caches are distributed by
    ``batch_spec`` and ``cache_specs``. A call without a mesh may pass
    (batch, s_max, cache_dtype) where (mesh, batch, s_max) go."""
    if isinstance(mesh, int):  # (cfg, batch, s_max[, cache_dtype]): no mesh
        mesh, batch, s_max, cache_dtype = None, mesh, batch, (
            cache_dtype if s_max is None else s_max)
    if cfg.input_mode == "frames":
        tok = torch.empty((batch, 1, cfg.d_model), dtype=torch.bfloat16, device="meta")
    else:
        tok = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    length = torch.empty((), dtype=torch.int32, device="meta")
    shapes = (M.param_shapes(cfg), M.cache_shapes(cfg, batch, s_max, cache_dtype), tok, length)
    if mesh is None:
        def step(model: M.Model, cache, tokens, cache_len):
            return M.decode_step(model, cfg, tokens, cache, int(cache_len))

        return StepBundle(fn=step, arg_shapes=shapes)

    psh = param_shardings(shapes[0], cfg, mesh)
    cache_sh = _cache_shardings(cfg, batch, s_max, cache_dtype, mesh)
    tok_sh = _shard_of(mesh, batch_spec(mesh, batch, tok.ndim))
    len_sh = _shard_of(mesh, ())

    fallback = ReplicateFallback()

    def step(model: M.Model, cache, tokens, cache_len):
        cache = _zip_map(_put, cache, cache_sh)
        fallback.watch(_named_state(model, cache))
        with _on_mesh(fallback, mesh):
            return M.decode_step(model, cfg, _put(tokens, tok_sh), cache, int(_plain(cache_len))
                                 if isinstance(cache_len, torch.Tensor) else int(cache_len))

    return StepBundle(fn=step, arg_shapes=shapes,
                      arg_shardings=(psh, cache_sh, tok_sh, len_sh),
                      out_shardings=(_shard_of(mesh, batch_spec(mesh, batch, 3)), cache_sh),
                      reshards=fallback.ops, replicated=fallback.replicated)
