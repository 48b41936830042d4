"""Sharding rules: parameters, activations, caches → specs → DTensor
placements (the port of ``repro.models.sharding``).

Scheme (MaxText-style 2D), the reference's word for word:
  * `data` axis: FSDP — every ≥2D weight shards its d_model-ish (first big)
    dimension over `data`;
  * `model` axis: TP — heads / ffn / vocab (last big) dimension over `model`;
  * MoE experts shard their leading E dimension over `model` (EP);
  * `pod` axis (multi-pod mesh): pure DP — composes with `data` on the batch
    dimension only, so cross-pod traffic is exactly the gradient reduction;
  * decode KV caches shard batch over `data` and the *sequence* dimension
    over `model` (split-KV — the only layout that fits 32k–500k caches in
    device memory);
  * every dim only shards when divisible by the axis size (e.g. hubert's
    vocab of 504 stays replicated on its V dim rather than failing).

A spec is a tuple with one entry per tensor dim — None, an axis name, or a
tuple of axis names — the reference's ``PartitionSpec`` without JAX. A
mesh is anything with ``mesh_dim_names`` and ``shape``: a ``DeviceMesh``,
or ``launch.mesh.AbstractMesh`` to evaluate specs with no process group.
``placements(spec, mesh)`` turns a spec into DTensor placements: a mesh dim
named in a tensor dim's entry becomes ``Shard(dim)``, every other mesh dim
``Replicate()``; a multi-axis entry ("pod", "data") shards that tensor dim
over both mesh dims, pod outer, JAX's major-to-minor order.

The port keeps one ``Block`` per layer where the reference stacks a
segment, so ``param_specs(model, cfg, mesh)`` gives each per-layer tensor
the reference's spec with the leading stacked ``None`` dropped. Caches keep
the reference's stacked leaves, so ``cache_specs`` applies unchanged.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode

from .config import ModelConfig

Spec = tuple  # one entry per tensor dim: None | axis name | tuple of axis names


class Sharding(NamedTuple):
    """A mesh and one placement per mesh dim (``NamedSharding``'s role)."""

    mesh: Any
    placements: tuple


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _axsize(mesh, name: str) -> int:
    names = _names(mesh)
    return mesh.shape[names.index(name)] if name in names else 1


def _fits(dim: int, mesh, name: Optional[str]) -> Optional[str]:
    if name is None or name not in _names(mesh):
        return None
    return name if dim % _axsize(mesh, name) == 0 else None


def dp_axes(mesh) -> tuple[str, ...]:
    """Batch-sharding axes: ('pod','data') on multi-pod, ('data',) otherwise."""
    return tuple(a for a in ("pod", "data") if a in _names(mesh))


def batch_spec(mesh, batch: int, ndim: int) -> Spec:
    axes = dp_axes(mesh)
    total = math.prod(_axsize(mesh, a) for a in axes)
    first = axes if batch % total == 0 else ()
    return (first if first else None, *([None] * (ndim - 1)))


def param_spec(path: str, shape: tuple[int, ...], mesh, stacked: bool) -> Spec:
    """Sharding rule for one parameter leaf.

    path: '/'-joined key path (e.g. 'blocks/0/mixer/wq'); stacked: leading L axis.
    """
    lead: list[Any] = [None] if stacked else []
    dims = shape[1:] if stacked else shape
    name = path.rsplit("/", 1)[-1]

    def spec(*entries):
        return (*lead, *entries)

    if len(dims) == 0:
        return spec()
    if len(dims) == 1:
        # norms / biases / small vectors: shard over data when divisible
        return spec(_fits(dims[0], mesh, "data"))
    if name == "embed":  # (V, dm)
        return spec(_fits(dims[0], mesh, "model"), _fits(dims[1], mesh, "data"))
    if name == "lm_head":  # (dm, V)
        return spec(_fits(dims[0], mesh, "data"), _fits(dims[1], mesh, "model"))
    if name == "router":  # (dm, E) — replicate E for stable routing math
        return spec(_fits(dims[0], mesh, "data"), None)
    if len(dims) == 3:  # MoE expert stacks (E, dm, ff) / (E, ff, dm)
        return spec(
            _fits(dims[0], mesh, "model"),
            _fits(dims[1], mesh, "data"),
            None,
        )
    if len(dims) == 2:
        if name in ("wo", "w2", "out_proj", "wuk", "wuv"):
            # output-side projections: (big, dm) — model on the input dim
            return spec(_fits(dims[0], mesh, "model"), _fits(dims[1], mesh, "data"))
        # input-side projections: (dm, big)
        return spec(_fits(dims[0], mesh, "data"), _fits(dims[1], mesh, "model"))
    return spec(*([None] * len(dims)))


def param_specs(model, cfg: ModelConfig, mesh) -> dict[str, Spec]:
    """Each parameter's spec, keyed by its name in ``model.named_parameters()``
    (in that order): the reference's rule at the parameter's path in its
    pytree (``models.model._reference_slots``), for a block leaf its stacked
    spec with the leading segment axis dropped."""
    from .model import _reference_slots  # model imports this module

    out = {}
    for (name, p), (path, j) in zip(model.named_parameters(),
                                    _reference_slots(model, cfg).values()):
        stacked = j is not None
        shape = ((1,) if stacked else ()) + tuple(p.shape)
        spec = param_spec("/".join(map(str, path)), shape, mesh, stacked)
        out[name] = spec[1:] if stacked else spec
    return out


def cache_specs(cache: Any, cfg: ModelConfig, mesh, batch: int) -> Any:
    """KV/SSM cache specs: batch over dp axes, sequence over `model`.

    Caches are lists of per-segment stacks: leaves (seg_len, B, S, ...) or
    (seg_len, B, ...); the result has the cache's structure with a spec at
    every leaf.
    """
    axes = dp_axes(mesh)
    total = math.prod(_axsize(mesh, a) for a in axes)
    b_ax = axes if batch % total == 0 else None
    lead = 1

    def leaf_spec(a):
        shape = tuple(a.shape)
        entries: list[Any] = [None] * len(shape)
        if len(shape) <= lead:
            return tuple(entries)
        entries[lead] = b_ax  # batch dim
        # sequence dim: caches (L,B,S,...) with S >= 1024 shard over model
        if len(shape) > lead + 1 and shape[lead + 1] >= 1024:
            entries[lead + 1] = _fits(shape[lead + 1], mesh, "model")
        elif len(shape) > lead + 1:
            # ssm states: (B, nh, hd, ds) — shard heads over model
            entries[lead + 1] = _fits(shape[lead + 1], mesh, "model")
        return tuple(entries)

    return tree_map(leaf_spec, cache)


def tree_map(fn, tree, is_leaf=lambda x: isinstance(x, torch.Tensor)):
    """``fn`` at every leaf of dicts, lists, tuples and NamedTuples."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    names = _names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in ((entry,) if isinstance(entry, str) else (entry or ()))]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of one dim must follow the mesh's order")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def to_shardings(specs: Any, mesh) -> Any:
    """The specs' tree with a ``Sharding`` at every spec."""
    return tree_map(lambda s: Sharding(mesh, placements(s, mesh)), specs, is_leaf=_is_spec)


def distribute(t: torch.Tensor, sharding: Sharding) -> DTensor:
    """``t`` (the whole tensor, on any device) as a DTensor of ``sharding``:
    each rank keeps its shard on the mesh's device."""
    from ..launch.mesh import mesh_device

    return distribute_tensor(t.detach().to(mesh_device(sharding.mesh)), sharding.mesh,
                             list(sharding.placements))


def local_shape(shape: tuple[int, ...], sharding: Sharding) -> tuple[int, ...]:
    """A rank's shard shape of a tensor of ``shape`` (every sharded dim
    divides, which the rules guarantee)."""
    out = list(shape)
    for size, p in zip(sharding.mesh.shape, sharding.placements):
        if isinstance(p, Shard):
            if out[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not divide by {size}")
            out[p.dim] //= size
    return tuple(out)


def empty_dtensor(t: torch.Tensor, sharding: Sharding, zero: bool = False) -> DTensor:
    """A DTensor shaped like ``t`` (e.g. a meta stand-in), uninitialised or
    zero, each rank allocating only its shard: the dry-run's arguments, a
    sharded cache."""
    from ..launch.mesh import mesh_device

    make = torch.zeros if zero else torch.empty
    local = make(local_shape(tuple(t.shape), sharding), dtype=t.dtype,
                 device=mesh_device(sharding.mesh))
    return DTensor.from_local(local, sharding.mesh, list(sharding.placements),
                              run_check=False, shape=t.shape, stride=_contiguous_stride(t.shape))


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def constrain_batch_dim(x: torch.Tensor, extra: tuple = ()) -> torch.Tensor:
    """Redistribute a DTensor to (dp_axes, *extra, None, ...): its batch dim
    sharded over the data axes, the rest as ``extra`` says or replicated.
    No-op for a plain tensor (no mesh) or when the batch dim doesn't divide —
    keeps model code mesh-free.

    Pinning activations' batch dim to the data axes stops the layers'
    inputs from staying replicated (or sharded on a feature dim) across
    the mesh after a product with a sharded weight.
    """
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    axes = dp_axes(mesh)
    if not axes:
        return x
    total = math.prod(_axsize(mesh, a) for a in axes)
    if x.ndim == 0 or x.shape[0] % total != 0:
        return x
    rest = list(extra) + [None] * (x.ndim - 1 - len(extra))
    want = placements((axes, *rest), mesh)
    return redistribute(x, list(want))


# what DTensor raises where it has no rule or plan for a layout (torch 2.11
# raises IndexError and AssertionError from its redistribution planner too)
_SHARDING_ERRORS = (RuntimeError, NotImplementedError, IndexError, AssertionError)


def _propagation_failed(e: Exception) -> bool:
    if isinstance(e, IndexError):
        return True
    msg = str(e).lower()
    return any(w in msg for w in ("propagation failed", "sharding strategy", "not supported yet",
                                  "is unsupported"))


def _replicated(x, shards_only: bool):
    if not isinstance(x, DTensor):
        return x
    want = [Replicate() if (_sharded(p) or not shards_only) else p for p in x.placements]
    return _move(x, want, autograd=False)


def _strided(p) -> bool:
    """A strided shard (``_StridedShard``: a subclass of ``Shard`` in some
    releases, not in others)."""
    return type(p).__name__ == "_StridedShard"


def _sharded(p) -> bool:
    return isinstance(p, Shard) or _strided(p)


def redistribute(x: DTensor, want: list) -> DTensor:
    """``x.redistribute`` to ``want``, differentiable. DTensor cannot
    unshard a strided shard (the layout a merge of a sharded inner dim
    leaves) of a fake tensor, as it reads index values; there, where only
    shapes and bytes exist, each such mesh dim is gathered as the
    all-gather would move it and the result's shard is made from the
    gathered bytes."""
    return _move(x, want, autograd=True)


def _move(x: DTensor, want: list, autograd: bool) -> DTensor:
    """``redistribute``; with ``autograd`` False, for use inside a dispatch
    mode (below autograd, where DTensor's autograd functions must not run):
    the local tensor is moved and a DTensor made around it directly."""
    mesh = x.device_mesh
    want = list(want)
    if list(x.placements) == want:
        return x
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._redistribute import redistribute_local_tensor

    local = x.to_local() if autograd else x._local_tensor
    strided = [i for i, p in enumerate(x.placements) if _strided(p)]
    if strided and _is_fake(local):
        import torch.distributed._functional_collectives as funcol

        gather = funcol.all_gather_tensor_autograd if autograd else funcol.all_gather_tensor
        mid = list(x.placements)
        for i in strided:
            if not isinstance(want[i], Replicate):
                raise NotImplementedError(f"strided shard to {want[i]} on a fake tensor")
            local = gather(local, x.placements[i].dim, (mesh, i))
            mid[i] = Replicate()
        if autograd:
            x = DTensor.from_local(local, mesh, mid, run_check=False, shape=x.shape,
                                   stride=x.stride())
        else:
            x = DTensor(local, DTensorSpec(mesh, tuple(mid), tensor_meta=x._spec.tensor_meta),
                        requires_grad=False)
        if list(x.placements) == want:
            return x
    if autograd:
        return x.redistribute(mesh, want)
    target = DTensorSpec(mesh, tuple(want), tensor_meta=x._spec.tensor_meta)
    return DTensor(redistribute_local_tensor(x._local_tensor, x._spec, target), target,
                   requires_grad=False)


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


_DEVICE = torch.ops.prim.device.default
# products → their rows' dim
_PRODUCTS = {torch.ops.aten.mm.default: 0, torch.ops.aten.bmm.default: 1}


def _fsdp_gathered(a: DTensor, b: DTensor, rows: int) -> DTensor:
    """``b`` with its shards over the data axes gathered wherever ``a`` has
    its rows (dim ``rows``: the batch) sharded over the same axis: a weight
    stored sharded over ``data`` (FSDP) is gathered whole for the product,
    and the rows stay where they are, as the reference's scheme computes."""
    names = tuple(a.device_mesh.mesh_dim_names)
    want = list(b.placements)
    for i, (pa, pb) in enumerate(zip(a.placements, b.placements)):
        if names[i] in ("pod", "data") and isinstance(pa, Shard) and pa.dim == rows \
                and _sharded(pb):
            want[i] = Replicate()
    return _move(b, want, autograd=False)


_RESHAPES = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
             torch.ops.aten.reshape.default)


def _resolve(shape, numel: int) -> tuple:
    shape = tuple(shape)
    if -1 in shape:
        known = math.prod(d for d in shape if d != -1)
        shape = tuple(numel // known if d == -1 else d for d in shape)
    return shape


class ReplicateFallback(TorchDispatchMode):
    """The mesh path's resharding, below autograd. While active:

    * a product (``aten.mm``, ``aten.bmm``) first reduces its rows' partial sums (as
      tensor parallelism all-reduces after a row-parallel product) and,
      where its rows are sharded over a data axis, gathers its other
      operand's shards over that axis (``_fsdp_gathered``: FSDP);
    * a reshape first has the placements it cannot carry replicated
      (``_clean_for_reshape``; the reshapes autograd and products issue
      too, forward and backward), so no strided shard forms;
    * an op DTensor cannot shard (no sharding rule, or no plan to move its
      inputs) runs on its inputs with their sharded dims replicated, then
      with every placement replicated, as GSPMD reshards where no sharded
      layout fits, and an op with no rule at all on the whole inputs' local
      tensors. ``ops`` counts each op that fell back, so a record shows
      every such all-gather. An op that writes an input in place cannot
      move that input and re-raises.

    ``replicated`` counts, by name, each time a fallback or a reshape
    gathered a tensor named by ``watch`` (the parameters and cache
    leaves), or a view of one, over a mesh axis other than the data axes:
    a layout the reference's scheme would keep sharded. A gather over the
    data axes is that scheme's FSDP gather (as the products' are) and is
    not counted.
    """

    def __init__(self):
        super().__init__()
        self.ops: dict[str, int] = {}
        self.replicated: dict[str, int] = {}
        self._watched: dict[int, str] = {}

    def watch(self, named) -> None:
        """Watch the (name, tensor) pairs of ``named`` from now on, in place
        of those watched before."""
        self._watched = {_storage_key(t): n for n, t in named if isinstance(t, DTensor)}

    def _note(self, x, want: list) -> None:
        """Count ``x`` if it is watched and moving it to ``want`` gathers a
        shard over a model axis."""
        if not isinstance(x, DTensor) or not self._watched:
            return
        names = x.device_mesh.mesh_dim_names
        if not any(_sharded(p) and not _sharded(w) and names[i] not in ("pod", "data")
                   for i, (p, w) in enumerate(zip(x.placements, want))):
            return
        name = self._watched.get(_storage_key(x))
        if name is not None:
            self.replicated[name] = self.replicated.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _DEVICE or not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if func in _PRODUCTS and isinstance(args[0], DTensor) and isinstance(args[1], DTensor):
            a = _move(args[0], [Replicate() if p.is_partial() else p
                                for p in args[0].placements], autograd=False)
            args = (a, _fsdp_gathered(a, args[1], _PRODUCTS[func]))
        if func in _RESHAPES and isinstance(args[0], DTensor):
            x = _clean_for_reshape(args[0], _resolve(args[1], args[0].numel()))
            self._note(args[0], x.placements)
            if x is not args[0]:
                func, args = torch.ops.aten.reshape.default, (x, *args[1:])
        try:
            return func(*args, **kwargs)
        except ValueError as e:  # a shard's strides no view of it can take
            if func is not torch.ops.aten.view.default or "view" not in str(e):
                raise
            return torch.ops.aten.reshape.default(*args, **kwargs)
        except _SHARDING_ERRORS as e:
            if not _propagation_failed(e) or func._schema.is_mutable:
                raise
        name = str(func.overloadpacket)
        self.ops[name] = self.ops.get(name, 0) + 1
        for x in pytree.tree_leaves((args, kwargs)):
            if isinstance(x, DTensor):
                self._note(x, [Replicate()] * x.device_mesh.ndim)
        if func is torch.ops.aten.view.default:  # the gathered shard has its own strides
            func = torch.ops.aten.reshape.default
        for shards_only in (True, False):
            a, kw = pytree.tree_map(lambda x: _replicated(x, shards_only), (args, kwargs))
            try:
                return func(*a, **kw)
            except _SHARDING_ERRORS as e:
                if not _propagation_failed(e):
                    raise
        return _on_whole(func, args, kwargs)


def _storage_key(x: DTensor) -> int:
    """The local tensor's storage (shared by its views)."""
    return x._local_tensor.untyped_storage()._cdata


def _on_whole(func, args, kwargs):
    """``func`` on the whole (replicated) inputs' local tensors, its tensor
    outputs replicated: for an op DTensor has no rule for at all."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta

    mesh = next(a for a in pytree.tree_leaves((args, kwargs))
                if isinstance(a, DTensor)).device_mesh
    rep = tuple(Replicate() for _ in range(mesh.ndim))

    def local(x):
        return _move(x, list(rep), autograd=False)._local_tensor if isinstance(x, DTensor) else x

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        spec = DTensorSpec(mesh, rep, tensor_meta=TensorMeta(t.shape, t.stride(), t.dtype))
        return DTensor(t, spec, requires_grad=False)

    a, kw = pytree.tree_map(local, (args, kwargs))
    return pytree.tree_map(wrap, func(*a, **kw))


def write_at(dst: torch.Tensor, start: int, src: torch.Tensor) -> None:
    """``dst[:, start:start + src.shape[1]] = src`` in place (a cache's
    sequence dim). A DTensor ``dst`` sharded on that dim writes on each
    rank only the positions its shard holds, from ``src`` brought to
    ``dst``'s placements with the sequence dim whole."""
    if not isinstance(dst, DTensor):
        dst[:, start:start + src.shape[1]] = src
        return
    mesh = dst.device_mesh
    want = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in dst.placements]
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim, run_check=False)
    src = src.redistribute(mesh, want).to_local()
    lo, n = _offset(mesh, dst.placements, dst.shape[1], 1)
    a, b = max(start, lo), min(start + src.shape[1], lo + n)
    if a < b:
        dst.to_local()[:, a - lo:b - lo] = src[:, a - start:b - start].to(dst.dtype)


def _offset(mesh, placements, size: int, dim: int) -> tuple[int, int]:
    """(first index, length) of this rank's shard of a dim of ``size``."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():  # the mesh's coordinate is a real lookup
        coord = mesh.get_coordinate()
    lo = 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.size(i)
            lo += coord[i] * size
    return lo, size


def _clean_for_reshape(x: DTensor, new: tuple) -> DTensor:
    """``x`` with every placement the reshape to ``new`` cannot carry
    replicated. The dims a reshape touches flatten into one run, which
    splits into the new dims: a shard of the run's outermost dim stays a
    plain shard of the new outermost dim when the mesh divides that dim (a
    split, a merge, or (B, S) → (n, G) with G dividing S). A shard of any
    other touched dim would come out strided (or fail), so it is gathered
    first. A reshape that only adds or drops unit dims moves no shard."""
    old = tuple(x.shape)
    if [d for d in old if d != 1] == [d for d in new if d != 1]:
        return x  # only unit dims come or go: every shard keeps its dim
    p = 0
    while p < min(len(old), len(new)) and old[p] == new[p]:
        p += 1
    s = 0
    while s < min(len(old), len(new)) - p and old[-1 - s] == new[-1 - s]:
        s += 1
    lo, hi_old, hi_new = p, len(old) - s, len(new) - s
    mesh = x.device_mesh
    ways = math.prod(mesh.size(i) for i, q in enumerate(x.placements)
                     if isinstance(q, Shard) and q.dim == lo)
    want = list(x.placements)
    for i, q in enumerate(x.placements):
        if not _sharded(q) or not lo <= q.dim < hi_old:
            continue
        if _strided(q) or q.dim != lo or hi_new <= lo or new[lo] % ways:
            want[i] = Replicate()
    return _move(x, want, autograd=False)




def _to_local(x: DTensor, pl: list, split: list) -> torch.Tensor:
    """``x`` on placements ``pl`` as its local tensor, for a computation
    each rank runs on its own shards, differentiable. Where ``x`` is whole
    on a mesh dim but the computation is split there (``split[i]``: another
    input is sharded on it), each rank's gradient is its share only, and is
    marked partial (summed over that dim)."""
    from torch.distributed.tensor import Partial

    grad_pl = [Partial() if cut and isinstance(p, Replicate) else p for p, cut in zip(pl, split)]
    return redistribute(x, pl).to_local(grad_placements=grad_pl)


def local_attention(fn, qg: DTensor, k, v, mask: Optional[torch.Tensor], *rest):
    """``fn(qg, k, v, mask, *rest)`` — attention of queries (B, Sq, Hkv, G,
    ·) against keys and values (B, Sk, Hkv, ·) — run on each rank's shards
    (``local_map``'s idiom): the batch over the data axes; over ``model``
    the kv heads where they divide, else the query sequence (context
    parallelism, the reference's ``_cp_constrain``; keys and values whole),
    else nothing. The output (B, Sq, Hkv, G, ·) has the queries' layout.
    ``mask`` (Sq, Sk) is a plain tensor, sliced to the rank's queries."""
    mesh = qg.device_mesh
    names = tuple(mesh.mesh_dim_names)
    B, Sq, Hkv = qg.shape[:3]
    dp = [i for i, n in enumerate(names) if n in ("pod", "data")]
    batch = B % math.prod(mesh.size(i) for i in dp) == 0
    q_pl, kv_pl = [], []
    for i, name in enumerate(names):
        n = mesh.size(i)
        if i in dp:
            q_pl.append(Shard(0) if batch else Replicate())
            kv_pl.append(q_pl[-1])
        elif Hkv % n == 0:
            q_pl.append(Shard(2))
            kv_pl.append(Shard(2))
        elif Sq % n == 0 and Sq > 1:
            q_pl.append(Shard(1))
            kv_pl.append(Replicate())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
    split = [_sharded(p) for p in q_pl]
    local = lambda t, pl: _to_local(t, pl, split) if isinstance(t, DTensor) else t
    if mask is not None and Shard(1) in q_pl:
        lo, n = _offset(mesh, q_pl, Sq, 1)
        mask = mask[lo:lo + n]
    out = fn(local(qg, q_pl), local(k, kv_pl), local(v, kv_pl), mask, *rest).contiguous()
    shape = (B, Sq, Hkv) + tuple(out.shape[3:])
    return DTensor.from_local(out, mesh, q_pl, run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def vocab_parallel_xent(logits: DTensor, targets: torch.Tensor, start: int = 0,
                        shift: int = 0) -> torch.Tensor:
    """Mean cross-entropy of logits (B, S, V) at positions [start, S -
    shift) against targets (B, S - start) at [shift, ...): the reference's
    ``_xent(logits[:, start:][:, :-1], targets[:, 1:])`` for shift 1. The
    logits are sharded (the batch over the data axes, the vocab over
    ``model``) and each rank works on its shard (Megatron's
    vocab-parallel form): the log-sum-exp from a max and a sum reduced
    over ``model``, the target logit picked on the rank whose shard holds
    it. No rank holds the whole vocab of any row, and positions are cut
    locally, so no gradient is gathered either."""
    from torch.distributed.tensor import Partial
    import torch.distributed._functional_collectives as funcol

    mesh = logits.device_mesh
    names = tuple(mesh.mesh_dim_names)
    B, S, V = logits.shape
    dp = [i for i, n in enumerate(names) if n in ("pod", "data")]
    batch = B % math.prod(mesh.size(i) for i in dp) == 0
    pl, t_pl, part_pl, vocab_dims = [], [], [], []
    for i in range(len(names)):
        if i in dp:
            pl.append(Shard(0) if batch else Replicate())
            t_pl.append(pl[-1])
            part_pl.append(pl[-1])
        elif V % mesh.size(i) == 0 and mesh.size(i) > 1:
            pl.append(Shard(2))
            t_pl.append(Replicate())
            part_pl.append(Partial())
            vocab_dims.append(i)
        else:
            pl.append(Replicate())
            t_pl.append(Replicate())
            part_pl.append(Replicate())
    if not isinstance(targets, DTensor):
        targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim, run_check=False)
    lg = redistribute(logits, pl).to_local()[:, start:S - shift]
    lt = redistribute(targets, t_pl).to_local()[:, shift:].long()
    shape = torch.Size((B, lg.shape[1]))

    def whole(t):  # a per-rank partial (B_local, S') summed over the vocab's shards
        d = DTensor.from_local(t, mesh, part_pl, run_check=False, shape=shape,
                               stride=(shape[1], 1))
        return redistribute(d, t_pl)

    lo, n = _offset(mesh, pl, V, 2)
    picked = lg.gather(-1, (lt - lo).clamp(0, n - 1)[..., None])[..., 0]
    if not vocab_dims:  # each rank holds its rows' whole vocab: the plain form
        return (whole(torch.logsumexp(lg, dim=-1)) - whole(picked)).mean()
    hit = (lt >= lo) & (lt < lo + n)
    picked = torch.where(hit, picked, torch.zeros_like(picked))
    m = lg.detach().amax(-1, keepdim=True)
    for i in vocab_dims:
        m = funcol.all_reduce(m, "max", (mesh, i))
    sums = torch.exp(lg - m).sum(-1)
    lse = torch.log(whole(sums)) + DTensor.from_local(m[..., 0], mesh, t_pl, run_check=False,
                                                     shape=shape, stride=(shape[1], 1))
    return (lse - whole(picked)).mean()


def vocab_parallel_embedding(tokens: torch.Tensor, embed: DTensor) -> DTensor:
    """``embed[tokens]`` for an embedding (V, dm) sharded (the vocab over
    ``model``, dm over ``data``): its data-axis shards gathered (FSDP), each
    rank looks up the tokens its vocab shard holds (zeros elsewhere) and the
    rows are summed over ``model`` (Megatron's vocab-parallel embedding).
    The result (B, S, dm) has the batch over the data axes where it
    divides, and is whole over ``model``."""
    from torch.distributed.tensor import Partial

    mesh = embed.device_mesh
    names = tuple(mesh.mesh_dim_names)
    V, dm = embed.shape
    dp = [i for i, n in enumerate(names) if n in ("pod", "data")]
    B = tokens.shape[0]
    batch = B % math.prod(mesh.size(i) for i in dp) == 0
    w_pl, t_pl, part_pl, out_pl = [], [], [], []
    for i in range(len(names)):
        if i in dp:
            w_pl.append(Replicate())
            t_pl.append(Shard(0) if batch else Replicate())
            part_pl.append(t_pl[-1])
        elif V % mesh.size(i) == 0 and mesh.size(i) > 1:
            w_pl.append(Shard(0))
            t_pl.append(Replicate())
            part_pl.append(Partial())
        else:
            w_pl.append(Replicate())
            t_pl.append(Replicate())
            part_pl.append(Replicate())
        out_pl.append(t_pl[-1])
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    w = _to_local(embed, w_pl, [_sharded(p) for p in t_pl])
    t = redistribute(tokens, t_pl).to_local().long()
    lo, n = _offset(mesh, w_pl, V, 0)
    hit = (t >= lo) & (t < lo + n)
    rows = w[(t - lo).clamp(0, n - 1)] * hit[..., None].to(w.dtype)
    shape = torch.Size(tuple(tokens.shape) + (dm,))
    out = DTensor.from_local(rows, mesh, part_pl, run_check=False, shape=shape,
                             stride=_contiguous_stride(shape))
    return redistribute(out, out_pl)


def local_split(fn, ins: list, outs: list, split: int, *rest):
    """``fn(*locals, *rest)`` on each rank's shards (``local_map``'s idiom)
    for a computation independent across its batch and across ``split``
    channels or heads (a depthwise conv, an SSM's chunk scan): each of
    ``ins`` is (tensor, batch dim, split dim), None for a dim the tensor
    lacks; every rank takes the batch over the data axes where it divides
    and the split dim over ``model`` where ``split`` divides, so tensors
    without a split dim (keys shared across heads) stay whole over
    ``model``. ``outs`` gives (global shape, batch dim, split dim) for each
    output of ``fn`` (a tensor or a tuple), returned as DTensors on that
    layout. Plain tensors among ``ins`` pass as they are."""
    mesh = next(t.device_mesh for t, _, _ in ins if isinstance(t, DTensor))
    names = tuple(mesh.mesh_dim_names)
    dp = [i for i, n in enumerate(names) if n in ("pod", "data")]
    B = next(t.shape[b] for t, b, _ in ins if b is not None)
    batch = B % math.prod(mesh.size(i) for i in dp) == 0
    cut = [batch if i in dp else split % mesh.size(i) == 0 for i in range(len(names))]

    def layout(b, s):
        return [Shard(d) if c and d is not None else Replicate()
                for c, d in zip(cut, (b if i in dp else s for i in range(len(names))))]

    local = [_to_local(t, layout(b, s), cut) if isinstance(t, DTensor) else t for t, b, s in ins]
    res = fn(*local, *rest)
    one = isinstance(res, torch.Tensor)
    wrapped = tuple(
        DTensor.from_local(r.contiguous(), mesh, layout(b, s), run_check=False,
                           shape=torch.Size(shape), stride=_contiguous_stride(shape))
        for r, (shape, b, s) in zip((res,) if one else res, outs))
    return wrapped[0] if one else wrapped


def split_kv_attention(qg: DTensor, k: DTensor, v: DTensor, valid: torch.Tensor, Dh: int,
                       neg_inf: float) -> DTensor:
    """One decode step's attention, qg (B, 1, Hkv, G, Dh) against a cache
    k, v (B, S, Hkv, Dh) sharded on its sequence over ``model``
    (flash-decoding's split-KV): each rank scores its keys, the softmax's
    max and sum are reduced over ``model``, each rank weighs its values
    (the weights cast to the queries' dtype before the product, as the
    plain form does) and the partial outputs are summed. ``valid`` (S,) is
    a plain mask of the keys. No rank gathers the cache."""
    import torch.distributed._functional_collectives as funcol

    mesh = k.device_mesh
    names = tuple(mesh.mesh_dim_names)
    B, S = k.shape[:2]
    dp = [i for i, n in enumerate(names) if n in ("pod", "data")]
    batch = B % math.prod(mesh.size(i) for i in dp) == 0
    kv_pl = [(Shard(0) if batch else Replicate()) if i in dp else
             (Shard(1) if S % mesh.size(i) == 0 else Replicate()) for i in range(len(names))]
    q_pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in kv_pl]
    seq_dims = [i for i, p in enumerate(kv_pl) if isinstance(p, Shard) and p.dim == 1]
    q = redistribute(qg, q_pl).to_local()
    kl = redistribute(k, kv_pl).to_local()
    vl = redistribute(v, kv_pl).to_local()
    lo, n = _offset(mesh, kv_pl, S, 1)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, kl).float() / math.sqrt(Dh)
    scores = torch.where(valid[lo:lo + n], scores, neg_inf)
    m = scores.amax(-1, keepdim=True)
    for i in seq_dims:
        m = funcol.all_reduce(m, "max", (mesh, i))
    e = torch.exp(scores - m)
    total = e.sum(-1, keepdim=True)
    for i in seq_dims:
        total = funcol.all_reduce(total, "sum", (mesh, i))
    out = torch.einsum("bhgqk,bkhd->bqhgd", (e / total).to(q.dtype), vl)
    for i in seq_dims:
        out = funcol.all_reduce(out, "sum", (mesh, i))
    shape = torch.Size(tuple(qg.shape))
    return DTensor.from_local(out.contiguous(), mesh, q_pl, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))
