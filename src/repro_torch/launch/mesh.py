"""Production meshes (the port of ``repro.launch.mesh``).

Single pod: 16×16 = 256 ranks, axes (data, model).
Multi-pod: 2×16×16 = 512 ranks, axes (pod, data, model) — ``pod`` carries
only the data-parallel gradient reduction (see models/sharding.py).

A ``torch.distributed.device_mesh.DeviceMesh`` spans the ranks of the
default process group, so a mesh needs a group of the mesh's size first:
``start_process_group("fake", world_size=256)`` for the dry-run (one
process stands for every rank and no collective moves data), ``"gloo"``
for CPU ranks, ``"nccl"`` for cards. A process holds one default group, so
the dry-run and a real group each run in a process of their own. Nothing
here touches a process group at import.

``AbstractMesh`` carries only axis names and sizes: the sharding rules
evaluate on it with no process group, as the reference's do on
``jax.sharding.AbstractMesh``.
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names only (what the sharding rules read)."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def size(self) -> int:
        return math.prod(self.shape)


def production_shape(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    return MULTI_POD if multi_pod else SINGLE_POD


def start_process_group(backend: str, *, world_size: int = 1, rank: int = 0,
                        init_file: Optional[str] = None) -> None:
    """Start the default process group: ``fake`` (every collective a no-op,
    one process standing for ``world_size`` ranks: the dry-run), ``gloo``
    (CPU ranks) or ``nccl`` (cards). gloo and nccl meet through
    ``init_file``, a path every rank shares that does not exist yet (a
    fresh one in a new temporary directory when it is None, which only a
    group of one rank can use): no port number is needed."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already running in this process")
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
        return
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    if init_file is None:
        if world_size != 1:
            raise ValueError("ranks of a group of more than one must share an init_file")
        init_file = os.path.join(tempfile.mkdtemp(prefix="repro_pg_"), "init")
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world_size)


def stop_process_group() -> None:
    """Wait for every rank, then destroy the default group (a rank that
    leaves before the others have finished their last collective breaks
    their connection)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device: DeviceLike) -> DeviceMesh:
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("start_process_group(...) must run before a mesh is made")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh {shape} needs {n} ranks; the group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None) -> DeviceMesh:
    """The (16, 16) ``(data, model)`` mesh, or (2, 16, 16) ``(pod, data,
    model)``, over the default group's 256 or 512 ranks, on the card unless
    ``device="cpu"``."""
    shape, axes = production_shape(multi_pod)
    return _mesh(shape, axes, device)


def make_host_mesh(shape: tuple[int, ...] = None, axes: tuple[str, ...] = None,
                   device: DeviceLike = None) -> DeviceMesh:
    """A mesh over the default group's ranks (tests, the launcher): 1-D
    ``("data",)`` over all of them unless a shape and axes are given. With
    no group running, a group of one rank is started (gloo on the CPU, nccl
    on the card); the caller stops it (``stop_process_group``)."""
    if not dist.is_initialized():
        start_process_group("gloo" if resolve_device(device).type == "cpu" else "nccl")
    if shape is None:
        shape, axes = (dist.get_world_size(),), ("data",)
    return _mesh(tuple(shape), tuple(axes), device)


def make_serve_mesh(devices: int = None, device: DeviceLike = None) -> DeviceMesh:
    """1-D ``("data",)`` mesh for the serving engine's stacked fan-out:
    partitions shard across the single ``data`` axis. Defaults to every
    rank of the default group."""
    if not dist.is_initialized():
        start_process_group("gloo" if resolve_device(device).type == "cpu" else "nccl")
    n = devices or dist.get_world_size()
    return _mesh((n,), ("data",), device)


def mesh_device(mesh) -> torch.device:
    """The device a rank's shards of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
