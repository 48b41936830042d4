"""Checkpoints with atomic manifests, in the reference's on-disk format (the
port of ``repro.train.checkpoint``).

Fault-tolerance contract, as the reference's:
  * every leaf is written as its own .npy under step_<N>/, named by its
    path in the tree ('/' → '__'), with a JSON manifest of paths, files,
    shapes and dtypes;
  * the manifest is written last and atomically (.partial + rename), in a
    step_<N>.tmp directory renamed into place — a crash mid-write leaves
    the previous checkpoint intact (``latest_step`` picks the newest
    *complete* step);
  * the data-pipeline cursor rides along in ``extra``, so restarts are
    bit-deterministic.

Leaves are torch tensors (or numpy arrays) and come back as CPU tensors.
A bf16 leaf is written as the reference writes an ml_dtypes bfloat16 array:
a '<V2' header, the raw 2-byte values, manifest dtype "bfloat16"; it is
read back through a 16-bit integer view, so no ml_dtypes is needed. (The
reference itself writes such leaves but cannot restore them: its
``np.load`` gives a '|V2' array, which ``jax.device_put`` refuses.)
``restore(..., shardings=...)`` puts each leaf on a mesh as a DTensor of
the given placements (``models.sharding.Sharding``): the reference's
elastic remesh, whatever mesh wrote the checkpoint (each rank reads the
whole leaf and keeps its shard). Under a process group of more than one
rank every rank calls ``save`` (a DTensor's whole value is a collective),
rank 0 writes, and no rank returns before the checkpoint is in place.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


def _flatten(tree: Any, prefix: str = "", leaf=lambda x: False) -> dict[str, Any]:
    out = {}
    if leaf(tree):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k), leaf))
    elif isinstance(tree, (list, tuple)):
        if hasattr(tree, "_fields"):  # NamedTuple
            for k, v in zip(tree._fields, tree):
                out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k), leaf))
        else:
            for i, v in enumerate(tree):
                out.update(_flatten(v, f"{prefix}/{i}" if prefix else str(i), leaf))
    else:
        out[prefix] = tree
    return out


def _write(path: str, leaf) -> tuple[list, str]:
    """One leaf as an .npy; returns (shape, manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        if hasattr(leaf, "full_tensor"):  # a DTensor: its whole value
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            raw = t.contiguous().view(torch.int16).numpy()
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": "<V2", "fortran_order": False, "shape": raw.shape})
                f.write(raw.tobytes())
            return list(raw.shape), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _read(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None):
    """Write one checkpoint. Crash-safe: manifest lands last, atomically."""
    group = dist.is_initialized() and dist.get_world_size() > 1
    if group and dist.get_rank() != 0:  # its part of each gather; rank 0 writes
        for leaf in _flatten(tree).values():
            if hasattr(leaf, "full_tensor"):
                leaf.full_tensor()
        dist.barrier()
        return
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for path, leaf in _flatten(tree).items():
        fname = path.replace("/", "__") + ".npy"
        shape, dtype = _write(os.path.join(tmp, fname), leaf)
        manifest["leaves"][path] = {"file": fname, "shape": shape, "dtype": dtype}
    mpath = os.path.join(tmp, "manifest.json.partial")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    os.replace(mpath, os.path.join(tmp, "manifest.json"))
    if os.path.exists(d):
        shutil.rmtree(d)
    os.replace(tmp, d)
    if group:
        dist.barrier()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            best = max(best or -1, int(m.group(1)))
    return best


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None,
            shardings: Any = None) -> tuple[Any, dict]:
    """Restore into ``template``'s structure (its leaves name the paths to
    read; their values are not used): (the tree with CPU tensors as leaves,
    the manifest's ``extra``). ``shardings``: a tree keyed as the template
    with a ``models.sharding.Sharding`` where a leaf goes onto a mesh, as a
    DTensor of those placements (elastic remesh)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    from ..models.sharding import Sharding, distribute  # models imports train: here, not above

    flat_s = _flatten(shardings, leaf=lambda x: isinstance(x, Sharding)) if shardings else {}
    loaded = {}
    for path in _flatten(template):
        info = manifest["leaves"][path]
        leaf = _read(os.path.join(d, info["file"]), info["dtype"])
        sh = flat_s.get(path)
        loaded[path] = distribute(leaf, sh) if isinstance(sh, Sharding) else leaf

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            if hasattr(tree, "_fields"):
                return type(tree)(*[rebuild(v, f"{prefix}/{k}" if prefix else str(k))
                                    for k, v in zip(tree._fields, tree)])
            return type(tree)(rebuild(v, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(tree))
        return loaded[prefix]

    return rebuild(template), manifest["extra"]
