"""Continuation-token codec — versioned, schema-checked, pickle-free.

Continuation tokens are *client-supplied bytes* (§3.5: the SDK hands them
back on every page request), so the decoder must treat them as hostile
input. The previous ``pickle.loads`` codec was arbitrary code execution on
whatever a client mailed in; this module replaces it with a fixed binary
layout over raw numpy buffers:

    token  := MAGIC(4) | VERSION(u16) | NFIELD(u16) | field* | CRC32(u32)
    field  := klen(u16) | key(utf-8) | dtype(u8) | ndim(u8) | dim(u32)*ndim
              | raw little-endian C-order array bytes

Every stage validates: magic + version window (over-versioned tokens from
a future build are rejected, not guessed at), CRC over the whole prefix,
an allow-listed dtype table, bounded field counts/array sizes, exact
length consumption, and finally a field-level schema check that the
decoded arrays assemble into a well-formed ``PagedQueryState`` (consistent
beam/backup widths, aligned buffers, scalar shapes). Anything off raises
``ContinuationError`` — the service maps it to a client error, never a
crash or an exec.

The port of ``repro.serve.continuation``: the wire and schema layers are the
reference's, so a token minted by either package decodes in the other, byte
for byte. The port's ``PageState`` holds tensors: encoding reads them back
to the host (the visited bitmap's int64 words as the reference's uint32),
and ``decode_continuation`` puts the decoded state on the device the caller
names, so a token resumes on the partition's own device.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np
import torch

from ..core import graph as g
from ..core import paginate as pgmod
from ..device import DeviceLike, resolve_device
from ..partition.fanout import PagedQueryState, PartitionPageCursor

MAGIC = b"CPGT"  # Cosmos PaGination Token
TOKEN_VERSION = 1
_MAX_FIELDS = 4096
_MAX_KEY = 128
_MAX_ELEMS = 1 << 24  # per-array bound: a token must not be a memory bomb

# allow-listed dtypes, explicit little-endian so tokens are portable
_DTYPES = {
    0: np.dtype("<i4"),
    1: np.dtype("<i8"),
    2: np.dtype("<f4"),
    3: np.dtype("<f8"),
    4: np.dtype("u1"),
    5: np.dtype("<u4"),
    6: np.dtype("?"),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


class ContinuationError(ValueError):
    """The token is malformed, tampered with, or from an incompatible
    version/topology — reject the page request."""


# ---------------------------------------------------------------------------
# wire layer: {key: ndarray} <-> bytes
# ---------------------------------------------------------------------------


def _canonical(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)  # NOT ascontiguousarray: that would promote 0-d to 1-d
    if not a.flags["C_CONTIGUOUS"]:
        a = np.copy(a, order="C")
    dt = a.dtype.newbyteorder("<") if a.dtype.byteorder == ">" else a.dtype
    return a.astype(dt, copy=False)


def encode_arrays(fields: dict[str, np.ndarray]) -> bytes:
    if len(fields) > _MAX_FIELDS:
        raise ContinuationError(f"too many fields ({len(fields)})")
    out = [MAGIC, struct.pack("<HH", TOKEN_VERSION, len(fields))]
    for key, arr in fields.items():
        kb = key.encode("utf-8")
        arr = _canonical(np.asarray(arr))
        code = _DTYPE_CODES.get(arr.dtype)
        if code is None:
            raise ContinuationError(f"dtype {arr.dtype} not in token schema")
        out.append(struct.pack("<H", len(kb)))
        out.append(kb)
        out.append(struct.pack("<BB", code, arr.ndim))
        out.append(struct.pack(f"<{arr.ndim}I", *arr.shape))
        out.append(arr.tobytes())
    payload = b"".join(out)
    return payload + struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)


def decode_arrays(token: bytes) -> dict[str, np.ndarray]:
    if not isinstance(token, (bytes, bytearray)):
        raise ContinuationError("token must be bytes")
    token = bytes(token)
    if len(token) < 12 or token[:4] != MAGIC:
        raise ContinuationError("not a continuation token (bad magic)")
    body, (crc,) = token[:-4], struct.unpack("<I", token[-4:])
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise ContinuationError("token checksum mismatch (tampered/truncated)")
    version, nfields = struct.unpack("<HH", body[4:8])
    if version < 1 or version > TOKEN_VERSION:
        raise ContinuationError(
            f"unsupported token version {version} (this build speaks "
            f"≤ {TOKEN_VERSION})"
        )
    if nfields > _MAX_FIELDS:
        raise ContinuationError(f"too many fields ({nfields})")

    fields: dict[str, np.ndarray] = {}
    off = 8
    for _ in range(nfields):
        if off + 2 > len(body):
            raise ContinuationError("truncated field header")
        (klen,) = struct.unpack_from("<H", body, off)
        off += 2
        if klen == 0 or klen > _MAX_KEY or off + klen + 2 > len(body):
            raise ContinuationError("bad field key")
        key = body[off : off + klen].decode("utf-8", errors="strict")
        off += klen
        code, ndim = struct.unpack_from("<BB", body, off)
        off += 2
        if code not in _DTYPES or ndim > 2:
            raise ContinuationError(f"field {key!r}: bad dtype/ndim")
        if off + 4 * ndim > len(body):
            raise ContinuationError("truncated shape")
        shape = struct.unpack_from(f"<{ndim}I", body, off)
        off += 4 * ndim
        dtype = _DTYPES[code]
        # python-int product: a crafted (huge, huge) shape must hit THIS
        # bound, not wrap an int64 and escape into a raw numpy error
        n_elem = 1
        for dim in shape:
            n_elem *= int(dim)
        if n_elem > _MAX_ELEMS:
            raise ContinuationError(f"field {key!r}: array too large")
        nbytes = n_elem * dtype.itemsize
        if off + nbytes > len(body):
            raise ContinuationError(f"field {key!r}: truncated data")
        arr = np.frombuffer(body, dtype=dtype, count=n_elem, offset=off)
        fields[key] = arr.reshape(shape).copy()
        off += nbytes
    if off != len(body):
        raise ContinuationError("trailing bytes after last field")
    return fields


# ---------------------------------------------------------------------------
# schema layer: PagedQueryState <-> {key: ndarray}
# ---------------------------------------------------------------------------

_STATE_SCHEMA = (
    # (field, dtype, rank group) — groups must agree on length within a state
    ("best_ids", np.int32, "L"),
    ("best_dists", np.float32, "L"),
    ("best_expanded", np.bool_, "L"),
    ("backup_ids", np.int32, "B"),
    ("backup_dists", np.float32, "B"),
    ("backup_expanded", np.bool_, "B"),
    ("bitmap", np.uint32, "W"),
    ("hops", np.int32, None),
    ("cmps", np.int32, None),
    ("exp", np.int32, None),
    ("dropped", np.int32, None),
)


def encode_continuation(pstate: PagedQueryState) -> bytes:
    fields: dict[str, np.ndarray] = {
        "shard_fp": np.int64(pstate.shard_fp),
        "emit_hwm": np.float32(pstate.emit_hwm),
        "pages": np.int32(pstate.pages),
        "n_parts": np.int32(len(pstate.cursors)),
    }
    for i, cur in enumerate(pstate.cursors):
        pre = f"p{i}/"
        fields[pre + "pid"] = np.int32(cur.pid)
        fields[pre + "exhausted"] = np.uint8(cur.exhausted)
        fields[pre + "fetch_hwm"] = np.float32(cur.fetch_hwm)
        fields[pre + "buf_ids"] = np.asarray(cur.buf_ids, np.int64)
        fields[pre + "buf_dists"] = np.asarray(cur.buf_dists, np.float32)
        if cur.state is not None:
            for name, dtype, _ in _STATE_SCHEMA:
                fields[pre + "st/" + name] = np.asarray(
                    _host(name, getattr(cur.state, name)), dtype
                )
    return encode_arrays(fields)


def _host(name: str, value) -> np.ndarray:
    """A ``PageState`` field as the reference's numpy array."""
    if name == "bitmap":
        return g.bitmap_to_numpy(value)
    return value.cpu().numpy()


def _device(name: str, arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A decoded field as the port's ``PageState`` tensor on ``dev``."""
    if name == "bitmap":
        return g.bitmap_from_numpy(arr, dev)
    return torch.from_numpy(arr).to(dev)


def _take(fields: dict, key: str, dtype, ndim: int) -> np.ndarray:
    if key not in fields:
        raise ContinuationError(f"missing field {key!r}")
    arr = fields.pop(key)
    if arr.dtype != np.dtype(dtype) or arr.ndim != ndim:
        raise ContinuationError(
            f"field {key!r}: expected {np.dtype(dtype).name} rank-{ndim}, "
            f"got {arr.dtype.name} rank-{arr.ndim}"
        )
    return arr


def decode_continuation(token: bytes, device: DeviceLike = None) -> PagedQueryState:
    """Parse + schema-check a client token into a ``PagedQueryState``, its
    cursors' search state on ``device`` (None → the CUDA card; the service
    passes its collection's device).
    Topology binding (shard fingerprint, partition ids, bitmap widths) is
    the service's job — it knows the current routing."""
    dev = resolve_device(device)
    fields = decode_arrays(token)
    shard_fp = int(_take(fields, "shard_fp", np.int64, 0))
    emit_hwm = float(_take(fields, "emit_hwm", np.float32, 0))
    if np.isnan(emit_hwm):
        raise ContinuationError("emit high-water mark is NaN")
    pages = int(_take(fields, "pages", np.int32, 0))
    n_parts = int(_take(fields, "n_parts", np.int32, 0))
    if not 1 <= n_parts <= 4096:
        raise ContinuationError(f"implausible partition count {n_parts}")
    if pages < 0:
        raise ContinuationError("negative page count")

    cursors: list[PartitionPageCursor] = []
    for i in range(n_parts):
        pre = f"p{i}/"
        pid = int(_take(fields, pre + "pid", np.int32, 0))
        exhausted = bool(_take(fields, pre + "exhausted", np.uint8, 0))
        fetch_hwm = float(_take(fields, pre + "fetch_hwm", np.float32, 0))
        if np.isnan(fetch_hwm):
            raise ContinuationError(f"p{i}: fetch high-water mark is NaN")
        buf_ids = _take(fields, pre + "buf_ids", np.int64, 1)
        buf_dists = _take(fields, pre + "buf_dists", np.float32, 1)
        if len(buf_ids) != len(buf_dists):
            raise ContinuationError(f"p{i}: buffer id/dist length mismatch")
        # the merge pops buffer heads as per-partition minima and trusts
        # fetch_hwm as the partition's ascending-stream bound — a token
        # violating either would silently break the no-repeat/no-gap
        # guarantee, so reject it here
        if len(buf_dists):
            if np.any(np.diff(buf_dists) < 0):
                raise ContinuationError(f"p{i}: buffer not ascending")
            if not np.isfinite(buf_dists).all():
                raise ContinuationError(f"p{i}: non-finite buffered distance")
            if fetch_hwm < float(buf_dists[-1]) - 1e-5:
                raise ContinuationError(
                    f"p{i}: high-water mark below buffered results"
                )
        state: Optional[pgmod.PageState] = None
        if pre + "st/best_ids" in fields:
            if exhausted:
                raise ContinuationError(
                    f"p{i}: exhausted cursor must not carry search state"
                )
            dims: dict[str, int] = {}
            st = {}
            for name, dtype, group in _STATE_SCHEMA:
                arr = _take(fields, pre + "st/" + name, dtype,
                            0 if group is None else 1)
                if group is not None:
                    dims.setdefault(group, len(arr))
                    if dims[group] != len(arr) or len(arr) == 0:
                        raise ContinuationError(
                            f"p{i}: inconsistent {group}-group length in state"
                        )
                st[name] = _device(name, arr, dev)
            state = pgmod.PageState(**st)
        elif not exhausted:
            raise ContinuationError(
                f"p{i}: live cursor is missing its search state"
            )
        cursors.append(PartitionPageCursor(
            pid=pid, state=state, buf_ids=buf_ids, buf_dists=buf_dists,
            fetch_hwm=fetch_hwm, exhausted=exhausted,
        ))
    if fields:
        raise ContinuationError(
            f"unexpected fields in token: {sorted(fields)[:4]}"
        )
    return PagedQueryState(shard_fp=shard_fp, emit_hwm=emit_hwm,
                           pages=pages, cursors=cursors)
