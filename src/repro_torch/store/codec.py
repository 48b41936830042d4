"""Snapshot/WAL wire codec — versioned, schema-checked, CRC'd, pickle-free.

Recovery bytes are untrusted input, as continuation tokens are: a
snapshot or WAL handed to ``StoreProviderSet.recover`` may
come off a disk that lost power mid-write, a replication stream that got
truncated, or an attacker. The previous ``pickle.loads`` codec was
arbitrary code execution on whatever those bytes contained; this module
replaces it with fixed binary layouts over raw numpy buffers, in the
style of ``serve/continuation.py``:

    snapshot := MAGIC("CSNP") | VERSION(u16) | base_lsn(u64)
              | capacity(u32) R_slack(u32) M(u32) dim(u32)
              | neighbors(<i4) codes(u1) versions(u1) live(u1) vectors(<f4)
              | ntree(u32) | (klen(u32) key vlen(u32) value)*
              | CRC32(u32)                     # over everything prior

    wal      := MAGIC("CWAL") | VERSION(u16) | record*
    record   := plen(u32) | payload(plen) | CRC32(payload)(u32)
    payload  := nentries(u16) | entry*
    entry    := opcode(u8) | args per the op schema below

Each WAL *record* is one committed transaction (one logical store op), so
a torn tail — the crash interrupting the disk write of the final record —
never splits an operation: either all of its entries replay or none do.
Torn tails (a final frame that runs past the end of the buffer, or whose
CRC fails) are **truncated**; a CRC failure on an *interior* record is bit
rot, not a crash, and raises ``WalCorruption`` instead of silently losing
committed data.

The port's own copy of ``repro.store.codec`` (no JAX there, but importing it
through ``repro`` loads JAX); both packages read and write the same bytes.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC_SNAPSHOT = b"CSNP"  # Cosmos SNaPshot
MAGIC_WAL = b"CWAL"  # Cosmos Write-Ahead Log
VERSION = 1

_MAX_TREE_ITEMS = 1 << 22
_MAX_KEY = 4096
_MAX_VALUE = 1 << 26
_MAX_RECORD = 1 << 26
_MAX_ENTRIES = 4096
_MAX_ELEMS = 1 << 24

# allow-listed dtypes, explicit little-endian so recovery is portable
_DTYPES = {
    0: np.dtype("<i4"),
    1: np.dtype("<i8"),
    2: np.dtype("<f4"),
    3: np.dtype("u1"),
    4: np.dtype("<u4"),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}
_TAG_BYTES = 0xFF  # entry-arg tag for a raw bytes field (term keys)

# op schemas: opcode -> (name, number of args). Arg shapes/dtypes are
# checked per-op in decode (and again against collection config by the
# caller before replay).
WAL_OPS = {
    1: ("set_neighbors", 2),  # ids <i8[n], rows <i4[n,R]
    2: ("append_neighbors", 2),  # node <i8[], new_ids <i8[n]
    3: ("set_quant", 3),  # ids <i8[n], codes u1[n,M], versions u1[n]
    4: ("set_full", 2),  # ids <i8[n], vecs <f4[n,dim]
    5: ("set_live", 2),  # ids <i8[n], value u1[]
    6: ("write_prop_posting", 2),  # key bytes, words <u4[n]
}
_OPCODES = {name: (code, nargs) for code, (name, nargs) in WAL_OPS.items()}


class StoreCodecError(ValueError):
    """The snapshot/WAL bytes are malformed, tampered with, or from an
    incompatible version/topology — reject recovery."""


class WalCorruption(StoreCodecError):
    """An *interior* WAL record failed its CRC or schema: committed data
    is damaged (bit rot), which truncation would silently lose."""


# ---------------------------------------------------------------------------
# wire helpers
# ---------------------------------------------------------------------------


def _canonical(a: np.ndarray, dtype) -> np.ndarray:
    a = np.asarray(a)
    if not a.flags["C_CONTIGUOUS"]:
        a = np.copy(a, order="C")
    return a.astype(np.dtype(dtype), copy=False)


def _pack_array(arr: np.ndarray) -> bytes:
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise StoreCodecError(f"dtype {arr.dtype} not in WAL schema")
    return b"".join(
        (
            struct.pack("<BB", code, arr.ndim),
            struct.pack(f"<{arr.ndim}I", *arr.shape),
            arr.tobytes(),
        )
    )


def _unpack_array(body: bytes, off: int) -> tuple[np.ndarray, int]:
    if off + 2 > len(body):
        raise StoreCodecError("truncated array header")
    code, ndim = struct.unpack_from("<BB", body, off)
    off += 2
    if code not in _DTYPES or ndim > 2:
        raise StoreCodecError("bad array dtype/ndim")
    if off + 4 * ndim > len(body):
        raise StoreCodecError("truncated array shape")
    shape = struct.unpack_from(f"<{ndim}I", body, off)
    off += 4 * ndim
    dtype = _DTYPES[code]
    n_elem = 1
    for dim in shape:  # python-int product: huge shapes must hit THIS bound
        n_elem *= int(dim)
    if n_elem > _MAX_ELEMS:
        raise StoreCodecError("array too large")
    nbytes = n_elem * dtype.itemsize
    if off + nbytes > len(body):
        raise StoreCodecError("truncated array data")
    arr = np.frombuffer(body, dtype=dtype, count=n_elem, offset=off)
    return arr.reshape(shape).copy(), off + nbytes


# ---------------------------------------------------------------------------
# snapshot
# ---------------------------------------------------------------------------


def encode_snapshot(
    neighbors: np.ndarray,
    codes: np.ndarray,
    versions: np.ndarray,
    live: np.ndarray,
    vectors: np.ndarray,
    tree_items: list[tuple[bytes, bytes]],
    base_lsn: int,
) -> bytes:
    capacity, r_slack = neighbors.shape
    out = [
        MAGIC_SNAPSHOT,
        struct.pack("<HQ", VERSION, base_lsn),
        struct.pack(
            "<IIII", capacity, r_slack, codes.shape[1], vectors.shape[1]
        ),
        _canonical(neighbors, "<i4").tobytes(),
        _canonical(codes, "u1").tobytes(),
        _canonical(versions, "u1").tobytes(),
        _canonical(live, "u1").tobytes(),
        _canonical(vectors, "<f4").tobytes(),
        struct.pack("<I", len(tree_items)),
    ]
    for key, value in tree_items:
        out.append(struct.pack("<I", len(key)))
        out.append(key)
        out.append(struct.pack("<I", len(value)))
        out.append(value)
    payload = b"".join(out)
    return payload + struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)


def decode_snapshot(
    data: bytes, capacity: int, r_slack: int, m: int, dim: int
) -> tuple[dict[str, np.ndarray], list[tuple[bytes, bytes]], int]:
    """Validate + parse a snapshot whose shape header must match the
    recovering provider's configured (capacity, R_slack, M, dim)."""
    if not isinstance(data, (bytes, bytearray)):
        raise StoreCodecError("snapshot must be bytes")
    data = bytes(data)
    if len(data) < 34 or data[:4] != MAGIC_SNAPSHOT:
        raise StoreCodecError("not a store snapshot (bad magic)")
    body, (crc,) = data[:-4], struct.unpack("<I", data[-4:])
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise StoreCodecError("snapshot checksum mismatch (tampered/torn)")
    version, base_lsn = struct.unpack_from("<HQ", body, 4)
    if version < 1 or version > VERSION:
        raise StoreCodecError(
            f"unsupported snapshot version {version} (this build speaks "
            f"≤ {VERSION})"
        )
    shape = struct.unpack_from("<IIII", body, 14)
    if shape != (capacity, r_slack, m, dim):
        raise StoreCodecError(
            f"snapshot topology {shape} does not match provider "
            f"{(capacity, r_slack, m, dim)}"
        )
    off = 30
    arrays: dict[str, np.ndarray] = {}
    for name, dtype, count in (
        ("neighbors", "<i4", capacity * r_slack),
        ("codes", "u1", capacity * m),
        ("versions", "u1", capacity),
        ("live", "u1", capacity),
        ("vectors", "<f4", capacity * dim),
    ):
        dt = np.dtype(dtype)
        nbytes = count * dt.itemsize
        if off + nbytes > len(body):
            raise StoreCodecError(f"snapshot truncated in {name}")
        arrays[name] = np.frombuffer(body, dt, count=count, offset=off).copy()
        off += nbytes
    if off + 4 > len(body):
        raise StoreCodecError("snapshot truncated before term section")
    (ntree,) = struct.unpack_from("<I", body, off)
    off += 4
    if ntree > _MAX_TREE_ITEMS:
        raise StoreCodecError(f"implausible term count {ntree}")
    items: list[tuple[bytes, bytes]] = []
    for _ in range(ntree):
        if off + 4 > len(body):
            raise StoreCodecError("snapshot truncated in term key length")
        (klen,) = struct.unpack_from("<I", body, off)
        off += 4
        if klen == 0 or klen > _MAX_KEY or off + klen + 4 > len(body):
            raise StoreCodecError("bad term key")
        key = body[off : off + klen]
        off += klen
        (vlen,) = struct.unpack_from("<I", body, off)
        off += 4
        if vlen > _MAX_VALUE or off + vlen > len(body):
            raise StoreCodecError("bad term value")
        items.append((key, body[off : off + vlen]))
        off += vlen
    if off != len(body):
        raise StoreCodecError("trailing bytes after last term")
    return arrays, items, base_lsn


# ---------------------------------------------------------------------------
# WAL
# ---------------------------------------------------------------------------


def _encode_entry(entry: tuple) -> bytes:
    name, *args = entry
    if name not in _OPCODES:
        raise StoreCodecError(f"op {name!r} not in WAL schema")
    code, nargs = _OPCODES[name]
    if len(args) != nargs:
        raise StoreCodecError(f"op {name!r}: expected {nargs} args")
    out = [struct.pack("<B", code)]
    for i, a in enumerate(args):
        if isinstance(a, (bytes, bytearray)):
            out.append(struct.pack("<BI", _TAG_BYTES, len(a)))
            out.append(bytes(a))
        else:
            out.append(_pack_array(_canonical_arg(name, i, a)))
    return b"".join(out)


def _canonical_arg(name: str, i: int, a) -> np.ndarray:
    """Pin each op's array args to the wire dtype (see WAL_OPS table)."""
    a = np.asarray(a)
    if name == "set_neighbors" and i == 1:
        return _canonical(a, "<i4")
    if name == "set_quant" and i in (1, 2):
        return _canonical(a, "u1")
    if name == "set_full" and i == 1:
        return _canonical(a, "<f4")
    if name == "set_live" and i == 1:
        return _canonical(a, "u1")
    if name == "write_prop_posting":
        return _canonical(a, "<u4")
    return _canonical(a, "<i8")  # ids / node scalars


def encode_wal(records: list[list[tuple]]) -> bytes:
    out = [MAGIC_WAL, struct.pack("<H", VERSION)]
    for entries in records:
        if len(entries) > _MAX_ENTRIES:
            raise StoreCodecError(f"record too large ({len(entries)} entries)")
        payload = struct.pack("<H", len(entries)) + b"".join(
            _encode_entry(e) for e in entries
        )
        if len(payload) > _MAX_RECORD:
            raise StoreCodecError("record payload too large")
        out.append(struct.pack("<I", len(payload)))
        out.append(payload)
        out.append(struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF))
    return b"".join(out)


def _decode_payload(payload: bytes) -> list[tuple]:
    if len(payload) < 2:
        raise StoreCodecError("record payload too short")
    (nentries,) = struct.unpack_from("<H", payload, 0)
    if nentries > _MAX_ENTRIES:
        raise StoreCodecError(f"record claims {nentries} entries")
    off = 2
    entries: list[tuple] = []
    for _ in range(nentries):
        if off + 1 > len(payload):
            raise StoreCodecError("truncated entry opcode")
        code = payload[off]
        off += 1
        if code not in WAL_OPS:
            raise StoreCodecError(f"unknown WAL opcode {code}")
        name, nargs = WAL_OPS[code]
        args: list = []
        for _ in range(nargs):
            if off < len(payload) and payload[off] == _TAG_BYTES:
                if off + 5 > len(payload):
                    raise StoreCodecError("truncated bytes arg")
                (blen,) = struct.unpack_from("<I", payload, off + 1)
                off += 5
                if blen > _MAX_KEY or off + blen > len(payload):
                    raise StoreCodecError("bad bytes arg")
                args.append(payload[off : off + blen])
                off += blen
            else:
                arr, off = _unpack_array(payload, off)
                args.append(arr)
        entries.append((name, *args))
    if off != len(payload):
        raise StoreCodecError("trailing bytes after last entry")
    return entries


def wal_frames(data: bytes) -> list[tuple[int, int]]:
    """(offset, frame_length) of each complete record frame — the byte
    boundaries fault injection needs to tear or flip precisely."""
    frames = []
    off = 6
    while off + 4 <= len(data):
        (plen,) = struct.unpack_from("<I", data, off)
        if plen > _MAX_RECORD or off + 8 + plen > len(data):
            break
        frames.append((off, 8 + plen))
        off += 8 + plen
    return frames


def decode_wal(data: bytes) -> tuple[list[list[tuple]], bool]:
    """Parse WAL bytes into committed records. Returns ``(records,
    torn_tail)``: a final frame that is incomplete or CRC-fails is
    truncated (``torn_tail=True``); an interior one raises
    ``WalCorruption``."""
    if not isinstance(data, (bytes, bytearray)):
        raise StoreCodecError("wal must be bytes")
    data = bytes(data)
    if len(data) < 6 or data[:4] != MAGIC_WAL:
        raise StoreCodecError("not a store WAL (bad magic)")
    (version,) = struct.unpack_from("<H", data, 4)
    if version < 1 or version > VERSION:
        raise StoreCodecError(
            f"unsupported WAL version {version} (this build speaks ≤ {VERSION})"
        )
    records: list[list[tuple]] = []
    off = 6
    torn = False
    while off < len(data):
        if off + 4 > len(data):
            torn = True  # crash mid-length-word
            break
        (plen,) = struct.unpack_from("<I", data, off)
        if plen > _MAX_RECORD or off + 8 + plen > len(data):
            torn = True  # frame runs past the end: crash mid-record
            break
        payload = data[off + 4 : off + 4 + plen]
        (crc,) = struct.unpack_from("<I", data, off + 4 + plen)
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            if off + 8 + plen == len(data):
                torn = True  # final record damaged: torn tail, truncate
                break
            raise WalCorruption(
                f"WAL record at byte {off} failed CRC with committed "
                "records after it (bit rot, not a crash)"
            )
        # CRC-valid but malformed is an encoder bug or forgery, never a
        # torn write — always reject, even at the tail
        records.append(_decode_payload(payload))
        off += 8 + plen
    return records, torn
