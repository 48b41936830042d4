"""Index-term encodings (§3.3, Fig 4, Appendix C).

Two term kinds carry the vector index inside the Bw-Tree:

  * Inverted term (quantized vector):
        TermKey  = pathhash(15B) | 0x17 | [shardhash(8B)] | docid(8B) | codes
        TermValue = dummy PES bitmap
  * Forward term (adjacency list — the new term type this paper adds):
        TermKey  = pathhash(15B) | 0x18 | [shardhash(8B)] | docid(8B)
        TermValue = concatenated 8-byte doc ids, supporting blind appends
                    merged by `merge_adjacency` at consolidation time

Sharded DiskANN (§3.3 "Extending Term Design") prefixes the encoded value
with a shard-key hash so one replica stores a long tail of per-tenant
logical indices in disjoint, contiguous key ranges (cheap to cache, cheap
to scan per tenant).

The port's own copy of ``repro.store.terms`` (no JAX there, but importing it
through ``repro`` loads JAX); both packages read and write the same bytes.
"""
from __future__ import annotations

import hashlib
import struct
from typing import Iterator, Optional

import numpy as np

QUANT_TERM = 0x17
ADJ_TERM = 0x18
# Inverted property term (the predicate/WHERE-clause term kind, §3.3/§3.5):
#     TermKey  = pathhash(15B) | 0x19 | [shardhash(8B)] | valuehash(8B)
#     TermValue = posting bitmap over the partition's doc slots (packed
#                 uint32 little-endian words — the PES bitmap role, for
#                 real this time: predicates compile to AND/OR/NOT over
#                 these postings with zero document scans)
PROP_TERM = 0x19


def path_hash(path: str) -> bytes:
    """15-byte hash of the indexed JSON path ('/embedding')."""
    return hashlib.blake2b(path.encode(), digest_size=15).digest()


def shard_hash(shard_key) -> bytes:
    """8-byte hash of a shard-key value (tenant id, year, ...)."""
    return hashlib.blake2b(repr(shard_key).encode(), digest_size=8).digest()


def value_token(v) -> bytes:
    """Deterministic typed encoding of a scalar property value — the single
    source of value identity shared by predicate canonical keys
    (serve/predicate.py) and property-term hashes, so True ≠ 1 and
    3 ≠ "3" consistently on both sides of the index."""
    if isinstance(v, bool):  # before int: bool is an int subclass
        return b"b:" + (b"1" if v else b"0")
    if isinstance(v, int):
        return b"i:%d" % v
    if isinstance(v, float):
        return b"f:" + repr(v).encode()
    if isinstance(v, str):
        return b"s:" + v.encode()
    if v is None:
        return b"n:"
    raise TypeError(f"unsupported property value type {type(v).__name__}")


def prop_value_hash(value) -> bytes:
    """8-byte hash of a property value for the PROP_TERM key suffix."""
    return hashlib.blake2b(value_token(value), digest_size=8).digest()


def merge_adjacency(base: Optional[bytes], deltas: list[bytes]) -> bytes:
    """Merge callback for blind adjacency appends (§3.3): concatenate and
    de-duplicate doc ids, preserving first-seen order."""
    raw = (base or b"") + b"".join(deltas)
    seen, out = set(), []
    for (doc,) in struct.iter_unpack(">q", raw):
        if doc not in seen:
            seen.add(doc)
            out.append(doc)
    return b"".join(struct.pack(">q", d) for d in out)


class TermCodec:
    def __init__(self, path: str = "/embedding"):
        self.prefix = path_hash(path)

    # -- keys ---------------------------------------------------------------
    def quant_key(self, doc_id: int, shard=None) -> bytes:
        mid = shard_hash(shard) if shard is not None else b""
        return self.prefix + bytes([QUANT_TERM]) + mid + struct.pack(">q", doc_id)

    def adj_key(self, doc_id: int, shard=None) -> bytes:
        mid = shard_hash(shard) if shard is not None else b""
        return self.prefix + bytes([ADJ_TERM]) + mid + struct.pack(">q", doc_id)

    def quant_prefix(self, shard=None) -> bytes:
        mid = shard_hash(shard) if shard is not None else b""
        return self.prefix + bytes([QUANT_TERM]) + mid

    def adj_prefix(self, shard=None) -> bytes:
        mid = shard_hash(shard) if shard is not None else b""
        return self.prefix + bytes([ADJ_TERM]) + mid

    @staticmethod
    def prop_key(path: str, value, shard=None) -> bytes:
        """Inverted property-term key: the property path is hashed like the
        vector path (each indexed path owns a contiguous key range), the
        value hashed through the SAME typed token as predicate canonical
        keys, so a predicate and the ingest path can never disagree about
        value identity."""
        mid = shard_hash(shard) if shard is not None else b""
        return path_hash(path) + bytes([PROP_TERM]) + mid + prop_value_hash(value)

    # -- values -------------------------------------------------------------
    @staticmethod
    def encode_posting(words) -> bytes:
        """Posting bitmap value: packed uint32 words, little-endian."""
        return np.asarray(words, dtype="<u4").tobytes()

    @staticmethod
    def decode_posting(v: bytes) -> np.ndarray:
        return np.frombuffer(v, dtype="<u4").astype(np.uint32)

    # -- values -------------------------------------------------------------
    @staticmethod
    def encode_quant_value(codes: bytes, version: int) -> bytes:
        return bytes([version]) + codes

    @staticmethod
    def decode_quant_value(v: bytes) -> tuple[bytes, int]:
        return v[1:], v[0]

    @staticmethod
    def encode_adjacency(doc_ids) -> bytes:
        return b"".join(struct.pack(">q", int(d)) for d in doc_ids)

    @staticmethod
    def decode_adjacency(v: bytes) -> list[int]:
        return [doc for (doc,) in struct.iter_unpack(">q", v)]

    @staticmethod
    def decode_doc_id(key: bytes) -> int:
        return struct.unpack(">q", key[-8:])[0]
