"""Declarative predicate AST — the WHERE clause of the paper's query model.

The paper's interface is declarative: ``SELECT TOP k ... WHERE <predicate>
ORDER BY VectorDistance(...)`` (§3.3, §3.5, Fig 9), with scalar predicates
answered from index terms in the Bw-Tree, not by scanning documents. This
module is the client-side half of that contract: a small combinator
language

    F.eq("label", 3)                        equality on one indexed path
    F.in_("label", [3, 5])                  membership
    F.range("price", 10, 99)                inclusive range
    F.and_(p, q) / (p & q)                  conjunction
    F.or_(p, q) / (p | q)                   disjunction
    F.not_(p) / (~p)                        complement (over present docs)

whose nodes are **canonicalizable** (commutative operators sort their
children, ``in_`` sorts + dedups, double negation cancels), **hashable**
(`key()` is a deterministic byte encoding of the canonical form — two
semantically-identical predicates batch together in the serving engine's
micro-batcher), and **serializable** (`to_obj()`/`from_obj()` round-trip
through JSON-safe structures).

The server-side half is ``store.props.PropertyTermIndex``: each node
compiles to a few bitmap AND/OR/NOT operations over per-(path, value)
posting bitmaps — ``compile_words`` below — with **zero document scans**.
``matches(doc)`` is the host-side reference semantics (used by tests and
the legacy-callable comparison paths, never by the compiled hot path).

The port's own copy of ``repro.serve.predicate`` (no JAX there, but
importing it through ``repro`` loads JAX): the same canonical forms, the
same ``key()`` bytes, the same bitmap algebra.

Semantics notes:
  * leaf predicates match only documents that HAVE the path with a
    matching value; ``not_`` complements within the set of present
    documents of a partition (absent-field docs match ``~F.eq(p, v)``);
  * paths address nested fields with ``/`` (``"meta/genre"``); list
    elements index as multi-valued terms (Cosmos array semantics), so
    ``F.eq("tags", "x")`` matches docs whose ``tags`` list contains "x";
  * ``range`` bounds are inclusive on both ends and only match values
    comparable to the bounds (a string value never matches a numeric
    range).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Sequence

import numpy as np

from ..store.terms import value_token

Scalar = (str, int, float, bool, type(None))


def _check_scalar(v: Any) -> Any:
    if not isinstance(v, Scalar):
        raise TypeError(
            f"predicate values must be scalars, got {type(v).__name__}"
        )
    return v


class Predicate:
    """Base combinator node. Immutable; equality/hash follow the canonical
    byte key so semantically-identical predicates coalesce in dict/set
    keys (and therefore in the engine's micro-batch groups)."""

    __slots__ = ("_key",)

    # -- combinators -----------------------------------------------------
    def __and__(self, other: "Predicate") -> "Predicate":
        return F.and_(self, other)

    def __or__(self, other: "Predicate") -> "Predicate":
        return F.or_(self, other)

    def __invert__(self) -> "Predicate":
        return F.not_(self)

    # -- identity --------------------------------------------------------
    def key(self) -> bytes:
        """Canonical byte encoding (cached): the batching/caching key."""
        k = getattr(self, "_key", None)
        if k is None:
            k = self.canonical()._encode()
            object.__setattr__(self, "_key", k)
        return k

    def __eq__(self, other) -> bool:
        return isinstance(other, Predicate) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    # -- interface (per node) -------------------------------------------
    def canonical(self) -> "Predicate":
        return self

    def _encode(self) -> bytes:
        raise NotImplementedError

    def matches(self, doc: dict) -> bool:
        raise NotImplementedError

    def compile_words(self, idx) -> np.ndarray:
        """Packed uint32 bitmap over the index's slots; ``idx`` is a
        ``store.props.PropertyTermIndex`` (or anything exposing its
        ``posting`` / ``values_for`` / ``universe`` / ``zeros``)."""
        raise NotImplementedError

    def to_obj(self):
        raise NotImplementedError


def _resolve(doc: dict, path: str) -> list:
    """All scalar leaf values at ``path`` ('/'-separated; lists fan out)."""
    nodes = [doc]
    for part in path.split("/"):
        nxt = []
        for n in nodes:
            if isinstance(n, dict) and part in n:
                nxt.append(n[part])
        nodes = nxt
    out = []
    for n in nodes:
        if isinstance(n, list):
            out.extend(x for x in n if isinstance(x, Scalar))
        elif isinstance(n, Scalar):
            out.append(n)
    return out


def _cmp_in_range(v, lo, hi) -> bool:
    try:
        return bool(lo <= v <= hi)
    except TypeError:
        return False


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class Eq(Predicate):
    path: str
    value: Any
    __slots__ = ("path", "value")

    def _encode(self) -> bytes:
        return b"(eq " + self.path.encode() + b" " + value_token(self.value) + b")"

    def matches(self, doc: dict) -> bool:
        t = value_token(self.value)
        return any(value_token(v) == t for v in _resolve(doc, self.path))

    def compile_words(self, idx) -> np.ndarray:
        w = idx.posting(self.path, self.value)
        return w.copy() if w is not None else idx.zeros()

    def to_obj(self):
        return ["eq", self.path, self.value]

    def __repr__(self):
        return f"F.eq({self.path!r}, {self.value!r})"


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class In(Predicate):
    path: str
    values: tuple
    __slots__ = ("path", "values")

    def canonical(self) -> Predicate:
        uniq = {value_token(v): v for v in self.values}
        if len(uniq) == 1:
            return Eq(self.path, next(iter(uniq.values())))
        ordered = tuple(uniq[t] for t in sorted(uniq))
        return In(self.path, ordered)

    def _encode(self) -> bytes:
        toks = b",".join(value_token(v) for v in self.values)
        return b"(in " + self.path.encode() + b" " + toks + b")"

    def matches(self, doc: dict) -> bool:
        present = {value_token(v) for v in _resolve(doc, self.path)}
        return any(value_token(v) in present for v in self.values)

    def compile_words(self, idx) -> np.ndarray:
        out = idx.zeros()
        for v in self.values:
            w = idx.posting(self.path, v)
            if w is not None:
                out |= w
        return out

    def to_obj(self):
        return ["in", self.path, list(self.values)]

    def __repr__(self):
        return f"F.in_({self.path!r}, {list(self.values)!r})"


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class Range(Predicate):
    path: str
    lo: Any
    hi: Any
    __slots__ = ("path", "lo", "hi")

    def _encode(self) -> bytes:
        return (b"(range " + self.path.encode() + b" " + value_token(self.lo)
                + b" " + value_token(self.hi) + b")")

    def matches(self, doc: dict) -> bool:
        return any(
            _cmp_in_range(v, self.lo, self.hi)
            for v in _resolve(doc, self.path)
        )

    def compile_words(self, idx) -> np.ndarray:
        out = idx.zeros()
        for v, w in idx.values_for(self.path):
            if _cmp_in_range(v, self.lo, self.hi):
                out |= w
        return out

    def to_obj(self):
        return ["range", self.path, self.lo, self.hi]

    def __repr__(self):
        return f"F.range({self.path!r}, {self.lo!r}, {self.hi!r})"


def _flatten(kind, children: Sequence[Predicate]) -> Iterator[Predicate]:
    for c in children:
        c = c.canonical()
        if isinstance(c, kind):
            yield from c.children
        else:
            yield c


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class And(Predicate):
    children: tuple
    __slots__ = ("children",)

    def canonical(self) -> Predicate:
        flat = {c._encode(): c for c in _flatten(And, self.children)}
        if len(flat) == 1:
            return next(iter(flat.values()))
        return And(tuple(flat[k] for k in sorted(flat)))

    def _encode(self) -> bytes:
        return b"(and " + b" ".join(c._encode() for c in self.children) + b")"

    def matches(self, doc: dict) -> bool:
        return all(c.matches(doc) for c in self.children)

    def compile_words(self, idx) -> np.ndarray:
        out = self.children[0].compile_words(idx)
        for c in self.children[1:]:
            out &= c.compile_words(idx)
        return out

    def to_obj(self):
        return ["and", [c.to_obj() for c in self.children]]

    def __repr__(self):
        return "(" + " & ".join(repr(c) for c in self.children) + ")"


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class Or(Predicate):
    children: tuple
    __slots__ = ("children",)

    def canonical(self) -> Predicate:
        flat = {c._encode(): c for c in _flatten(Or, self.children)}
        if len(flat) == 1:
            return next(iter(flat.values()))
        return Or(tuple(flat[k] for k in sorted(flat)))

    def _encode(self) -> bytes:
        return b"(or " + b" ".join(c._encode() for c in self.children) + b")"

    def matches(self, doc: dict) -> bool:
        return any(c.matches(doc) for c in self.children)

    def compile_words(self, idx) -> np.ndarray:
        out = self.children[0].compile_words(idx)
        for c in self.children[1:]:
            out |= c.compile_words(idx)
        return out

    def to_obj(self):
        return ["or", [c.to_obj() for c in self.children]]

    def __repr__(self):
        return "(" + " | ".join(repr(c) for c in self.children) + ")"


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class Not(Predicate):
    child: Predicate
    __slots__ = ("child",)

    def canonical(self) -> Predicate:
        c = self.child.canonical()
        if isinstance(c, Not):
            return c.child
        return Not(c)

    def _encode(self) -> bytes:
        return b"(not " + self.child._encode() + b")"

    def matches(self, doc: dict) -> bool:
        return not self.child.matches(doc)

    def compile_words(self, idx) -> np.ndarray:
        return idx.universe() & ~self.child.compile_words(idx)

    def to_obj(self):
        return ["not", self.child.to_obj()]

    def __repr__(self):
        return f"~{self.child!r}"


def _check_path(path: str) -> str:
    """Reject paths the ingest side never indexes: a predicate over them
    would silently compile to an always-empty bitmap while ``matches()``
    (and the legacy callable path) would match — a parity break better
    surfaced at construction time."""
    path = str(path)
    if path in NON_INDEXED_PATHS:
        raise ValueError(
            f"path {path!r} is not property-indexed (it is the document "
            f"key — fetch by id instead of filtering on it)"
        )
    return path


class F:
    """Constructor namespace: ``F.eq/F.in_/F.range/F.and_/F.or_/F.not_``."""

    @staticmethod
    def eq(path: str, value: Any) -> Predicate:
        return Eq(_check_path(path), _check_scalar(value))

    @staticmethod
    def in_(path: str, values) -> Predicate:
        vals = tuple(_check_scalar(v) for v in values)
        if not vals:
            raise ValueError("F.in_ needs at least one value")
        return In(_check_path(path), vals)

    @staticmethod
    def range(path: str, lo: Any, hi: Any) -> Predicate:
        return Range(_check_path(path), _check_scalar(lo), _check_scalar(hi))

    @staticmethod
    def and_(*preds: Predicate) -> Predicate:
        if not preds:
            raise ValueError("F.and_ needs at least one predicate")
        return And(tuple(preds))

    @staticmethod
    def or_(*preds: Predicate) -> Predicate:
        if not preds:
            raise ValueError("F.or_ needs at least one predicate")
        return Or(tuple(preds))

    @staticmethod
    def not_(pred: Predicate) -> Predicate:
        return Not(pred)


def from_obj(obj) -> Predicate:
    """Inverse of ``Predicate.to_obj`` (wire format for SDK transport)."""
    kind = obj[0]
    if kind == "eq":
        return F.eq(obj[1], obj[2])
    if kind == "in":
        return F.in_(obj[1], obj[2])
    if kind == "range":
        return F.range(obj[1], obj[2], obj[3])
    if kind == "and":
        return F.and_(*(from_obj(c) for c in obj[1]))
    if kind == "or":
        return F.or_(*(from_obj(c) for c in obj[1]))
    if kind == "not":
        return F.not_(from_obj(obj[1]))
    raise ValueError(f"unknown predicate node kind {kind!r}")


# ---------------------------------------------------------------------------
# document-side term extraction (ingest path)
# ---------------------------------------------------------------------------

NON_INDEXED_PATHS = frozenset({"id"})


def property_items(doc: dict) -> tuple:
    """Extract the (path, value) property terms a document contributes to
    the inverted property-term index: every scalar leaf, nested paths
    joined with '/', list elements as multi-valued terms. The document key
    (``id``) is not a predicate term — it is served by point lookups."""
    out: list[tuple[str, Any]] = []

    def walk(prefix: str, node):
        if isinstance(node, dict):
            for k, v in node.items():
                p = f"{prefix}/{k}" if prefix else str(k)
                if p in NON_INDEXED_PATHS:
                    continue
                walk(p, v)
        elif isinstance(node, list):
            for v in node:
                if isinstance(v, Scalar):
                    out.append((prefix, v))
        elif isinstance(node, Scalar):
            out.append((prefix, node))

    walk("", doc)
    return tuple(out)
