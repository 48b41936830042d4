"""Product Quantization (PQ), §2.1 / §3.4: the port of ``repro.core.pq``.

k-means codebooks from a small sample (the 1000-vector bootstrap schema,
refined from a 25 000-vector sample), encode/decode, per-query ADC lookup
tables, and the cross-schema (versioned) distances that let old and new codes
coexist during re-quantization.

Kernels: ``encode`` and the k-means assignment step run ``pq_encode``;
``adc_distance*`` run ``pq_adc``; ``pairwise_distance`` runs ``flat_l2``. On
CPU tensors each runs its plain PyTorch version.

k-means initialisation draws from an explicit ``torch.Generator`` (the role of
``jax.random`` keys). The two streams differ, so parity with the reference is
tested by feeding its codebooks in; k-means itself is tested by its
properties.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.flat_l2.ops import flat_l2
from ..kernels.pq_adc.ops import pq_adc
from ..kernels.pq_encode.ops import pq_encode

# Paper operating points (§3.4): bootstrap schema after 1000 vectors,
# refine ("re-quantize") after 25 000.
BOOTSTRAP_SAMPLE = 1000
REFINE_SAMPLE = 25000


@dataclasses.dataclass(frozen=True)
class PQSchema:
    """A trained product quantizer: codebooks (M, K, dsub) f32 and its version."""

    codebooks: torch.Tensor
    version: int = 0

    @property
    def M(self) -> int:
        return self.codebooks.shape[0]

    @property
    def K(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def dim(self) -> int:
        return self.M * self.dsub


def _split(x: torch.Tensor, M: int) -> torch.Tensor:
    """(..., D) -> (..., M, dsub)."""
    return x.reshape(*x.shape[:-1], M, x.shape[-1] // M)


# ---------------------------------------------------------------------------
# Training (k-means per subspace, Lloyd iterations; all subspaces at once)
# ---------------------------------------------------------------------------


def _lloyd(sample: torch.Tensor, cent: torch.Tensor, iters: int) -> torch.Tensor:
    """Lloyd iterations over every subspace together: sample (S, D), cent
    (M, K, dsub). The assignment is pq_encode's nearest centroid; empty
    clusters keep their centroid."""
    S = sample.shape[0]
    M, K, dsub = cent.shape
    sub = _split(sample, M)  # (S, M, dsub)
    flat_pts = sub.transpose(0, 1).reshape(M * S, dsub)
    offs = (torch.arange(M, device=sample.device) * K)[:, None]
    for _ in range(iters):
        assign = pq_encode(sample, cent).long().T + offs  # (M, S) flat cluster ids
        counts = torch.zeros(M * K, dtype=torch.float32, device=sample.device)
        counts.index_add_(0, assign.reshape(-1), torch.ones(M * S, device=sample.device))
        sums = torch.zeros((M * K, dsub), dtype=torch.float32, device=sample.device)
        sums.index_add_(0, assign.reshape(-1), flat_pts)
        counts = counts.reshape(M, K, 1)
        cent = torch.where(counts > 0, sums.reshape(M, K, dsub) / counts.clamp_min(1.0), cent)
    return cent


def train_pq(gen: torch.Generator, sample: torch.Tensor, M: int, K: int = 256,
             iters: int = 12) -> PQSchema:
    """Train a PQ schema from a sample (S, D); D must divide into M subspaces.
    Each subspace's K initial centroids are sample rows drawn by ``gen`` (a
    CPU generator, so the draw is the same on every device)."""
    S, D = sample.shape
    if D % M:
        raise ValueError(f"dim {D} not divisible by M={M}")
    sub = _split(sample.float(), M)  # (S, M, dsub)
    picks = []
    for _ in range(M):
        if S >= K:
            picks.append(torch.randperm(S, generator=gen)[:K])
        else:
            picks.append(torch.randint(S, (K,), generator=gen))
    idx = torch.stack(picks).to(sample.device)  # (M, K)
    init = sub[idx, torch.arange(M, device=sample.device)[:, None]]  # (M, K, dsub)
    cent = _lloyd(sample.float().contiguous(), init.contiguous(), iters)
    return PQSchema(codebooks=cent.contiguous(), version=0)


def refine_pq(gen: torch.Generator, schema: PQSchema, sample: torch.Tensor,
              iters: int = 12) -> PQSchema:
    """Re-quantization (§3.4): Lloyd iterations on a larger sample, warm-started
    from the old centroids so codes drift little; bumps the version. ``gen`` is
    unused, as the reference's key is: the warm start is deterministic."""
    del gen
    cent = _lloyd(sample.float().contiguous(), schema.codebooks.contiguous(), iters)
    return PQSchema(codebooks=cent.contiguous(), version=schema.version + 1)


# ---------------------------------------------------------------------------
# Encode / decode
# ---------------------------------------------------------------------------


def encode(schema: PQSchema, x: torch.Tensor) -> torch.Tensor:
    """(..., D) float -> (..., M) uint8 codes."""
    flat = x.reshape(-1, x.shape[-1]).float().contiguous()
    return pq_encode(flat, schema.codebooks).reshape(*x.shape[:-1], schema.M)


def decode(schema: PQSchema, codes: torch.Tensor) -> torch.Tensor:
    """(..., M) uint8 -> (..., D) float32 reconstruction."""
    M = schema.M
    flat = codes.reshape(-1, M).long()
    out = schema.codebooks[torch.arange(M, device=codes.device), flat]  # (N, M, dsub)
    return out.reshape(*codes.shape[:-1], schema.dim)


# ---------------------------------------------------------------------------
# ADC lookup tables + distances
# ---------------------------------------------------------------------------


def adc_lut(schema: PQSchema, q: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """LUT for queries q (..., D): (..., M, K) float32.

    l2: squared L2 between query subvector and centroid.
    ip: negative inner product (so smaller = closer, uniformly min-is-best).
    cosine: callers should pre-normalize; then ip == cosine distance - 1.
    """
    sub = _split(q.float(), schema.M)  # (..., M, dsub)
    cent = schema.codebooks  # (M, K, dsub)
    if metric == "l2":
        lut = ((sub * sub).sum(-1, keepdim=True)
               - 2.0 * torch.einsum("...md,mkd->...mk", sub, cent)
               + (cent * cent).sum(-1))
    elif metric in ("ip", "cosine"):
        lut = -torch.einsum("...md,mkd->...mk", sub, cent)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return lut.float()


def multi_lut(schemas, q: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """LUTs of several coexisting schemas for queries q (..., D): (..., V, M, K).

    During re-quantization old codes (schema v) and new codes (schema v+1)
    coexist; each row is tagged with its schema version and measured against
    the matching LUT. Both LUTs measure against the same query in the
    original space, so the distances are comparable (§3.4)."""
    return torch.stack([adc_lut(s, q, metric) for s in schemas], dim=-3)


def adc_distance_versioned(luts: torch.Tensor, codes: torch.Tensor,
                           versions: torch.Tensor) -> torch.Tensor:
    """ADC with a per-row schema version: luts (V, M, K), codes (..., M) u8,
    versions (...,) -> (...) float32 (the pq_adc kernel's dense form)."""
    M = luts.shape[1]
    flat = codes.reshape(-1, M).contiguous()
    ver = versions.reshape(-1).to(torch.uint8).contiguous()
    d = pq_adc(luts[None].float().contiguous(), flat, ver)[0]
    return d.reshape(codes.shape[:-1])


def adc_distance(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC from one LUT (M, K) to codes (..., M) -> (...) float32."""
    zeros = torch.zeros(codes.shape[:-1], dtype=torch.uint8, device=codes.device)
    return adc_distance_versioned(lut[None], codes, zeros)


def adc_distance_onehot(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The reference's MXU formulation, one-hot(codes) . lut: the same result
    as ``adc_distance`` (kept for parity; the kernel path is the gather)."""
    M, K = lut.shape
    onehot = torch.nn.functional.one_hot(codes.reshape(-1, M).long(), K).to(lut.dtype)
    return torch.einsum("cmk,mk->c", onehot, lut).reshape(codes.shape[:-1])


# ---------------------------------------------------------------------------
# Exact distances (document-store re-rank path)
# ---------------------------------------------------------------------------


def exact_distance(q: torch.Tensor, x: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """q (..., D), x (..., D) -> (...) float32 full-precision distance
    (difference form; the rerank kernel, flat_l2_gathered, computes the same)."""
    if metric == "l2":
        diff = q - x
        return (diff * diff).sum(-1)
    if metric in ("ip", "cosine"):
        return -(q * x).sum(-1)
    raise ValueError(metric)


def pairwise_distance(a: torch.Tensor, b: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """a (N, D), b (M, D) -> (N, M) through the flat_l2 kernel. For l2 the
    result is clamped at 0, where the reference's jnp expansion may dip a
    rounding error below it."""
    return flat_l2(a.contiguous(), b.contiguous(), metric)
