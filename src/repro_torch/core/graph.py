"""Graph index configuration and state, start node and the packed visited
bitmap: the port of ``repro.core.graph``.

Conventions (as in the reference): capacity-bounded arrays of N_max rows;
``neighbors`` (N_max, R_slack) int32 padded with -1; ``codes`` (N_max, M)
uint8; ``versions`` (N_max,) uint8 schema tags; ``live`` (N_max,) bool.

The bitmap keeps the reference's word layout (bit ``i & 31`` of word
``i >> 5``), but holds the 32-bit words in int64 tensors: PyTorch's uint32
support is partial. Packed uint32 arrays from numpy (``filter_bits``)
convert at the edge with ``bitmap_from_numpy``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


class GraphConfig(NamedTuple):
    """Static index configuration (paper defaults from §4 "Configuration")."""

    capacity: int
    R: int = 32  # degree bound
    slack: float = 1.3  # degree slack before a secondary prune (§4)
    L_build: int = 100  # search list size during construction
    L_search: int = 100  # default search list size for queries
    alpha: float = 1.2  # RobustPrune distance threshold
    M: int = 16  # PQ subspaces (navigation compression)
    metric: str = "l2"
    max_visits: int = 4096  # visited-set capacity for search stats
    batch_size: int = 100  # mini-batch insert size (§2.1: "about 100")
    bootstrap_sample: int = 1000  # §3.4: first PQ schema after this many docs
    refine_sample: int = 25000  # §3.4: re-quantization trigger
    c_replace: int = 3  # Alg 6 replace parameter
    beam_width: int = 4  # query-path beamWidth W (§3.2)

    @property
    def R_slack(self) -> int:
        return int(self.R * self.slack)


class GraphState(NamedTuple):
    """The mutable index terms as dense device tensors, with the reference's
    dtypes."""

    neighbors: torch.Tensor  # (N_max, R_slack) int32, -1 padded
    codes: torch.Tensor  # (N_max, M) uint8
    versions: torch.Tensor  # (N_max,) uint8 PQ schema version per row
    live: torch.Tensor  # (N_max,) bool
    count: torch.Tensor  # () int32 high-watermark of allocated slots
    medoid: torch.Tensor  # () int32 start node

    @property
    def capacity(self) -> int:
        return self.neighbors.shape[0]


def empty_state(cfg: GraphConfig, device: DeviceLike = None) -> GraphState:
    dev = resolve_device(device)
    return GraphState(
        neighbors=torch.full((cfg.capacity, cfg.R_slack), -1, dtype=torch.int32, device=dev),
        codes=torch.zeros((cfg.capacity, cfg.M), dtype=torch.uint8, device=dev),
        versions=torch.zeros((cfg.capacity,), dtype=torch.uint8, device=dev),
        live=torch.zeros((cfg.capacity,), dtype=torch.bool, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        medoid=torch.zeros((), dtype=torch.int32, device=dev),
    )


def degree(state: GraphState) -> torch.Tensor:
    """Out-degree per node."""
    return (state.neighbors >= 0).sum(-1)


def num_live(state: GraphState) -> torch.Tensor:
    return state.live.sum()


def compute_medoid(vectors: torch.Tensor, live: torch.Tensor) -> int:
    """The live vector closest to the live centroid (the start node)."""
    w = live.to(vectors.dtype)
    centroid = (vectors * w[:, None]).sum(0) / w.sum().clamp_min(1.0)
    d = ((vectors - centroid) ** 2).sum(-1)
    d = torch.where(live, d, torch.full_like(d, float("inf")))
    return int(torch.argmin(d))  # first index on ties, as jnp.argmin


# -- packed visited bitmap ---------------------------------------------------


def bitmap_words(capacity: int) -> int:
    return (capacity + 31) // 32


def bitmap_init(capacity: int, batch: int = 1, device=None) -> torch.Tensor:
    """(batch, words) int64 bitmaps, all clear."""
    return torch.zeros((batch, bitmap_words(capacity)), dtype=torch.int64, device=device)


def bitmap_from_numpy(words: np.ndarray, device=None) -> torch.Tensor:
    """Packed uint32 words (numpy, any leading shape) -> int64 tensor."""
    return torch.from_numpy(np.asarray(words, np.uint32).astype(np.int64)).to(device)


def bitmap_to_numpy(bm: torch.Tensor) -> np.ndarray:
    return bm.cpu().numpy().astype(np.uint32)


def bitmap_test(bm: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """bm (B, words), ids (B, K) -> (B, K) bool. ids < 0 report True (seen)."""
    safe = ids.long().clamp(min=0)
    word = bm.gather(1, safe >> 5)
    bit = (word >> (safe & 31)) & 1
    return (ids < 0) | (bit == 1)


def bitmap_or_new(bm: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Set the bits of ids (B, K) that are distinct and not yet set; ids < 0
    are ignored. For such bits a scatter-add of the masks IS the OR. The
    search loop's ids meet that precondition (deduplicated, tested unset)."""
    safe = ids.long().clamp(min=0)
    masks = torch.where(ids >= 0, torch.ones_like(safe) << (safe & 31), torch.zeros_like(safe))
    return bm.scatter_add(1, safe >> 5, masks)


def bitmap_set(bm: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """OR the bits of ids (B, K) into bm; ids < 0 ignored; duplicates and bits
    already set are safe: they are dropped before the scatter-add."""
    from .search import mask_duplicates  # search imports this module

    fresh = (ids >= 0) & ~mask_duplicates(ids) & ~bitmap_test(bm, ids)
    return bitmap_or_new(bm, torch.where(fresh, ids, torch.full_like(ids, -1)))
