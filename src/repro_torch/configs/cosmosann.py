"""The paper's own workload: a partitioned DiskANN collection at Cosmos
scale, as a distributed-search configuration (the port's copy of
``repro.configs.cosmosann``).

10M Wiki-Cohere-like vectors (768D float32 documents, 96-byte PQ codes,
R=32 graph) sharded one DiskANN index per shard; the query step is
`repro_torch.partition.fanout.distributed_search_fn` (local beam search +
merge). This is the §4 workload the paper evaluates.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class VectorWorkloadConfig:
    name: str = "cosmosann-10m"
    total_vectors: int = 10_000_000
    dim: int = 768
    M: int = 96  # PQ subspaces (96-byte codes, §2.1's OpenAI example rate)
    K: int = 256
    R_slack: int = 41  # R=32 × slack 1.3
    L_search: int = 100
    k: int = 10
    query_batch: int = 128
    metric: str = "l2"
    beam_width: int = 4  # W-way hop batching on the search loop (§3.2)
    # serving control plane (serve.policy): "static" pins every
    # knob; "adaptive" closes the loop — beam width / ingest yield /
    # topology actuate per pump tick from the observability rollups
    policy: str = "static"
    # the adaptive W ladder; warmup compiles every (bucket, L, W) in it
    # once so policy moves never recompile in steady state
    policy_widths: tuple[int, ...] = (1, 2, 4)


def config() -> VectorWorkloadConfig:
    return VectorWorkloadConfig()


def smoke() -> VectorWorkloadConfig:
    return VectorWorkloadConfig(
        name="cosmosann-smoke", total_vectors=2000, dim=32, M=8, R_slack=13,
        L_search=20, k=5, query_batch=4,
    )


def shard_specs(cfg: VectorWorkloadConfig, num_shards: int) -> dict:
    """Meta tensors (shapes and dtypes, no storage) for the shard-stacked
    index arrays + queries; the reference returns ShapeDtypeStructs."""
    n = cfg.total_vectors // num_shards
    S = num_shards

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    return dict(
        neighbors=sds((S, n, cfg.R_slack), torch.int32),
        codes=sds((S, n, cfg.M), torch.uint8),
        versions=sds((S, n), torch.uint8),
        live=sds((S, n), torch.bool),
        vectors=sds((S, n, cfg.dim), torch.float32),
        doc_ids=sds((S, n), torch.int64),
        medoid=sds((S,), torch.int32),
        codebooks=sds((S, cfg.M, cfg.K, cfg.dim // cfg.M), torch.float32),
        queries=sds((cfg.query_batch, cfg.dim), torch.float32),
    )
