"""Core DiskANN algorithms of the port (the counterpart of ``repro.core``).

Public API:
    GraphConfig, GraphState          index configuration / state tensors
    DiskANNIndex                     host-side replica orchestrator
    train_pq / encode / adc_lut ...  product quantization (core.pq)
    batch_greedy_search              Algorithm 1 (quantized space)
    robust_prune / prune_with_vectors     Algorithm 3
    insert_batch_jit / insert_candidates  Algorithms 2 & 5
    inplace_delete / consolidate_chunk    Algorithm 6
    next_page / start_pagination          paginated search (Fig 3)
    brute_force / qflat_scan / rerank     Flat & Q-Flat plans + Fig 5 rerank
"""
from .graph import GraphConfig, GraphState, compute_medoid, empty_state
from .index import DiskANNIndex, QueryStats
from .providers import ArrayProviderSet, Context
from . import pq, search, prune, insert, delete, paginate, flat, recall

__all__ = [
    "GraphConfig",
    "GraphState",
    "empty_state",
    "compute_medoid",
    "DiskANNIndex",
    "QueryStats",
    "ArrayProviderSet",
    "Context",
    "pq",
    "search",
    "prune",
    "insert",
    "delete",
    "paginate",
    "flat",
    "recall",
]
