"""Hopper kernels of the port, one per Pallas kernel of ``repro.kernels``.

    pq_adc       ADC distances, dense (Q-Flat) and gathered/versioned (beam rounds)
    pq_encode    nearest centroid per PQ subspace (ingest, k-means assignment)
    topk_select  L smallest per row, ties to the lower position
    flat_l2      full-precision distances, dense and gathered (rerank)

Each subpackage holds ``kernel.cu`` (CUDA C++ for sm_90a with a plain C
launcher), ``ref.py`` (the plain PyTorch version) and ``ops.py`` (the wrapper:
the plain version for CPU tensors, the kernel for CUDA tensors, and a launch
counter). ``_build`` compiles the sources with nvcc at first use.
"""
from __future__ import annotations

from .flat_l2.ops import flat_l2, flat_l2_gathered
from .pq_adc.ops import pq_adc
from .pq_encode.ops import pq_encode
from .topk_select.ops import topk_select

# one launch counter per CUDA kernel: (wrapper, the attribute it counts in)
COUNTERS = {
    "pq_adc.gathered": (pq_adc, "gathered_launches"),
    "pq_adc.gathered_l2": (pq_adc, "gathered_l2_launches"),
    "pq_adc.dense": (pq_adc, "dense_launches"),
    "topk_select.rank": (topk_select, "rank_launches"),
    "topk_select.long": (topk_select, "long_launches"),
    "topk_select.sort": (topk_select, "sort_launches"),
    "topk_select.radix": (topk_select, "radix_launches"),
    "flat_l2.dense": (flat_l2, "launches"),
    "flat_l2.dense_bf16": (flat_l2, "bf16_launches"),
    "flat_l2.gathered": (flat_l2_gathered, "launches"),
    "pq_encode": (pq_encode, "launches"),
}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def encode_launches_by_rows() -> dict[int, int]:
    """pq_encode's launches since the last reset, by rows encoded: an insert
    mini-batch, the bootstrap and the refinement differ in time."""
    return dict(pq_encode.launches_by_rows)


def reset_launch_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    pq_encode.launches_by_rows = {}
