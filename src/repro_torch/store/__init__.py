"""The port's store: the Bw-Tree analogue, index-term encodings, RU
governance, WAL recovery and the paged vector tier (the counterpart of
``repro.store``).

The paper stores DiskANN's index terms as key-value pairs in Cosmos DB's
Bw-Tree (§3.3): quantized vectors as *inverted terms*, adjacency lists as a
*forward term* kind supporting blind incremental appends that are merged
at consolidation time.

    bwtree.py    ordered pages + delta chains (blind appends), consolidation
                 at max chain length (15 in §4), page cache with hit/miss
                 accounting, prefix seek / range scan
    terms.py     term-key encodings of Fig 4 / Appendix C
    ru.py        Request Units: the paper's normalized cost currency
    codec.py     the snapshot and WAL bytes (the reference's layout)
    pages.py     the paged full-precision tier's residency ledger
    props.py     inverted property-term postings
    faults.py    crash barriers, WAL damage and the recovery invariants
    provider.py  StoreProviderSet: the provider traits backed by the store,
                 written through to the arrays the port's kernels read
"""
from .bwtree import BwTree, BwTreeStats
from .terms import TermCodec, QUANT_TERM, ADJ_TERM
from .ru import RUMeter, RUConfig
from .provider import StoreProviderSet

__all__ = [
    "BwTree",
    "BwTreeStats",
    "TermCodec",
    "QUANT_TERM",
    "ADJ_TERM",
    "RUMeter",
    "RUConfig",
    "StoreProviderSet",
]
