"""Scale-out of the port: logical→physical partitioning, fan-out (the
counterpart of ``repro.partition``).

Cosmos DB collections span physical partitions by hashed partition-key
ranges (§2.2); vector queries fan out to every partition and the SDK merges
partial results client-side (§3.5 "SDK Query Plan", §4.3):

    partitioner.py  Collection: hash ranges → PhysicalPartition (each its own
                    DiskANN index + store + RU governor on the collection's
                    device), split/merge elasticity, 50 GB-partition-limit
                    analogue
    fanout.py       cross-partition scatter/gather with client-side top-k
                    merge, continuation handling, hedged requests, and
                    every partition in one stacked search, on one card
                    or across a mesh's ranks (``SpmdFanout``,
                    ``distributed_search_fn``)
    replica.py      replica sets: quorum writes, failover, read spreading
"""
from .partitioner import Collection, CollectionConfig, PhysicalPartition
from .fanout import (PagedQueryState, PartitionPageCursor, SpmdFanout,
                     distributed_search_fn, fanout_search,
                     paged_fanout_search, start_paged_fanout)
from .replica import ReplicaSet

__all__ = [
    "Collection",
    "CollectionConfig",
    "PhysicalPartition",
    "fanout_search",
    "distributed_search_fn",
    "paged_fanout_search",
    "start_paged_fanout",
    "PagedQueryState",
    "PartitionPageCursor",
    "ReplicaSet",
    "SpmdFanout",
]
