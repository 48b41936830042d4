"""Core DiskANN algorithms of the port (the counterpart of ``repro.core``)."""
from .graph import GraphConfig
from .index import DiskANNIndex, QueryStats

__all__ = ["GraphConfig", "DiskANNIndex", "QueryStats"]
