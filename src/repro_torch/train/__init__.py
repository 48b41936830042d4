"""repro_torch.train — optimizer, data pipeline, checkpointing, compression
(the port of ``repro.train``)."""
from .optimizer import OptConfig, OptState, adamw_update, init_opt_state
from . import checkpoint, compression, data

__all__ = ["OptConfig", "OptState", "adamw_update", "init_opt_state",
           "checkpoint", "compression", "data"]
