"""repro_torch.models — the architecture pool as PyTorch models (dense and
VLM GQA transformers; MoE, MLA and SSM blocks are not ported yet)."""
from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from . import model

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "model"]
