"""repro_torch.models — the architecture pool as PyTorch models: dense, VLM,
MoE (with MLA), hybrid Mamba2 and RWKV6 stacks, and the audio encoder; the
train, prefill and decode step factories."""
from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from . import model, steps

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "model", "steps"]
