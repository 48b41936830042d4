"""HuBERT-XLarge [arXiv:2106.07447]: encoder-only audio transformer.

The conv-waveform frontend is a STUB per the assignment: `input_specs()`
provides precomputed frame embeddings (B, S, d_model). Training target is
per-frame classification over the 504-unit codebook (masked-prediction
simplified to full-frame CE). No decode step (encoder-only).
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        input_mode="frames",
        rope="none",
        mlp="gelu",
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke",
        family="audio",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=64,
        causal=False,
        input_mode="frames",
        rope="none",
        mlp="gelu",
        param_dtype="float32",
        compute_dtype="float32",
    )
