"""Qwen3-14B [hf:Qwen/Qwen3-8B family; hf]: dense, GQA(kv=8), qk_norm."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        rope="full",
        rope_theta=1000000.0,
        qk_norm=True,
        mlp="swiglu",
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=8,
        num_kv_heads=4,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        rope="full",
        qk_norm=True,
        mlp="swiglu",
        param_dtype="float32",
        compute_dtype="float32",
    )
