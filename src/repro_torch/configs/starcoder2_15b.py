"""StarCoder2-15B [arXiv:2402.19173; hf]: dense, GQA(kv=4), RoPE, gelu MLP."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        rope="full",
        mlp="gelu",
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=8,
        num_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
        rope="full",
        mlp="gelu",
        param_dtype="float32",
        compute_dtype="float32",
    )
