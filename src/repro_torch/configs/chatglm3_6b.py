"""ChatGLM3-6B [arXiv:2406.12793; hf]: dense, GQA(kv=2), 2d/partial RoPE."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        rope="partial",  # GLM's 2d rope: rotate half the head dims
        mlp="swiglu",
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=8,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=256,
        rope="partial",
        mlp="swiglu",
        param_dtype="float32",
        compute_dtype="float32",
    )
