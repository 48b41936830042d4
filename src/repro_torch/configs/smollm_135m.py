"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M; hf]: llama-arch small."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        num_layers=30,
        d_model=576,
        num_heads=9,
        num_kv_heads=3,
        head_dim=64,
        d_ff=1536,
        vocab_size=49152,
        rope="full",
        mlp="swiglu",
        tie_embeddings=True,
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m-smoke",
        family="dense",
        num_layers=2,
        d_model=96,
        num_heads=3,
        num_kv_heads=1,
        head_dim=32,
        d_ff=192,
        vocab_size=256,
        rope="full",
        mlp="swiglu",
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
    )
