"""PaliGemma-3B [arXiv:2407.07726; hf]: SigLIP + Gemma decoder (MQA kv=1).

The SigLIP vision tower is a STUB per the assignment: `input_specs()`
provides 256 precomputed patch embeddings per image, prepended to the token
stream. DESIGN.md notes the prefix-LM → causal-mask simplification.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=257216,
        rope="full",
        mlp="swiglu",  # gemma GeGLU ≈ gated MLP
        input_mode="vlm",
        num_image_tokens=256,
        tie_embeddings=True,
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b-smoke",
        family="vlm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=256,
        rope="full",
        mlp="swiglu",
        input_mode="vlm",
        num_image_tokens=8,
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
    )
