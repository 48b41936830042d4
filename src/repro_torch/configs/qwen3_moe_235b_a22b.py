"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf]:
94L MoE, 128 experts top-8, GQA(kv=4), qk_norm."""
from ..models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,  # expert FFN width
        vocab_size=151936,
        rope="full",
        rope_theta=1000000.0,
        qk_norm=True,
        mlp="swiglu",
        moe=MoEConfig(
            num_experts=128,
            top_k=8,
            d_ff_expert=1536,
            capacity_factor=1.25,
            group_size=512,
        ),
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=8,
        num_kv_heads=2,
        head_dim=16,
        d_ff=64,
        vocab_size=256,
        qk_norm=True,
        mlp="swiglu",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, group_size=64,
                      capacity_factor=2.0),
        param_dtype="float32",
        compute_dtype="float32",
    )
