"""DeepSeek-V2-Lite-16B [arXiv:2405.04434; hf]: MLA (kv_lora=512) + MoE
(64 routed top-6 + 2 shared experts).

Deviation note (DESIGN.md): the real model uses a dense FFN in layer 1 and
160 fractional-width routed experts in some variants; the assignment line
specifies "MoE 64e top-6 … 2 shared", which we implement uniformly across
layers to keep the stack scannable.
"""
from ..models.config import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,  # expert FFN width
        vocab_size=102400,
        rope="full",
        mlp="swiglu",
        mla=MLAConfig(
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=64,
            top_k=6,
            d_ff_expert=1408,
            num_shared_experts=2,
            d_ff_shared=1408,
            capacity_factor=1.25,
            group_size=512,
        ),
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=64,
        vocab_size=256,
        mlp="swiglu",
        mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                      num_shared_experts=1, d_ff_shared=64, group_size=64,
                      capacity_factor=2.0),
        param_dtype="float32",
        compute_dtype="float32",
    )
