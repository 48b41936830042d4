"""Zamba2-1.2B [arXiv:2411.15242; hf]: hybrid Mamba2 + periodic attention.

38 blocks, d_model 2048, ssm_state 64; attention blocks (GQA kv=32 = MHA,
head_dim 64, d_ff 8192) every 6th layer. DESIGN.md notes the simplification
of Zamba2's *shared* attention block (+ LoRA per call-site) to independent
attention blocks at the same positions.
"""
from ..models.config import ModelConfig, SSMConfig

_PATTERN = tuple(
    "attn" if (i % 6 == 5) else "mamba2" for i in range(38)
)


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        rope="full",
        mlp="swiglu",
        ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, expand=2, chunk=128),
        block_pattern=_PATTERN,
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        rope="full",
        mlp="swiglu",
        ssm=SSMConfig(kind="mamba2", d_state=16, head_dim=16, expand=2, chunk=16),
        block_pattern=("mamba2", "mamba2", "attn", "mamba2"),
        param_dtype="float32",
        compute_dtype="float32",
    )
