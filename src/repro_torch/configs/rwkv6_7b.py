"""RWKV6-7B "Finch" [arXiv:2404.05892; hf]: attention-free, data-dependent
decay. Time-mix dim = d_model (expand=1), 64 heads × 64; channel-mix FFN
d_ff=14336 every layer (relu² in the paper; gelu MLP here — DESIGN.md)."""
from ..models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=64,
        num_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        rope="none",
        mlp="gelu",
        ssm=SSMConfig(kind="rwkv6", head_dim=64, expand=1, chunk=64),
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        rope="none",
        mlp="gelu",
        ssm=SSMConfig(kind="rwkv6", head_dim=16, expand=1, chunk=8),
        param_dtype="float32",
        compute_dtype="float32",
    )
