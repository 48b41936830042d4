"""Architecture registry: ``--arch <id>`` → config (the port's copy of
``repro.configs``).

Ten assigned architectures (each with full + smoke configs) plus the
paper's own vector-search workload (`cosmosann`). Shapes in shapes.py,
whose stand-ins are tensors on ``device="meta"``.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig
from .shapes import SHAPES, ShapeSpec, cell_supported, input_specs

ARCH_IDS = [
    "starcoder2-15b",
    "chatglm3-6b",
    "qwen3-14b",
    "smollm-135m",
    "qwen3-moe-235b-a22b",
    "deepseek-v2-lite-16b",
    "hubert-xlarge",
    "paligemma-3b",
    "zamba2-1.2b",
    "rwkv6-7b",
]

_MODULES = {
    "starcoder2-15b": "starcoder2_15b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen3-14b": "qwen3_14b",
    "smollm-135m": "smollm_135m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "hubert-xlarge": "hubert_xlarge",
    "paligemma-3b": "paligemma_3b",
    "zamba2-1.2b": "zamba2_1p2b",
    "rwkv6-7b": "rwkv6_7b",
    "cosmosann": "cosmosann",
}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__)


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ShapeSpec",
    "cell_supported",
    "input_specs",
    "get_config",
    "get_smoke_config",
]
