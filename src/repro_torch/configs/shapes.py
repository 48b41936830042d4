"""Assigned input shapes and their stand-in tensors (the port's copy of
``repro.configs.shapes``).

LM shapes (assignment):
    train_4k     seq 4096 × global_batch 256   → train_step
    prefill_32k  seq 32768 × global_batch 32   → prefill (serve) step
    decode_32k   seq 32768 × global_batch 128  → decode step (1 token, KV=32k)
    long_500k    seq 524288 × global_batch 1   → decode step (sub-quadratic
                                                  archs only)

Skips (recorded, per assignment):
    encoder-only (hubert) has no decode → decode_32k / long_500k N/A;
    long_500k only for SSM/hybrid archs (pure attention would need a
    500k-entry quadratic softmax cache).

Where the reference returns ``jax.ShapeDtypeStruct``s, ``input_specs``
returns tensors on ``device="meta"``: the same shapes and dtypes, and no
storage.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(supported, reason-if-not) for an (arch × shape) cell."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "500k decode requires sub-quadratic sequence mixing"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor stand-ins for every model input — no allocation."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind == "train":
        if cfg.input_mode == "tokens":
            return {"tokens": sds((B, S), i32)}
        if cfg.input_mode == "frames":
            return {"frames": sds((B, S, cfg.d_model), torch.bfloat16),
                    "labels": sds((B, S), i32)}
        Ni = cfg.num_image_tokens
        return {"tokens": sds((B, S - Ni), i32),
                "image_embeds": sds((B, Ni, cfg.d_model), torch.bfloat16)}

    if shape.kind == "prefill":
        if cfg.input_mode == "tokens":
            return {"tokens": sds((B, S), i32)}
        if cfg.input_mode == "frames":
            return {"frames": sds((B, S, cfg.d_model), torch.bfloat16)}
        Ni = cfg.num_image_tokens
        return {"tokens": sds((B, S - Ni), i32),
                "image_embeds": sds((B, Ni, cfg.d_model), torch.bfloat16)}

    # decode: one new token against an S-token cache
    if cfg.input_mode == "frames":
        return {"tokens": sds((B, 1, cfg.d_model), torch.bfloat16)}
    return {"tokens": sds((B, 1), i32)}
