"""Gradient compression with error feedback (the port of
``repro.train.compression``).

Two levers for a slow gradient all-reduce, both error-compensated:

  * bf16 cast (2×) — effectively free in accuracy for gradients;
  * int8 blockwise quantization (4×) with per-block scales and a local
    error-feedback accumulator (the residual added to the next step's
    gradient), so the quantization noise is unbiased over time.

The functions work over the port's parameter list (one gradient per
parameter) in plain torch, as the reference's work over its pytree in
plain jnp. No training path calls them yet: the all-reduce they serve
waits for the port's multi-card decision.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

BLOCK = 256


class Int8Compressed(NamedTuple):
    q: torch.Tensor  # (n_blocks, BLOCK) int8 payload
    scale: torch.Tensor  # (n_blocks,) f32 per-block scales


def int8_compress(g: torch.Tensor) -> tuple[Int8Compressed, torch.Tensor]:
    """Returns (compressed, residual error for feedback, in g's dtype)."""
    flat = g.reshape(-1).float()
    blocks = F.pad(flat, (0, (-flat.shape[0]) % BLOCK)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(-1)[: flat.shape[0]]
    residual = (flat - deq).reshape(g.shape).to(g.dtype)
    return Int8Compressed(q=q, scale=scale[:, 0]), residual


def int8_decompress(c: Int8Compressed, shape, dtype) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return (c.q.float() * c.scale[:, None]).reshape(-1)[:n].reshape(shape).to(dtype)


def compress_grads(grads: Sequence[torch.Tensor], residuals: Sequence[torch.Tensor],
                   mode: str) -> tuple[list, list]:
    """Error-feedback compression of a gradient list.

    mode: 'none' | 'bf16' | 'int8'. Returns (transportable grads,
    residuals)."""
    if mode == "none":
        return list(grads), list(residuals)
    if mode == "bf16":
        return [g.to(torch.bfloat16) for g in grads], list(residuals)
    outs = [int8_compress(g + r.to(g.dtype)) for g, r in zip(grads, residuals)]
    return [c for c, _ in outs], [r for _, r in outs]


def decompress_grads(comp: Sequence, template: Sequence[torch.Tensor], mode: str) -> list:
    if mode == "none":
        return list(comp)
    if mode == "bf16":
        return [g.to(t.dtype) for g, t in zip(comp, template)]
    return [int8_decompress(c, t.shape, t.dtype) for c, t in zip(comp, template)]


def init_residuals(params: Sequence[torch.Tensor], mode: str) -> list:
    if mode != "int8":
        return [torch.zeros((), dtype=torch.float32, device=p.device) for p in params]
    return [torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device) for p in params]
