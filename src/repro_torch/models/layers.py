"""Shared building blocks: norms, RoPE, MLPs, initializers (the port of
``repro.models.layers``).

Parameters are nested ``nn.ParameterDict``s keyed as the reference's
parameter pytree is, so ``p["w1"]`` reads the same weight in both. Every
function is shape-polymorphic over leading batch/seq dims and keeps the
reference's rounding: it computes in the input's dtype, with f32 only where
the reference accumulates or transcendentals run in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def param_dict(tree: dict) -> nn.ParameterDict:
    """A nested ParameterDict over ``tree`` (tensors and dicts of them),
    trainable. Serving runs under ``torch.no_grad`` (``model.prefill``,
    ``decode_step``), so it builds no graph."""
    return nn.ParameterDict({k: param_dict(v) if isinstance(v, dict) else v
                             for k, v in tree.items()})


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _truncated_normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """A normal truncated to [-2, 2], drawn in f32 on the generator's device,
    times ``std``, cast to ``dtype`` (as ``jax.random.truncated_normal``
    is used by the reference)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


def dense_init(gen: torch.Generator, shape, dtype, scale: float = 1.0) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    return _truncated_normal(gen, shape, scale / math.sqrt(fan_in), dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return _truncated_normal(gen, shape, 0.02, dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with the variance accumulated in f32 and the scaling in x's
    own dtype: rsqrt(var + eps) is cast to x.dtype before the products, as
    the reference does (upcasting x would change the last bf16 bit). The
    squares of bf16 values are exact in f32."""
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    inv = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE — full, partial (chatglm-style "2d": rotate half the head dims)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, rotate_dims: int,
                     device=None) -> torch.Tensor:
    """inv_freq (rotate_dims/2,), f32."""
    exps = torch.arange(0, rotate_dims, 2, dtype=torch.float32, device=device) / rotate_dims
    return 1.0 / torch.pow(theta, exps)


def apply_rope(
    x: torch.Tensor,  # (..., S, H, Dh)
    positions: torch.Tensor,  # (..., S)
    theta: float,
    mode: str = "full",
) -> torch.Tensor:
    """Rotate interleaved pairs (dims 0::2 with 1::2) of the first ``rot``
    dims by angles computed in f32; ``partial`` rotates the first Dh/2 and
    passes the rest through."""
    if mode == "none":
        return x
    Dh = x.shape[-1]
    rot = Dh if mode == "full" else Dh // 2
    inv = rope_frequencies(Dh, theta, rot, x.device)  # (rot/2,)
    ang = positions[..., :, None].float() * inv  # (..., S, rot/2)
    cos = torch.cos(ang)[..., :, None, :]  # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    rotated = torch.stack([out1, out2], dim=-1).reshape(xr.shape).to(x.dtype)
    if rot == Dh:
        return rotated
    return torch.cat([rotated, x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, kind: str, dtype) -> dict:
    if kind == "swiglu":
        return {
            "w1": dense_init(gen, (d_model, d_ff), dtype),
            "w3": dense_init(gen, (d_model, d_ff), dtype),
            "w2": dense_init(gen, (d_ff, d_model), dtype),
        }
    return {
        "w1": dense_init(gen, (d_model, d_ff), dtype),
        "w2": dense_init(gen, (d_ff, d_model), dtype),
    }


def mlp_apply(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """SwiGLU, or GELU in its tanh approximation (``jax.nn.gelu``'s
    default; torch's default is the erf form)."""
    if kind == "swiglu":
        h = F.silu(x @ params["w1"]) * (x @ params["w3"])
    else:
        h = F.gelu(x @ params["w1"], approximate="tanh")
    return h @ params["w2"]
