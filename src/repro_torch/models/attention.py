"""Attention: GQA/MQA with qk_norm and the RoPE variants (the port of
``repro.models.attention``).

Three entry points:
  * ``gqa_train``   — full-sequence self-attention (causal or bidirectional);
  * ``gqa_prefill`` — same, but also writes the KV cache;
  * ``gqa_decode``  — one new token against a cache of ``cache_len`` tokens.

The formulation is the reference's, in plain tensor ops: scores in the
compute dtype cast to f32 and divided by sqrt(Dh), a -1e30 mask, an f32
softmax whose weights are cast back before the PV product. No fused
attention call is used: it rounds differently.

The port writes a KV cache in place (the reference returns an updated
copy) and returns it, so a caller keeps using the returned cache as it
would the reference's. The sequence-sharded caches and context-parallel
constraints of the reference need a mesh and have no counterpart here.

MLA (DeepSeek-V2) is not ported yet: its functions raise.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .config import ModelConfig
from .layers import apply_rope, dense_init, rmsnorm, rmsnorm_init

NEG_INF = -1e30
MLA_TODO = "MLA attention is not ported yet (ROADMAP §1 item 14: MoE and MLA)"


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, H_kv, Dh)
    v: torch.Tensor  # (B, S_max, H_kv, Dh)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def gqa_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    dm, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (dm, H * Dh), dtype),
        "wk": dense_init(gen, (dm, Hkv * Dh), dtype),
        "wv": dense_init(gen, (dm, Hkv * Dh), dtype),
        "wo": dense_init(gen, (H * Dh, dm), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(Dh, dtype, gen.device)
        p["k_norm"] = rmsnorm_init(Dh, dtype, gen.device)
    return p


def _qkv(params, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(B, S, H, Dh)
    k = (x @ params["wk"]).reshape(B, S, Hkv, Dh)
    v = (x @ params["wv"]).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope)
    return q, k, v


def _attend(qg, k, v, mask: Optional[torch.Tensor], Dh: int):
    """qg (B,Sq,Hkv,G,Dh) against k, v (B,Sk,Hkv,Dh), where ``mask`` (None:
    every key) broadcasts to (B,Hkv,G,Sq,Sk) → (B,Sq,Hkv,G,Dh) in q's dtype."""
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores / math.sqrt(Dh)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(qg.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", w, v)


def _sdpa_core(q, k, v, H, Hkv, causal: bool, q_offset: int = 0):
    """q (B,Sq,H,Dh) × k,v (B,Sk,Hkv,Dh) → (B,Sq,H*Dh). f32 softmax."""
    B, Sq, _, Dh = q.shape
    Sk = k.shape[1]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, Dh)
    mask = None
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        mask = qpos[:, None] >= torch.arange(Sk, device=q.device)[None, :]
    return _attend(qg, k, v, mask, Dh).reshape(B, Sq, H * Dh)


def _sdpa(q, k, v, H, Hkv, causal: bool, q_offset: int = 0, q_chunk: int = 0):
    """SDPA with optional query-block chunking: the peak scores buffer is
    (B, H, q_chunk, Sk) instead of (B, H, Sq, Sk). The reference scans the
    blocks; here a Python loop runs them."""
    Sq = q.shape[1]
    if not q_chunk or Sq <= q_chunk or Sq % q_chunk != 0:
        return _sdpa_core(q, k, v, H, Hkv, causal, q_offset)
    outs = [_sdpa_core(q[:, off:off + q_chunk], k, v, H, Hkv, causal, q_offset + off)
            for off in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1)


def gqa_train(params, cfg: ModelConfig, x, positions) -> torch.Tensor:
    q, k, v = _qkv(params, cfg, x, positions)
    out = _sdpa(q, k, v, cfg.num_heads, cfg.num_kv_heads, cfg.causal,
                q_chunk=cfg.attn_q_chunk)
    return out @ params["wo"]


def gqa_prefill(params, cfg: ModelConfig, x, positions, cache: KVCache):
    """Causal attention over the prompt; writes its k, v into cache[:, :S]."""
    q, k, v = _qkv(params, cfg, x, positions)
    S = x.shape[1]
    cache.k[:, :S] = k.to(cache.k.dtype)
    cache.v[:, :S] = v.to(cache.v.dtype)
    out = _sdpa(q, k, v, cfg.num_heads, cfg.num_kv_heads, causal=True,
                q_chunk=cfg.attn_q_chunk)
    return out @ params["wo"], cache


def gqa_decode(params, cfg: ModelConfig, x, cache: KVCache, cache_len: int):
    """x (B, 1, dm); attends to cache[:cache_len] + itself. The new k, v go
    to position cache_len clamped into [0, S_max - 1], where the reference's
    ``dynamic_update_slice`` clamps its start (a prompt of S_max tokens
    reaches it); RoPE and the mask use cache_len unclamped."""
    B = x.shape[0]
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    S_max = cache.k.shape[1]
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, cfg, x, pos)
    at = min(max(cache_len, 0), S_max - 1)
    cache.k[:, at:at + 1] = k.to(cache.k.dtype)
    cache.v[:, at:at + 1] = v.to(cache.v.dtype)
    qg = q.reshape(B, 1, Hkv, H // Hkv, Dh)
    valid = torch.arange(S_max, device=x.device) <= cache_len  # includes the new token
    out = _attend(qg, cache.k.to(q.dtype), cache.v.to(q.dtype), valid, Dh)
    return out.reshape(B, 1, H * Dh) @ params["wo"], cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): not ported yet
# ---------------------------------------------------------------------------


def mla_init(gen, cfg: ModelConfig, dtype):
    raise NotImplementedError(MLA_TODO)


def mla_train(params, cfg: ModelConfig, x, positions):
    raise NotImplementedError(MLA_TODO)


def mla_prefill(params, cfg: ModelConfig, x, positions, cache):
    raise NotImplementedError(MLA_TODO)


def mla_decode(params, cfg: ModelConfig, x, cache, cache_len):
    raise NotImplementedError(MLA_TODO)
