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
would the reference's. On a mesh the cache is a DTensor sharded on its
sequence dim (``models.sharding.cache_specs``): ``sharding.write_at``
writes each rank's positions. Training and prefill attend on each rank's
shards (``sharding.local_attention``): the batch over the data axes, the
kv heads over ``model`` where they divide, else the queries' sequence
(the reference's ``_cp_constrain``); a decode step attends in the
split-KV form against the sequence-sharded cache
(``sharding.split_kv_attention``), which gathers no cache.

MLA (DeepSeek-V2) has the same three entry points. Prefill and train run
the naive form (k_nope and v expanded per head); decode runs the *absorbed*
form, attending in the compressed kv_lora space against a cache of
(c_kv ‖ k_rope) per position. The two round differently, as the
reference's do; each is held against its own counterpart.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import MLAConfig, ModelConfig
from .layers import apply_rope, dense_init, rmsnorm, rmsnorm_init
from torch.distributed.tensor import DTensor

from .sharding import local_attention, local_split, split_kv_attention, write_at

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, H_kv, Dh)   [MLA: (B, S_max, kv_lora + rope)]
    v: torch.Tensor  # (B, S_max, H_kv, Dh)   [MLA: the zero-width (B, 0)]


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
    every key) broadcasts to (B,Hkv,G,Sq,Sk) → (B,Sq,Hkv,G,Dh) in q's dtype.
    Sharded queries of more than one position (train, prefill) attend on
    each rank's shards (``sharding.local_attention``); a decode step's
    query against a sequence-sharded cache takes the split-KV form
    (``sharding.split_kv_attention``)."""
    if isinstance(qg, DTensor):
        if qg.shape[1] > 1:
            return local_attention(_attend, qg, k, v, mask, Dh)
        return split_kv_attention(qg, k, v, mask, Dh, NEG_INF)
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
    write_at(cache.k, 0, k.to(cache.k.dtype))
    write_at(cache.v, 0, v.to(cache.v.dtype))
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
    write_at(cache.k, at, k.to(cache.k.dtype))
    write_at(cache.v, at, v.to(cache.v.dtype))
    qg = q.reshape(B, 1, Hkv, H // Hkv, Dh)
    valid = torch.arange(S_max, device=x.device) <= cache_len  # includes the new token
    out = _attend(qg, cache.k.to(q.dtype), cache.v.to(q.dtype), valid, Dh)
    return out.reshape(B, 1, H * Dh) @ params["wo"], cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    m: MLAConfig = cfg.mla
    dm, H = cfg.d_model, cfg.num_heads
    return {
        "wq": dense_init(gen, (dm, H * (m.qk_nope_head_dim + m.qk_rope_head_dim)), dtype),
        "wdkv": dense_init(gen, (dm, m.kv_lora_rank), dtype),
        "wkr": dense_init(gen, (dm, m.qk_rope_head_dim), dtype),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, dtype, gen.device),
        "wuk": dense_init(gen, (m.kv_lora_rank, H * m.qk_nope_head_dim), dtype),
        "wuv": dense_init(gen, (m.kv_lora_rank, H * m.v_head_dim), dtype),
        "wo": dense_init(gen, (H * m.v_head_dim, dm), dtype),
    }


def _mla_scale(m: MLAConfig) -> float:
    """1 / sqrt(dn + dr), each step rounded to f32 as the reference's is."""
    return float(np.float32(1.0) / np.sqrt(np.float32(m.qk_nope_head_dim + m.qk_rope_head_dim)))


def _mla_q(params, cfg: ModelConfig, x, positions):
    m = cfg.mla
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta, "full")


def _mla_kv(params, cfg: ModelConfig, x, positions):
    """(c_kv (B,S,r), k_rope (B,S,1,dr)): the compressed stream and the
    rotary key shared across heads."""
    c_kv = rmsnorm(params["kv_norm"], x @ params["wdkv"], cfg.norm_eps)
    k_rope = apply_rope((x @ params["wkr"])[:, :, None, :], positions, cfg.rope_theta, "full")
    return c_kv, k_rope


def _mla_attend(q_nope, q_rope, k_nope, k_rope, v, m: MLAConfig, q_offset: int, dtype):
    """One query block of MLA attention: (B,Sq,H,·) against every key;
    sharded tensors attend on each rank's shards (``sharding.local_split``:
    the heads over ``model``, the rotary key, shared across heads, whole)."""
    if isinstance(q_nope, DTensor):
        B, Sq, H = q_nope.shape[:3]
        ins = [(t, 0, 2 if t.shape[2] == H else None) for t in (q_nope, q_rope, k_nope, k_rope, v)]
        return local_split(_mla_attend, ins, [((B, Sq, H, v.shape[3]), 0, 2)], H, m, q_offset,
                           dtype)
    Sq, Sk = q_nope.shape[1], k_nope.shape[1]
    scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkxd->bhqk", q_rope, k_rope)).float() * _mla_scale(m)
    qpos = q_offset + torch.arange(Sq, device=q_nope.device)
    mask = qpos[:, None] >= torch.arange(Sk, device=q_nope.device)[None, :]
    w = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def mla_train(params, cfg: ModelConfig, x, positions) -> torch.Tensor:
    """The naive form: k_nope and v expanded per head from c_kv; queries
    in blocks of ``attn_q_chunk`` where it divides S (a Python loop where
    the reference scans, or unrolls under ``force_unroll``: the same
    blocks either way)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    c_kv, k_rope = _mla_kv(params, cfg, x, positions)
    k_nope = (c_kv @ params["wuk"]).reshape(B, S, H, m.qk_nope_head_dim)
    v = (c_kv @ params["wuv"]).reshape(B, S, H, m.v_head_dim)

    qc = cfg.attn_q_chunk
    if not qc or S <= qc or S % qc != 0:
        out = _mla_attend(q_nope, q_rope, k_nope, k_rope, v, m, 0, x.dtype)
    else:
        out = torch.cat([_mla_attend(q_nope[:, o:o + qc], q_rope[:, o:o + qc], k_nope, k_rope,
                                     v, m, o, x.dtype) for o in range(0, S, qc)], dim=1)
    return out.reshape(B, S, H * m.v_head_dim) @ params["wo"]


def mla_prefill(params, cfg: ModelConfig, x, positions, cache: KVCache):
    """Writes the compressed (c_kv ‖ k_rope) stream into cache.k[:, :S]
    (cache.k (B, S_max, r + dr), cache.v the zero-width (B, 0)) and
    attends in the naive form."""
    c_kv, k_rope = _mla_kv(params, cfg, x, positions)
    S = x.shape[1]
    write_at(cache.k, 0, torch.cat([c_kv, k_rope[:, :, 0, :]], dim=-1).to(cache.k.dtype))
    return mla_train(params, cfg, x, positions), cache


def mla_decode(params, cfg: ModelConfig, x, cache: KVCache, cache_len: int):
    """The absorbed form: W_UK folds into the query and W_UV into the
    output, so the step attends in kv_lora space against the packed cache.
    The new entry goes to cache_len clamped into [0, S_max - 1], as in
    ``gqa_decode``; RoPE and the mask use cache_len unclamped."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.num_heads
    r = m.kv_lora_rank
    S_max = cache.k.shape[1]
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, pos)  # (B,1,H,dn), (B,1,H,dr)
    c_new, r_new = _mla_kv(params, cfg, x, pos)
    at = min(max(cache_len, 0), S_max - 1)
    write_at(cache.k, at, torch.cat([c_new, r_new[:, :, 0, :]], dim=-1).to(cache.k.dtype))
    c_all = cache.k[..., :r].to(x.dtype)  # (B,S,r)
    r_all = cache.k[..., r:].to(x.dtype)  # (B,S,dr)

    wuk = params["wuk"].reshape(r, H, m.qk_nope_head_dim)
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, wuk)  # (B,1,H,r)
    scores = (torch.einsum("bqhr,bkr->bhqk", q_abs, c_all)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, r_all)).float() * _mla_scale(m)
    valid = torch.arange(S_max, device=x.device) <= cache_len
    w = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkr->bqhr", w, c_all)  # (B,1,H,r)
    wuv = params["wuv"].reshape(r, H, m.v_head_dim)
    out = torch.einsum("bqhr,rhd->bqhd", ctx, wuv).reshape(B, 1, H * m.v_head_dim)
    return out @ params["wo"], cache
