"""Model assembly: blocks → stack → train/prefill/decode applies (the port
of ``repro.models.model``, serving half).

Pre-norm residual blocks. Each layer is a ``Block`` (an ``nn.ModuleDict``
of ``norm1``, ``mixer``, ``norm2``, ``ffn``, each a ParameterDict keyed as
the reference's parameter pytree is) in the ``Model``'s ``nn.ModuleList``,
and a Python loop runs the layers where the reference scans a stack of
them. The reference's function names (``block_train``, ``prefill``,
``decode_step``, ...) are thin functions over these modules, with the
reference's signatures.

Covered: dense and VLM GQA transformers and the encoder-only audio stack
(``forward_train``). MoE, MLA and the SSM blocks raise
``NotImplementedError`` naming their ROADMAP item. Training (``loss_fn``,
remat) belongs to a later slice; ``forward_train`` is forward only.
``constrain_batch_dim`` shards over a mesh and is a no-op without one, so
it is dropped. As in the reference, token ids must lie in [0, vocab):
JAX clamps an out-of-range id where torch raises; the engine only feeds
ids the model emitted or the caller gave in range.

Caches are the reference's structure: one ``KVCache`` per ``segments``
run, leaves (seg_len, B, S_max, H_kv, Dh). Prefill and decode write them in
place and return them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from . import attention as attn
from .attention import KVCache
from .config import ModelConfig
from .layers import (dtype_of, embed_init, mlp_apply, mlp_init, param_dict, rmsnorm,
                     rmsnorm_init)

MOE_TODO = "MoE blocks are not ported yet (ROADMAP §1 item 14: MoE and MLA)"
SSM_TODO = "{} blocks are not ported yet (ROADMAP §1 item 15: SSM blocks)"


def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    return kind == "attn" or cfg.family == "ssm"


def _unported(cfg: ModelConfig, kind: str) -> None:
    """Raise for a block this port does not run yet."""
    if kind != "attn":
        raise NotImplementedError(SSM_TODO.format(kind))
    if cfg.mla:
        raise NotImplementedError(attn.MLA_TODO)
    if cfg.moe:
        raise NotImplementedError(MOE_TODO)


class Block(nn.ModuleDict):
    """One layer: ``norm1``, ``mixer`` and, where the kind has an FFN,
    ``norm2`` and ``ffn``."""

    def __init__(self, kind: str, tree: dict):
        super().__init__({k: param_dict(v) for k, v in tree.items()})
        self.kind = kind


class Model(nn.Module):
    """The parameters: ``embed`` (V, dm) for token inputs, ``final_norm``,
    ``lm_head`` (dm, V) unless the embedding is tied, and one ``Block`` per
    layer in ``blocks``."""

    def __init__(self, embed: Optional[torch.Tensor], final_norm: dict,
                 lm_head: Optional[torch.Tensor], blocks: list[Block]):
        super().__init__()
        self.embed = None if embed is None else nn.Parameter(embed, requires_grad=False)
        self.final_norm = param_dict(final_norm)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Block:
    _unported(cfg, kind)
    dt = dtype_of(cfg.param_dtype)
    p = {"norm1": rmsnorm_init(cfg.d_model, dt, gen.device),
         "mixer": attn.gqa_init(gen, cfg, dt)}
    if _has_ffn(cfg, kind):
        p["norm2"] = rmsnorm_init(cfg.d_model, dt, gen.device)
        p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dt)
    return Block(kind, p)


def block_train(p: Block, cfg: ModelConfig, kind: str, x, positions):
    """Returns (x, aux); aux is 0 without MoE."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + attn.gqa_train(p["mixer"], cfg, h, positions)
    if _has_ffn(cfg, kind):
        x = x + mlp_apply(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps), cfg.mlp)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def block_prefill(p: Block, cfg: ModelConfig, kind: str, x, positions, cache: KVCache):
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    mix, cache = attn.gqa_prefill(p["mixer"], cfg, h, positions, cache)
    x = x + mix
    if _has_ffn(cfg, kind):
        x = x + mlp_apply(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps), cfg.mlp)
    return x, cache


def block_decode(p: Block, cfg: ModelConfig, kind: str, x, cache: KVCache, cache_len: int):
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    mix, cache = attn.gqa_decode(p["mixer"], cfg, h, cache, cache_len)
    x = x + mix
    if _has_ffn(cfg, kind):
        x = x + mlp_apply(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps), cfg.mlp)
    return x, cache


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def segments(cfg: ModelConfig) -> list[tuple[str, int]]:
    """Partition the layer pattern into runs of identical block kinds: the
    cache holds one stacked entry per run. With ``force_unroll`` every layer
    is its own length-1 run."""
    pat = cfg.pattern
    if cfg.force_unroll:
        return [(k, 1) for k in pat]
    runs: list[tuple[str, int]] = []
    for k in pat:
        if runs and runs[-1][0] == k:
            runs[-1] = (k, runs[-1][1] + 1)
        else:
            runs.append((k, 1))
    return runs


def init_params(gen: torch.Generator, cfg: ModelConfig, device: DeviceLike = None) -> Model:
    """Seeded weights on ``device`` (the card unless asked otherwise) drawn
    from ``gen``, which must live there: ``torch.Generator(device)``. The
    draws differ from the reference's ``PRNGKey`` streams; parity is held by
    ``params_from_reference``."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, parameters on {dev}")
    dt = dtype_of(cfg.param_dtype)
    blocks = [block_init(gen, cfg, kind) for kind in cfg.pattern]
    embed = lm_head = None
    if cfg.input_mode in ("tokens", "vlm"):
        embed = embed_init(gen, (cfg.vocab_size, cfg.d_model), dt)
    if not cfg.tie_embeddings or cfg.input_mode == "frames":
        lm_head = embed_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    return Model(embed, rmsnorm_init(cfg.d_model, dt, dev), lm_head, blocks)


def params_from_reference(ref_params: dict, cfg: ModelConfig, device: DeviceLike = None) -> Model:
    """The port's model holding the reference's parameter pytree (its
    leaves as numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``): each
    segment's stacked leading L axis is split into per-layer ``Block``s."""
    dev = resolve_device(device)

    def layer(tree, j):
        return {k: layer(v, j) if isinstance(v, dict) else _from_numpy(v[j], dev)
                for k, v in tree.items()}

    blocks = []
    for (kind, ln), seg in zip(segments(cfg), ref_params["blocks"]):
        _unported(cfg, kind)
        blocks += [Block(kind, layer(seg, j)) for j in range(ln)]
    embed, lm_head = (_from_numpy(ref_params[k], dev) if k in ref_params else None
                      for k in ("embed", "lm_head"))
    final = {"scale": _from_numpy(ref_params["final_norm"]["scale"], dev)}
    return Model(embed, final, lm_head, blocks)


def _from_numpy(a, dev: torch.device) -> torch.Tensor:
    """A reference leaf (numpy, bf16 ones as ml_dtypes' bfloat16) on dev."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(a.copy()).to(dev)


def _embed_inputs(model: Model, cfg: ModelConfig, batch: dict):
    """Returns (x (B,S,dm), positions (B,S), target_mask (B,S))."""
    cd = dtype_of(cfg.compute_dtype)
    if cfg.input_mode == "tokens":
        tok = batch["tokens"]
        x = model.embed[tok].to(cd)
        B, S = tok.shape
        pos = torch.arange(S, device=x.device).expand(B, S)
        return x, pos, torch.ones((B, S), dtype=torch.bool, device=x.device)
    if cfg.input_mode == "frames":
        x = batch["frames"].to(cd)
        B, S = x.shape[:2]
        pos = torch.arange(S, device=x.device).expand(B, S)
        return x, pos, torch.ones((B, S), dtype=torch.bool, device=x.device)
    # vlm: image embeddings prepended to token embeddings
    img = batch["image_embeds"].to(cd)  # (B, Ni, dm)
    tok = batch["tokens"]
    x = torch.cat([img, model.embed[tok].to(cd)], dim=1)
    B, S = x.shape[:2]
    pos = torch.arange(S, device=x.device).expand(B, S)
    mask = torch.cat([torch.zeros((B, img.shape[1]), dtype=torch.bool, device=x.device),
                      torch.ones(tok.shape, dtype=torch.bool, device=x.device)], dim=1)
    return x, pos, mask


def _logits(model: Model, cfg: ModelConfig, x):
    tied = cfg.tie_embeddings and model.embed is not None
    head = model.embed.T if tied else model.lm_head
    return (x @ head.to(x.dtype)).float()


@torch.no_grad()
def forward_train(model: Model, cfg: ModelConfig, batch: dict):
    """Returns (logits (B,S,V) f32, target_mask, aux_loss); forward only."""
    x, pos, mask = _embed_inputs(model, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in model.blocks:
        x, a = block_train(blk, cfg, blk.kind, x, pos)
        aux = aux + a
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    return _logits(model, cfg, x), mask, aux


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=torch.bfloat16,
               device: DeviceLike = None) -> list[KVCache]:
    """Decode state: one ``KVCache`` per ``segments(cfg)`` run, leaves
    (seg_len, B, S_max, H_kv, Dh) of zeros."""
    dev = resolve_device(device)
    out = []
    for kind, ln in segments(cfg):
        _unported(cfg, kind)
        shape = (ln, batch, s_max, cfg.num_kv_heads, cfg.resolved_head_dim)
        out.append(KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                           v=torch.zeros(shape, dtype=dtype, device=dev)))
    return out


def _layer_caches(cfg: ModelConfig, cache: list[KVCache]):
    """(layer's cache) per layer in order: views into the segments' stacks."""
    for (_, ln), seg in zip(segments(cfg), cache):
        for j in range(ln):
            yield KVCache(k=seg.k[j], v=seg.v[j])


@torch.no_grad()
def prefill(model: Model, cfg: ModelConfig, batch: dict, cache: list[KVCache]):
    """Process the prompt; returns (last-position logits (B,1,V) f32, the
    cache with the prompt's keys and values written)."""
    x, pos, _ = _embed_inputs(model, cfg, batch)
    for blk, c in zip(model.blocks, _layer_caches(cfg, cache)):
        x, _ = block_prefill(blk, cfg, blk.kind, x, pos, c)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    return _logits(model, cfg, x[:, -1:, :]), cache


@torch.no_grad()
def decode_step(model: Model, cfg: ModelConfig, tokens, cache: list[KVCache], cache_len: int):
    """One decode step at position ``cache_len`` (one int for every row).
    tokens (B, 1) int (or (B, 1, dm) frames); returns (logits (B,1,V) f32,
    the cache with the new keys and values written)."""
    cd = dtype_of(cfg.compute_dtype)
    if cfg.input_mode in ("tokens", "vlm"):
        x = model.embed[tokens].to(cd)  # (B,1,dm)
    else:
        x = tokens.to(cd)
    for blk, c in zip(model.blocks, _layer_caches(cfg, cache)):
        x, _ = block_decode(blk, cfg, blk.kind, x, c, cache_len)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    return _logits(model, cfg, x), cache


def cache_from_reference(ref_cache, device: DeviceLike = None) -> list[KVCache]:
    """The reference's cache (a list of per-segment ``KVCache``s, leaves as
    numpy arrays) as the port's."""
    dev = resolve_device(device)
    return [KVCache(k=_from_numpy(c[0], dev), v=_from_numpy(c[1], dev)) for c in ref_cache]


def cache_to_reference(cache: list[KVCache]) -> list[tuple[np.ndarray, np.ndarray]]:
    """The port's cache as numpy (k, v) per segment, leaf for leaf the
    reference's layout (bf16 leaves as float32 values)."""
    def np_(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return [(np_(c.k), np_(c.v)) for c in cache]
