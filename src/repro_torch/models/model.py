"""Model assembly: blocks → stack → train/prefill/decode applies (the port
of ``repro.models.model``).

Pre-norm residual blocks. Each layer is a ``Block`` (an ``nn.ModuleDict``
of ``norm1``, ``mixer``, ``norm2``, ``ffn``, each a ParameterDict keyed as
the reference's parameter pytree is) in the ``Model``'s ``nn.ModuleList``,
and a Python loop runs the layers where the reference scans a stack of
them. The reference's function names (``block_train``, ``prefill``,
``decode_step``, ``loss_fn``, ...) are thin functions over these modules,
with the reference's signatures.

Covered: every block of the pool — GQA and MLA attention, the MLP and
MoE FFNs, Mamba2 and RWKV6 mixers — in the dense, VLM, MoE, hybrid and SSM
stacks, and the encoder-only audio stack. The parameters are trainable:
``forward_train`` and ``loss_fn`` run in the caller's grad mode, with the
reference's three remat modes per layer (``_remat_wrap``); ``prefill`` and
``decode_step`` run under ``torch.no_grad``, so serving builds no graph.
``reference_tree`` stacks per-layer tensors (parameters, gradients,
optimizer moments) back into the reference's pytree, and
``load_reference_tree`` copies such a tree into them. On a mesh the
parameters are DTensors (``models.steps``) and ``constrain_batch_dim``
pins the activations' batch dim to the data axes at the reference's
places: after the embedding and after every layer; without a mesh it is a
no-op. As in the reference, token ids must lie in [0, vocab):
JAX clamps an out-of-range id where torch raises; the engine only feeds
ids the model emitted or the caller gave in range.

Caches are the reference's structure: one entry per ``segments`` run, a
``KVCache`` with leaves (seg_len, B, S_max, H_kv, Dh) (MLA: k (seg_len, B,
S_max, r + dr), v (seg_len, B, 0)) or a dict of stacked SSM states
(Mamba2 ``{"S", "conv"}``, RWKV6 ``{"S", "shift"}``). Prefill and decode
write them in place, each leaf in the dtype ``init_cache`` gave it (``S``
always f32), and return them.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import DeviceLike, resolve_device
from . import attention as attn
from . import ssm as ssmmod
from .attention import KVCache
from .config import ModelConfig
from .layers import (dtype_of, embed_init, mlp_apply, mlp_init, param_dict, rmsnorm,
                     rmsnorm_init)
from .moe import moe_apply, moe_init
from .sharding import constrain_batch_dim, vocab_parallel_embedding, vocab_parallel_xent

Cache = Union[KVCache, dict]  # a segment's decode state: KV stacks or SSM states


def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    return kind == "attn" or cfg.family == "ssm"


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
        self.embed = None if embed is None else nn.Parameter(embed)
        self.final_norm = param_dict(final_norm)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)
        self.blocks = nn.ModuleList(blocks)


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Block:
    dt = dtype_of(cfg.param_dtype)
    p = {"norm1": rmsnorm_init(cfg.d_model, dt, gen.device)}
    if kind == "attn":
        p["mixer"] = attn.mla_init(gen, cfg, dt) if cfg.mla else attn.gqa_init(gen, cfg, dt)
    elif kind == "mamba2":
        p["mixer"] = ssmmod.mamba2_init(gen, cfg, dt)
    elif kind == "rwkv6":
        p["mixer"] = ssmmod.rwkv6_init(gen, cfg, dt)
    else:
        raise ValueError(kind)
    if _has_ffn(cfg, kind):
        p["norm2"] = rmsnorm_init(cfg.d_model, dt, gen.device)
        p["ffn"] = (moe_init(gen, cfg, dt) if cfg.moe
                    else mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dt))
    return Block(kind, p)


def _ffn(p: Block, cfg: ModelConfig, kind: str, x):
    """The residual FFN where the kind has one: returns (x, the MoE aux loss
    or None)."""
    if not _has_ffn(cfg, kind):
        return x, None
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if cfg.moe:
        y, aux = moe_apply(p["ffn"], cfg, h)
        return x + y, aux
    return x + mlp_apply(p["ffn"], h, cfg.mlp), None


def _store(cache: dict, state: dict) -> dict:
    """Write an SSM state into the layer's cache view in place (in the
    cache's dtype)."""
    for k, v in state.items():
        cache[k].copy_(v)
    return cache


def block_train(p: Block, cfg: ModelConfig, kind: str, x, positions):
    """Returns (x, aux); aux is 0 without MoE."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        fn = attn.mla_train if cfg.mla else attn.gqa_train
        mix = fn(p["mixer"], cfg, h, positions)
    elif kind == "mamba2":
        mix = ssmmod.mamba2_forward(p["mixer"], cfg, h)
    else:
        mix = ssmmod.rwkv6_forward(p["mixer"], cfg, h)
    x, aux = _ffn(p, cfg, kind, x + mix)
    return x, torch.zeros((), dtype=torch.float32, device=x.device) if aux is None else aux


def block_prefill(p: Block, cfg: ModelConfig, kind: str, x, positions, cache: Cache):
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        fn = attn.mla_prefill if cfg.mla else attn.gqa_prefill
        mix, cache = fn(p["mixer"], cfg, h, positions, cache)
    else:
        fwd = ssmmod.mamba2_forward if kind == "mamba2" else ssmmod.rwkv6_forward
        mix, state = fwd(p["mixer"], cfg, h, return_state=True)
        cache = _store(cache, state)
    x, _ = _ffn(p, cfg, kind, x + mix)
    return x, cache


def block_decode(p: Block, cfg: ModelConfig, kind: str, x, cache: Cache, cache_len: int):
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        fn = attn.mla_decode if cfg.mla else attn.gqa_decode
        mix, cache = fn(p["mixer"], cfg, h, cache, cache_len)
    else:
        step = ssmmod.mamba2_step if kind == "mamba2" else ssmmod.rwkv6_step
        mix, state = step(p["mixer"], cfg, h, cache)
        cache = _store(cache, state)
    x, _ = _ffn(p, cfg, kind, x + mix)
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
    return _init(gen, cfg)


def _init(gen: torch.Generator, cfg: ModelConfig) -> Model:
    dt = dtype_of(cfg.param_dtype)
    blocks = [block_init(gen, cfg, kind) for kind in cfg.pattern]
    embed = lm_head = None
    if cfg.input_mode in ("tokens", "vlm"):
        embed = embed_init(gen, (cfg.vocab_size, cfg.d_model), dt)
    if not cfg.tie_embeddings or cfg.input_mode == "frames":
        lm_head = embed_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    return Model(embed, rmsnorm_init(cfg.d_model, dt, gen.device), lm_head, blocks)


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device: the init functions
    then make storage-free tensors, and draw nothing."""

    device = torch.device("meta")


def param_shapes(cfg: ModelConfig) -> Model:
    """The model's parameters as tensors on ``device="meta"``: every shape
    and dtype, no storage (what ``jax.eval_shape`` of ``init_params`` gives
    the reference)."""
    return _init(_MetaGenerator(), cfg)


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


def _lookup(embed: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """embed[tok]; a sharded embedding (a DTensor) through
    ``sharding.vocab_parallel_embedding``, which keeps the vocab sharded."""
    if isinstance(embed, DTensor):
        return vocab_parallel_embedding(tok, embed)
    return embed[tok]


def _embed_inputs(model: Model, cfg: ModelConfig, batch: dict):
    """Returns (x (B,S,dm), positions (B,S), target_mask (B,S))."""
    cd = dtype_of(cfg.compute_dtype)
    if cfg.input_mode == "tokens":
        tok = batch["tokens"]
        x = _lookup(model.embed, tok).to(cd)
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
    x = torch.cat([img, _lookup(model.embed, tok).to(cd)], dim=1)
    B, S = x.shape[:2]
    pos = torch.arange(S, device=x.device).expand(B, S)
    mask = torch.cat([torch.zeros((B, img.shape[1]), dtype=torch.bool, device=x.device),
                      torch.ones(tok.shape, dtype=torch.bool, device=x.device)], dim=1)
    return x, pos, mask


def _logits(model: Model, cfg: ModelConfig, x):
    tied = cfg.tie_embeddings and model.embed is not None
    head = model.embed.T if tied else model.lm_head
    return (x @ head.to(x.dtype)).float()


_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """'dots': keep the outputs of products without batch dims (``x @ W``
    runs as ``aten.mm``), recompute everything else (the batched attention
    and SSM einsums among it), as ``dots_with_no_batch_dims_saveable``."""
    if op in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn: Callable, remat) -> Callable:
    """remat: 'none' | 'full' (save nothing: each layer's forward runs again
    in the backward pass) | 'dots' (save the products' outputs), per layer
    as the reference wraps ``block_train``."""
    if remat in (False, "none"):
        return fn
    if remat in (True, "full"):
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_products))
    raise ValueError(remat)


def _run_blocks_train(model: Model, cfg: ModelConfig, x, positions, remat="full"):
    """Every layer in order (the reference scans each segment); returns (x,
    the MoE aux summed over layers, f32)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    x = constrain_batch_dim(x)
    for blk in model.blocks:
        f = _remat_wrap(functools.partial(block_train, blk, cfg, blk.kind), remat)
        x, a = f(x, positions)
        x = constrain_batch_dim(x)
        aux_total = aux_total + a
    return x, aux_total


def forward_train(model: Model, cfg: ModelConfig, batch: dict, remat="full"):
    """Returns (logits (B,S,V) f32, target_mask, aux_loss), in the caller's
    grad mode."""
    x, pos, mask = _embed_inputs(model, cfg, batch)
    x, aux = _run_blocks_train(model, cfg, x, pos, remat)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    return _logits(model, cfg, x), mask, aux


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE. The target logit is gathered where the reference contracts
    a one-hot over the vocab (a choice for its vocab-sharded logits): with
    finite logits both give the same value, a sum of zeros and one term
    being exact. Sharded logits (a DTensor) take
    ``sharding.vocab_parallel_xent`` in ``loss_fn``."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (lse - tgt_logit).mean()


def loss_fn(model: Model, cfg: ModelConfig, batch: dict, remat="full"):
    """Next-token CE for causal archs (a VLM's image positions predict
    nothing); frame classification against ``labels`` for encoders.
    Returns (loss + 0.01·aux, (ce, aux))."""
    logits, mask, aux = forward_train(model, cfg, batch, remat)
    sharded = isinstance(logits, DTensor)
    if cfg.causal:
        targets = batch["tokens"]
        start = batch["image_embeds"].shape[1] if cfg.input_mode == "vlm" else 0
        if sharded:
            loss = vocab_parallel_xent(logits, targets, start=start, shift=1)
        else:
            loss = _xent(logits[:, start:][:, :-1], targets[:, 1:])
    elif sharded:
        loss = vocab_parallel_xent(logits, batch["labels"])
    else:
        loss = _xent(logits, batch["labels"])
    return loss + 0.01 * aux, (loss, aux)


# ---------------------------------------------------------------------------
# the reference's stacked pytree
# ---------------------------------------------------------------------------


def _reference_slots(model: Model, cfg: ModelConfig) -> dict:
    """Each parameter's name → (its path in the reference's pytree, its
    layer's index in that segment's leading axis, or None off the
    blocks)."""
    where = [(s, j) for s, (_, ln) in enumerate(segments(cfg)) for j in range(ln)]
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            s, j = where[int(parts[1])]
            out[name] = (("blocks", s, *parts[2:]), j)
        else:
            out[name] = (tuple(parts), None)
    return out


def reference_ndims(model: Model, cfg: ModelConfig) -> list[int]:
    """Each parameter's dimension count in the reference's pytree, in
    ``model.parameters()`` order: a block leaf carries its segment's
    leading L axis there (even a segment of one layer), so it has one more
    than the port's per-layer tensor."""
    return [p.ndim + (j is not None) for p, (_, j) in
            zip(model.parameters(), _reference_slots(model, cfg).values())]


def reference_tree(model: Model, cfg: ModelConfig, values: Optional[list] = None) -> dict:
    """``values`` (tensors in ``model.parameters()`` order, default the
    parameters themselves) keyed as the reference's parameter pytree: each
    segment's layers stacked on a leading axis, ``blocks`` a list of
    segment dicts. Leaves are detached tensors on their own device."""
    values = [p.detach() for p in model.parameters()] if values is None else values
    tree: dict = {"blocks": [{} for _ in segments(cfg)]}
    stacks: dict = {}
    for v, (path, j) in zip(values, _reference_slots(model, cfg).values()):
        if j is None:
            _put(tree, path, v.detach())
        else:
            stacks.setdefault(path, []).append(v.detach())
    for path, layers in stacks.items():
        _put(tree, path, torch.stack(layers))
    return tree


def load_reference_tree(model: Model, cfg: ModelConfig, tree: dict,
                        targets: Optional[list] = None) -> None:
    """Copy a reference-keyed ``tree`` (as ``reference_tree`` gives, on any
    device, or the reference's numpy leaves) into ``targets`` (tensors in
    ``model.parameters()`` order, default the parameters), in place and in
    each target's dtype; a DTensor target takes its shard of the leaf."""
    targets = list(model.parameters()) if targets is None else targets
    leaves: dict = {}  # each numpy leaf converted once, not once a layer
    with torch.no_grad():
        for t, (path, j) in zip(targets, _reference_slots(model, cfg).values()):
            leaf = _get(tree, path)
            if not isinstance(leaf, torch.Tensor):
                if path not in leaves:
                    leaves[path] = _from_numpy(leaf, t.device)
                leaf = leaves[path]
            src = leaf if j is None else leaf[j]
            if isinstance(t, DTensor):  # a sharded parameter: the source on its placements
                src = (src.redistribute(t.device_mesh, t.placements) if isinstance(src, DTensor)
                       else distribute_tensor(src.to(t.device), t.device_mesh, t.placements))
            t.copy_(src)


def _put(tree, path: tuple, leaf) -> None:
    for k in path[:-1]:
        tree = tree[k] if isinstance(k, int) else tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def params_to_reference(model: Model, cfg: ModelConfig) -> dict:
    """The inverse of ``params_from_reference``: the parameters as the
    reference's pytree of stacked numpy leaves (bf16 ones as float32
    values: numpy has no bfloat16 without ml_dtypes)."""
    return _tree_map(_to_numpy, reference_tree(model, cfg))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=torch.bfloat16,
               device: DeviceLike = None) -> list[Cache]:
    """Decode state: one entry per ``segments(cfg)`` run, leaves (seg_len,
    B, ...) of zeros: a ``KVCache`` for attention (GQA (B, S_max, H_kv, Dh)
    k and v; MLA the packed (B, S_max, r + dr) k and a zero-width v), the
    Mamba2 or RWKV6 state dict for SSM blocks."""
    return _zero_cache(cfg, batch, s_max, dtype, resolve_device(device))


def cache_shapes(cfg: ModelConfig, batch: int, s_max: int, dtype=torch.bfloat16) -> list[Cache]:
    """``init_cache``'s structure as tensors on ``device="meta"``: shapes and
    dtypes, no storage."""
    return _zero_cache(cfg, batch, s_max, dtype, torch.device("meta"))


def _zero_cache(cfg: ModelConfig, batch: int, s_max: int, dtype, dev: torch.device) -> list[Cache]:
    def one(kind: str) -> Cache:
        if kind == "attn":
            if cfg.mla:
                m = cfg.mla
                return KVCache(
                    k=torch.zeros((batch, s_max, m.kv_lora_rank + m.qk_rope_head_dim),
                                  dtype=dtype, device=dev),
                    v=torch.zeros((batch, 0), dtype=dtype, device=dev))
            shape = (batch, s_max, cfg.num_kv_heads, cfg.resolved_head_dim)
            return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                           v=torch.zeros(shape, dtype=dtype, device=dev))
        init = ssmmod.mamba2_init_state if kind == "mamba2" else ssmmod.rwkv6_init_state
        return init(cfg, batch, dtype, dev)

    out = []
    for kind, ln in segments(cfg):  # each layer's zeros stacked on a leading seg axis
        c = one(kind)
        out.append({k: v.new_zeros((ln,) + v.shape) for k, v in c.items()} if isinstance(c, dict)
                   else KVCache(*(v.new_zeros((ln,) + v.shape) for v in c)))
    return out


def cache_leaves(seg: Cache) -> list[torch.Tensor]:
    """A segment's leaves in the reference's pytree order."""
    return list(seg.values()) if isinstance(seg, dict) else list(seg)


def _layer_caches(cfg: ModelConfig, cache: list[Cache]):
    """(layer's cache) per layer in order: views into the segments' stacks."""
    for (_, ln), seg in zip(segments(cfg), cache):
        for j in range(ln):
            if isinstance(seg, dict):
                yield {k: v[j] for k, v in seg.items()}
            else:
                yield KVCache(k=seg.k[j], v=seg.v[j])


@torch.no_grad()
def prefill(model: Model, cfg: ModelConfig, batch: dict, cache: list[Cache]):
    """Process the prompt; returns (last-position logits (B,1,V) f32, the
    cache with the prompt's keys and values, or its SSM states, written).
    An SSM prompt must be a multiple of its chunk (or shorter than one)."""
    x, pos, _ = _embed_inputs(model, cfg, batch)
    x = constrain_batch_dim(x)
    for blk, c in zip(model.blocks, _layer_caches(cfg, cache)):
        x, _ = block_prefill(blk, cfg, blk.kind, x, pos, c)
        x = constrain_batch_dim(x)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    return _logits(model, cfg, x[:, -1:, :]), cache


@torch.no_grad()
def decode_step(model: Model, cfg: ModelConfig, tokens, cache: list[Cache], cache_len: int):
    """One decode step at position ``cache_len`` (one int for every row).
    tokens (B, 1) int (or (B, 1, dm) frames); returns (logits (B,1,V) f32,
    the cache with the new keys and values, or the advanced states,
    written)."""
    cd = dtype_of(cfg.compute_dtype)
    if cfg.input_mode in ("tokens", "vlm"):
        x = _lookup(model.embed, tokens).to(cd)  # (B,1,dm)
    else:
        x = tokens.to(cd)
    x = constrain_batch_dim(x)
    for blk, c in zip(model.blocks, _layer_caches(cfg, cache)):
        x, _ = block_decode(blk, cfg, blk.kind, x, c, cache_len)
        x = constrain_batch_dim(x)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    return _logits(model, cfg, x), cache


def cache_from_reference(ref_cache, device: DeviceLike = None) -> list[Cache]:
    """The reference's cache (a list of per-segment ``KVCache``s or state
    dicts, leaves as numpy arrays) as the port's."""
    dev = resolve_device(device)
    return [{k: _from_numpy(v, dev) for k, v in c.items()} if isinstance(c, dict)
            else KVCache(k=_from_numpy(c[0], dev), v=_from_numpy(c[1], dev)) for c in ref_cache]


def cache_to_reference(cache: list[Cache]) -> list:
    """The port's cache as numpy, leaf for leaf the reference's layout: a
    (k, v) tuple per attention segment, a dict per SSM segment (bf16 leaves
    as float32 values)."""
    return [{k: _to_numpy(v) for k, v in c.items()} if isinstance(c, dict)
            else (_to_numpy(c.k), _to_numpy(c.v)) for c in cache]
