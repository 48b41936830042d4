"""Mixture-of-Experts: grouped capacity-based dispatch, Switch/Mesh-TF style
(the port of ``repro.models.moe``).

Tokens are processed in groups of ``group_size``; within each group, top-k
routing builds dispatch/combine tensors (G, E, C) with
C = max(4, int(G·k·cf/E)) slots per expert. Capacity overflow drops the
route (the residual passes through); the gates are the selected experts'
softmax probabilities normalised over the k; shared experts (DeepSeek) run
densely alongside; the Switch load-balance aux loss is returned.

Every step is the reference's, in its order and dtypes: the router in f32,
top-k as k rounds of argmax with the chosen experts masked out (ties to the
lower index, as ``jnp.argmax`` breaks them, which ``torch.topk`` does not
promise), positions by a cumsum over the group in f32, and the dispatch and
combine tensors cast to the compute dtype before the four einsums. As in
the reference, every token routes and takes capacity, the empty slots of a
decode step included. ``route`` is the routing alone, so a caller can read
which expert each route chose and whether it was dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig
from .layers import dense_init, mlp_apply, mlp_init


class Routing(NamedTuple):
    probs: torch.Tensor  # (n, G, E) f32: the router's softmax
    experts: torch.Tensor  # (n, G, k) int64: the expert of each round
    gates: torch.Tensor  # (n, G, k) f32, normalised over the k
    kept: torch.Tensor  # (n, G, k) bool: the route found a slot under capacity
    dispatch: torch.Tensor  # (n, G, E, C) f32 one-hot (token → expert slot)
    combine: torch.Tensor  # (n, G, E, C) f32: dispatch times the gate


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    e: MoEConfig = cfg.moe
    dm = cfg.d_model
    p = {
        "router": dense_init(gen, (dm, e.num_experts), torch.float32),
        "w1": dense_init(gen, (e.num_experts, dm, e.d_ff_expert), dtype),
        "w3": dense_init(gen, (e.num_experts, dm, e.d_ff_expert), dtype),
        "w2": dense_init(gen, (e.num_experts, e.d_ff_expert, dm), dtype),
    }
    if e.num_shared_experts:
        p["shared"] = mlp_init(gen, dm, e.d_ff_shared * e.num_shared_experts, "swiglu", dtype)
    return p


def capacity(e: MoEConfig, n_tok: int) -> tuple[int, int]:
    """(G, C): the group size (one group when n_tok is not a multiple of
    ``group_size``, as in decode) and the slots per expert."""
    G = e.group_size if n_tok % e.group_size == 0 else n_tok
    return G, max(4, int(G * e.top_k * e.capacity_factor / e.num_experts))


def route(params, cfg: ModelConfig, xg: torch.Tensor, C: int) -> Routing:
    """Top-k routing of xg (n, G, dm) into C slots per expert."""
    e = cfg.moe
    E = e.num_experts
    logits = xg.float() @ params["router"].float()  # (n,G,E)
    probs = torch.softmax(logits, dim=-1)
    gates_list, masks, idxs = [], [], []
    remaining = probs
    for _ in range(e.top_k):
        idx = torch.argmax(remaining, dim=-1)  # (n,G): the first of equal maxima
        gate = torch.gather(remaining, -1, idx[..., None])[..., 0]
        onehot = F.one_hot(idx, E).float()
        gates_list.append(gate)
        masks.append(onehot)
        idxs.append(idx)
        remaining = remaining * (1.0 - onehot)
    gates = torch.stack(gates_list, -1)  # (n,G,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    n, G = xg.shape[:2]
    slot = torch.arange(C, device=xg.device, dtype=torch.float32)
    # the sums start from the first route's terms (0 + t = t for these
    # non-negative terms), and the counts from zeros shaped like the masks,
    # so that on a mesh every (n, ...) tensor keeps the routes' sharding
    dispatch = combine = None
    prev_count = torch.zeros_like(masks[0][:, :1])  # (n,1,E)
    kept = []
    for j, m in enumerate(masks):
        pos = torch.cumsum(m, dim=1) - m + prev_count  # (n,G,E)
        fits = (pos < C) & (m > 0)
        # one_hot(pos, C): no slot at all for a position >= C (pos holds
        # whole numbers)
        pos_oh = (pos[..., None] == slot).float()
        d_j = pos_oh * (fits.float() * m)[..., None]  # (n,G,E,C)
        c_j = d_j * gates[..., j][:, :, None, None]
        dispatch = d_j if dispatch is None else dispatch + d_j
        combine = c_j if combine is None else combine + c_j
        prev_count = prev_count + m.sum(dim=1, keepdim=True)
        kept.append(fits.any(-1))
    return Routing(probs, torch.stack(idxs, -1), gates, torch.stack(kept, -1), dispatch,
                   combine)


def moe_apply(params, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, dm) -> (y (B, S, dm), aux_loss () f32)."""
    e = cfg.moe
    B, S, dm = x.shape
    G, C = capacity(e, B * S)
    xg = x.reshape(-1, G, dm)
    r = route(params, cfg, xg, C)

    cd = x.dtype
    x_e = torch.einsum("ngec,ngd->necd", r.dispatch.to(cd), xg)  # (n,E,C,dm)
    h = F.silu(torch.einsum("necd,edf->necf", x_e, params["w1"])) * torch.einsum(
        "necd,edf->necf", x_e, params["w3"])
    y_e = torch.einsum("necf,efd->necd", h, params["w2"])  # (n,E,C,dm)
    y = torch.einsum("ngec,necd->ngd", r.combine.to(cd), y_e).reshape(B, S, dm)

    if e.num_shared_experts:
        y = y + mlp_apply(params["shared"], x, "swiglu")

    # Switch-style load-balance aux: E · Σ_e (frac_tokens_e · frac_probs_e) / k
    frac_tokens = F.one_hot(r.experts, e.num_experts).float().sum(2).mean(dim=1)  # (n,E)
    frac_probs = r.probs.mean(dim=1)  # (n,E)
    aux = e.num_experts * torch.mean(torch.sum(frac_tokens * frac_probs, -1)) / e.top_k
    return y, aux.float()
