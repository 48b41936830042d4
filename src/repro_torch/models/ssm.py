"""State-space sequence mixers: Mamba2 (SSD) and RWKV6 (Finch) (the port of
``repro.models.ssm``).

Both run in the reference's *chunkwise-parallel* form: within a chunk the
interactions are (Q, Q) masked products, and only the O(S/Q) chunk carry
runs as a loop (a Python loop here, where the reference scans or unrolls:
the same steps either way). Every chunk's own terms are computed at once,
the chunks stacked on the batch dim, so only the carry costs a dispatch per
chunk. Single-token recurrent steps serve decode.

Mamba2 recurrence (per head h, state S ∈ R^{hd×ds}):
    S_t = exp(dt_t·A_h)·S_{t-1} + dt_t·(x_t ⊗ B_t);   y_t = S_t·C_t + D_h·x_t

RWKV6 recurrence (per head, state S ∈ R^{dk×dv}, per-channel decay w):
    o_t = r_t·(S_{t-1} + diag(u)·k_tᵀv_t);   S_t = diag(w_t)·S_{t-1} + k_tᵀv_t

The reference's rules hold: the exponentials of cumulative decays run in
f32; ``A_log``, ``D``, ``dt_bias``, ``w0`` and ``u`` stay f32 in a bf16
model; a forward without state pads the sequence to a chunk multiple, and
one that returns the state (a prefill) of another length raises. A Mamba2
step on an f32 cache with bf16 activations runs its conv in f32, as JAX's
promotion makes the reference's (torch's einsum does not promote, so the
step casts first). Two deliberate differences. Mamba2's intra-chunk decay
exp(l_i - l_j) is taken of an exponent masked to the causal part: the
values are the reference's bit for bit, but its gradient is finite where
the reference's, which exponentiates the whole (Q, Q) grid, is NaN once a
chunk's cumulative decay passes ~88 (zamba2-1.2b's chunk of 128). And
``rwkv6_step`` reads its token-shift carry in the activations' dtype. The
carry holds earlier activations, so this loses nothing, and it keeps the
step's output in that dtype; the reference promotes it to f32 when the cache is f32, which its
layer scan then refuses (a bf16 RWKV6 model cannot decode on an f32 cache
there), and equals it when the cache is in the activations' dtype.

On a mesh (DTensor activations) the causal conv and both chunk scans run
on each rank's local shards (``sharding.local_split``): the batch over the
data axes, the channels or heads over ``model``, the result in the
reference's layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .config import ModelConfig, SSMConfig
from .layers import dense_init, rmsnorm, rmsnorm_init
from .sharding import local_split


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _chunked(S: int, chunk: int, return_state: bool) -> tuple[int, int]:
    """(Q, Sp): the chunk and the padded length; a prefill must not pad."""
    Q = min(chunk, S)
    Sp = ((S + Q - 1) // Q) * Q
    if Sp != S and return_state:
        raise ValueError(f"prefill length {S} must be a multiple of the chunk {Q}")
    return Q, Sp


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    s: SSMConfig = cfg.ssm
    dm = cfg.d_model
    din = s.expand * dm
    nh = din // s.head_dim
    conv_dim = din + 2 * s.d_state
    dev = gen.device
    return {
        # projections: z (gate), x, B, C, dt
        "in_proj": dense_init(gen, (dm, 2 * din + 2 * s.d_state + nh), dtype),
        "conv_w": dense_init(gen, (s.conv_width, conv_dim), dtype, scale=1.0),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=dev),  # A = -exp(A_log) < 0
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "out_norm": rmsnorm_init(din, dtype, dev),
        "out_proj": dense_init(gen, (din, dm), dtype),
    }


def _split_mamba(cfg: ModelConfig, proj: torch.Tensor):
    s = cfg.ssm
    din = s.expand * cfg.d_model
    nh = din // s.head_dim
    z, xs, Bc, Cc, dt = torch.split(proj, [din, din, s.d_state, s.d_state, nh], dim=-1)
    return z, xs, Bc, Cc, dt, din, nh


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq: x (B,S,C), w (W,C). The reference's
    sum of shifted copies, in its order (``F.conv1d`` sums otherwise). A
    sharded ``x`` convolves on each rank's shards (``sharding.local_split``):
    the batch over the data axes, the channels over ``model`` where they
    divide, ``w`` and ``b`` cut to the same channels."""
    if isinstance(x, DTensor):
        return local_split(_causal_conv, [(x, 0, 2), (w, None, 1), (b, None, 0)],
                           [(tuple(x.shape), 0, 2)], x.shape[2])
    W, S = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(W):
        shift = W - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :S, :]
        out = out + xi * w[i]
    return F.silu(out + b)


def _mamba2_scan(xh, Bc, Cc, dt, A, D, Q: int, Sp: int):
    """The chunked SSD over xh (B,S,nh,hd), Bc, Cc (B,S,ds), dt (B,S,nh), A
    (nh,) in chunks of Q, padded to Sp, with the D (nh,) skip: (y
    (B,S,nh,hd), final state (B,nh,hd,ds)). Every chunk's own terms are
    computed at once, the chunks stacked on the batch dim; only the carry
    loops. Sharded inputs scan on each rank's batch and heads."""
    B, S, nh, hd = xh.shape
    ds = Bc.shape[-1]
    if isinstance(xh, DTensor):
        return local_split(
            _mamba2_scan, [(xh, 0, 2), (Bc, 0, None), (Cc, 0, None), (dt, 0, 2),
                           (A, None, 0), (D, None, 0)],
            [((B, S, nh, hd), 0, 2), ((B, nh, hd, ds), 0, 1)], nh, Q, Sp)
    if Sp != S:
        xh = F.pad(xh, (0, 0, 0, 0, 0, Sp - S))
        Bc, Cc, dt = (F.pad(a, (0, 0, 0, Sp - S)) for a in (Bc, Cc, dt))
    n = Sp // Q
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))

    def chunks(a):  # (B, Sp, ...) -> (n·B, Q, ...), chunk-major
        return a.reshape(B, n, Q, *a.shape[2:]).transpose(0, 1).reshape(n * B, Q, *a.shape[2:])

    xq, bq, cq, dtq = chunks(xh), chunks(Bc), chunks(Cc), chunks(dt)
    la = torch.cumsum(dtq * A, dim=1)  # (n·B,Q,nh) cumulative log-decay <= 0
    # intra-chunk: M_ijh = exp(l_i - l_j) · (C_i·B_j) · dt_j, i >= j
    cb = torch.einsum("bis,bjs->bij", cq, bq)  # (n·B,Q,Q)
    # the exponent masked first: above the diagonal l_i - l_j > 0 can
    # overflow to inf, and the outer where's gradient times inf is NaN
    seg = torch.where(mask[None, :, :, None], la[:, :, None, :] - la[:, None, :, :], -torch.inf)
    dmat = torch.exp(seg)  # (n·B,Q,Q,nh)
    M = torch.where(mask[None, :, :, None], dmat * cb[..., None], 0.0)
    M = M * dtq[:, None, :, :]  # dt at the j (source) index
    y = torch.einsum("bijh,bjhd->bihd", M, xq)
    # each chunk's decay and inflow; the carry runs through them in order
    wj = dtq * torch.exp(la[:, -1:, :] - la)  # (n·B,Q,nh)
    decay = torch.exp(la[:, -1])[:, :, None, None].reshape(n, B, nh, 1, 1)
    inflow = torch.einsum("bjhd,bjs,bjh->bhds", xq, bq, wj).reshape(n, B, nh, hd, ds)
    S_c, S_in = torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=xh.device), []
    for i in range(n):
        S_in.append(S_c)
        S_c = decay[i] * S_c + inflow[i]
    S_in = torch.stack(S_in).reshape(n * B, nh, hd, ds)
    # carry from previous chunks
    y = y + torch.exp(la)[..., None] * torch.einsum("bhds,bis->bihd", S_in, cq)
    y = y.reshape(n, B, Q, nh, hd).transpose(0, 1).reshape(B, Sp, nh, hd)[:, :S]
    return y + D[None, None, :, None] * xh[:, :S], S_c


def mamba2_forward(params, cfg: ModelConfig, x: torch.Tensor, return_state: bool = False):
    """Full-sequence chunked SSD. x (B, S, dm) -> (B, S, dm)[, final state]."""
    s = cfg.ssm
    B, S, dm = x.shape
    proj = x @ params["in_proj"]
    z, xs, Bc, Cc, dt, din, nh = _split_mamba(cfg, proj)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    conv_out = _causal_conv(conv_in, params["conv_w"], params["conv_b"])
    xs, Bc, Cc = torch.split(conv_out, [din, s.d_state, s.d_state], dim=-1)

    hd, ds = s.head_dim, s.d_state
    xh = xs.reshape(B, S, nh, hd).float()
    dt = _softplus(dt.float() + params["dt_bias"])  # (B,S,nh)
    A = -torch.exp(params["A_log"])  # (nh,)
    Bc, Cc = Bc.float(), Cc.float()

    Q, Sp = _chunked(S, s.chunk, return_state)
    y, S_fin = _mamba2_scan(xh, Bc, Cc, dt, A, params["D"], Q, Sp)
    y = y.reshape(B, S, din).to(x.dtype)
    y = rmsnorm(params["out_norm"], y, cfg.norm_eps) * F.silu(z)
    out = y @ params["out_proj"]
    if return_state:
        cw = params["conv_w"].shape[0]
        return out, {"S": S_fin, "conv": conv_in[:, S - (cw - 1):, :]}
    return out


def mamba2_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    s = cfg.ssm
    din = s.expand * cfg.d_model
    nh = din // s.head_dim
    conv_dim = din + 2 * s.d_state
    return {
        "S": torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype, device=device),
    }


def mamba2_step(params, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """One-token decode. x (B, 1, dm) -> (y (B, 1, dm), new state)."""
    s = cfg.ssm
    B = x.shape[0]
    proj = x[:, 0] @ params["in_proj"]
    z, xs, Bc, Cc, dt, din, nh = _split_mamba(cfg, proj)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)  # (B, conv_dim)
    window = torch.cat([state["conv"], conv_in[:, None, :]], dim=1)  # (B,W,C), promoted
    t = torch.promote_types(window.dtype, params["conv_w"].dtype)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window.to(t), params["conv_w"].to(t))
                      + params["conv_b"])
    xs, Bc, Cc = torch.split(conv_out, [din, s.d_state, s.d_state], dim=-1)

    hd = s.head_dim
    xh = xs.reshape(B, nh, hd).float()
    dtp = _softplus(dt.float() + params["dt_bias"])  # (B,nh)
    a = torch.exp(dtp * (-torch.exp(params["A_log"])))  # (B,nh)
    S_new = a[:, :, None, None] * state["S"] + torch.einsum("bhd,bs,bh->bhds", xh, Bc.float(), dtp)
    y = torch.einsum("bhds,bs->bhd", S_new, Cc.float())
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(B, din).to(x.dtype)
    y = rmsnorm(params["out_norm"], y, cfg.norm_eps) * F.silu(z)
    out = (y @ params["out_proj"])[:, None, :]
    return out, {"S": S_new, "conv": window[:, 1:, :]}


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


def rwkv6_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    s: SSMConfig = cfg.ssm
    dm = cfg.d_model
    din = s.expand * dm
    dev = gen.device
    p = {"mu": torch.full((5, dm), 0.5, dtype=dtype, device=dev)}  # r,k,v,g,w token shift
    p.update({w: dense_init(gen, (dm, din), dtype) for w in ("wr", "wk", "wv", "wg")})
    # data-dependent decay (low-rank, as in Finch): dm -> 64 -> din
    p["w_lora_a"] = dense_init(gen, (dm, 64), dtype)
    p["w_lora_b"] = dense_init(gen, (64, din), dtype, scale=0.1)
    p["w0"] = torch.full((din,), -2.0, dtype=torch.float32, device=dev)
    p["u"] = torch.zeros((din,), dtype=torch.float32, device=dev)  # current-token bonus
    p["out_norm"] = rmsnorm_init(din, dtype, dev)
    p["wo"] = dense_init(gen, (din, dm), dtype)
    return p


def _rwkv_streams(params, x: torch.Tensor, x_prev: torch.Tensor):
    """Token-shifted input streams. x (B,S,dm); x_prev (B,1,dm) carry."""
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    mu = params["mu"]
    r_in, k_in, v_in, g_in, w_in = (x + (shifted - x) * mu[i] for i in range(5))
    r = r_in @ params["wr"]
    k = k_in @ params["wk"]
    v = v_in @ params["wv"]
    g = F.silu(g_in @ params["wg"])
    lora = torch.tanh(w_in @ params["w_lora_a"]) @ params["w_lora_b"]
    logw = -torch.exp(params["w0"] + lora.float())  # (B,S,din) <= 0
    return r, k, v, g, logw


def _rwkv6_scan(rh, kh, vh, lw, u, Q: int, Sp: int):
    """The chunked WKV over r, k, v and log decays (B,S,nh,hd) with the
    bonus u (nh,hd), in chunks of Q, padded to Sp: (y (B,S,nh·hd) in f32,
    final state (B,nh,hd,hd)). Every chunk's own terms are computed at
    once, the chunks stacked on the batch dim; only the carry loops.
    Sharded inputs scan on each rank's batch and heads."""
    B, S, nh, hd = rh.shape
    if isinstance(rh, DTensor):
        return local_split(
            _rwkv6_scan, [(rh, 0, 2), (kh, 0, 2), (vh, 0, 2), (lw, 0, 2), (u, None, 0)],
            [((B, S, nh * hd), 0, 2), ((B, nh, hd, hd), 0, 1)], nh, Q, Sp)
    if Sp != S:
        rh, kh, vh, lw = (F.pad(a, (0, 0, 0, 0, 0, Sp - S)) for a in (rh, kh, vh, lw))
    n = Sp // Q
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=rh.device), diagonal=-1)
    rq, kq, vq, lq = (a.reshape(B, n, Q, nh, hd).transpose(0, 1).reshape(n * B, Q, nh, hd)
                      for a in (rh, kh, vh, lw))
    l = torch.cumsum(lq, dim=1)  # (n·B,Q,nh,hd) cumulative log decay
    l_prev = l - lq  # decay up to but excluding i
    r_t = rq * torch.exp(l_prev)
    k_t = kq * torch.exp(-l)
    A = torch.einsum("bihd,bjhd->bhij", r_t, k_t)  # the strict lower part is valid
    A = torch.where(mask[None, None], A, 0.0)
    diag = torch.einsum("bihd,hd,bihd->bhi", rq, u, kq)  # current-token bonus
    y = torch.einsum("bhij,bjhd->bihd", A, vq)
    y = y + diag.permute(0, 2, 1)[..., None] * vq
    # each chunk's decay and inflow; the carry (S_in (B,nh,hd_k,hd_v)) runs
    # through them in order
    decay = torch.exp(l[:, -1]).reshape(n, B, nh, hd)
    inflow = torch.einsum("bjhk,bjhv->bhkv", kq * torch.exp(l[:, -1:] - l), vq)
    inflow = inflow.reshape(n, B, nh, hd, hd)
    S_c, S_in = torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=rh.device), []
    for i in range(n):
        S_in.append(S_c)
        S_c = decay[i][..., None] * S_c + inflow[i]
    S_in = torch.stack(S_in).reshape(n * B, nh, hd, hd)
    # carry
    y = y + torch.einsum("bihk,bhkv->bihv", rq * torch.exp(l_prev), S_in)
    return y.reshape(n, B, Q, nh, hd).transpose(0, 1).reshape(B, Sp, nh * hd)[:, :S], S_c


def rwkv6_forward(params, cfg: ModelConfig, x: torch.Tensor, x_prev=None,
                  return_state: bool = False):
    """Full-sequence chunked WKV. x (B,S,dm) -> (B,S,dm)[, final state]."""
    s = cfg.ssm
    B, S, dm = x.shape
    din = s.expand * dm
    hd = s.head_dim
    nh = din // hd
    if x_prev is None:
        x_prev = torch.zeros((B, 1, dm), dtype=x.dtype, device=x.device)
    r, k, v, g, logw = _rwkv_streams(params, x, x_prev)

    rh, kh, vh = (a.reshape(B, S, nh, hd).float() for a in (r, k, v))
    lw = logw.reshape(B, S, nh, hd)
    u = params["u"].reshape(nh, hd)

    Q, Sp = _chunked(S, s.chunk, return_state)
    y, S_fin = _rwkv6_scan(rh, kh, vh, lw, u, Q, Sp)
    y = y.to(x.dtype)
    y = rmsnorm(params["out_norm"], y, cfg.norm_eps) * g
    out = y @ params["wo"]
    if return_state:
        return out, {"S": S_fin, "shift": x[:, -1:, :]}
    return out


def rwkv6_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    s = cfg.ssm
    din = s.expand * cfg.d_model
    nh = din // s.head_dim
    return {
        "S": torch.zeros((batch, nh, s.head_dim, s.head_dim), dtype=torch.float32, device=device),
        "shift": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
    }


def rwkv6_step(params, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """One-token decode. x (B,1,dm) -> (y (B,1,dm), new state); the shift
    carry is read in x's dtype (see the module's note)."""
    s = cfg.ssm
    B, _, dm = x.shape
    din = s.expand * dm
    hd = s.head_dim
    nh = din // hd
    r, k, v, g, logw = _rwkv_streams(params, x, state["shift"].to(x.dtype))
    rh, kh, vh = (a.reshape(B, nh, hd).float() for a in (r, k, v))
    w = torch.exp(logw.reshape(B, nh, hd))
    u = params["u"].reshape(nh, hd)

    kv = torch.einsum("bhk,bhv->bhkv", kh, vh)
    y = torch.einsum("bhk,bhkv->bhv", rh, state["S"] + u[None, :, :, None] * kv)
    S_new = w[..., None] * state["S"] + kv
    y = y.reshape(B, din).to(x.dtype)
    y = rmsnorm(params["out_norm"], y, cfg.norm_eps) * g[:, 0]
    out = (y @ params["wo"])[:, None, :]
    return out, {"S": S_new, "shift": x}
