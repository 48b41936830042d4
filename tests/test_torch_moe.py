"""The port's MoE FFN and MLA attention (``repro_torch.models.moe``,
``repro_torch.models.attention.mla_*``) against the JAX reference's, on the
CPU.

The same inputs, made from a seed with numpy, go through both packages.
The MoE dispatch is compared exactly: the reference's own dispatch and
combine tensors are read from its einsum calls (the module's ``jnp`` is
wrapped for the call; nothing of the reference changes), and must equal the
port's, route for route, slot for slot, drops included. Tolerances: f32
outputs within 1e-5 (the difference of XLA's and torch's summation orders),
the aux loss within 1e-6, bf16 outputs within 1/64 of the result's max-abs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfgs
from repro.models import attention as rattn
from repro.models import moe as rmoe
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe

F32_ATOL = 1e-5
AUX_ATOL = 1e-6
BF16_REL = 1 / 64


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _pair(a: np.ndarray, dtype: str):
    """(jax array, torch tensor) of the same values in ``dtype``."""
    if dtype == "bfloat16":
        return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _tree_pair(tree: dict, dtype: str, keep_f32=()):
    ref, port = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            ref[k], port[k] = _tree_pair(v, dtype)
        else:
            ref[k], port[k] = _pair(v, "float32" if k in keep_f32 else dtype)
    return ref, port


def _close(ref, port, dtype: str, atol: float = F32_ATOL) -> None:
    ref, port = _np(ref), _np(port)
    assert ref.shape == port.shape
    if dtype == "bfloat16":
        np.testing.assert_allclose(port, ref, rtol=0, atol=BF16_REL * np.abs(ref).max())
    else:
        np.testing.assert_allclose(port, ref, rtol=1e-5, atol=atol)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_params(cfg, rng) -> dict:
    e, dm = cfg.moe, cfg.d_model

    def w(*shape, scale=1.0):
        return (scale * rng.randn(*shape) / np.sqrt(shape[-2])).astype(np.float32)

    p = {"router": w(dm, e.num_experts, scale=3.0), "w1": w(e.num_experts, dm, e.d_ff_expert),
         "w3": w(e.num_experts, dm, e.d_ff_expert), "w2": w(e.num_experts, e.d_ff_expert, dm)}
    if e.num_shared_experts:
        f = e.d_ff_shared * e.num_shared_experts
        p["shared"] = {"w1": w(dm, f), "w3": w(dm, f), "w2": w(f, dm)}
    return p


class _RefDispatch:
    """Stands in for ``jnp`` inside ``repro.models.moe`` for one call,
    keeping the dispatch and combine tensors its einsums take."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if spec == "ngec,ngd->necd":
            self.seen["dispatch"] = np.asarray(ops[0].astype(jnp.float32))
        elif spec == "ngec,necd->ngd":
            self.seen["combine"] = np.asarray(ops[0].astype(jnp.float32))
        return jnp.einsum(spec, *ops, **kw)


def _moe_both(monkeypatch, cfg, B, S, dtype="float32", seed=0):
    rng = np.random.RandomState(seed)
    ref_p, port_p = _tree_pair(_moe_params(cfg, rng), dtype, keep_f32=("router",))
    xj, xt = _pair(rng.randn(B, S, cfg.d_model).astype(np.float32), dtype)
    rec = _RefDispatch()
    with monkeypatch.context() as m:
        m.setattr(rmoe, "jnp", rec)
        y_ref, aux_ref = rmoe.moe_apply(ref_p, cfg, xj)
    routes = []
    route = tmoe.route
    with monkeypatch.context() as m:
        m.setattr(tmoe, "route", lambda *a: routes.append(route(*a)) or routes[-1])
        y, aux = tmoe.moe_apply(port_p, cfg, xt)
    assert len(routes) == 1
    return (y_ref, aux_ref, rec.seen), (y, aux, routes[0])


CFG = rcfgs.get_smoke_config("deepseek-v2-lite-16b")  # 8 experts top-2, 1 shared, G = 64


@pytest.mark.parametrize("B,S,groups", [(1, 64, 1), (3, 64, 3), (2, 20, 1)],
                         ids=["one_group", "three_groups", "ragged_tokens"])
def test_moe_apply_matches_reference(monkeypatch, B, S, groups):
    (y_ref, aux_ref, seen), (y, aux, r) = _moe_both(monkeypatch, CFG, B, S)
    G, C = tmoe.capacity(CFG.moe, B * S)
    assert r.dispatch.shape == (groups, G, CFG.moe.num_experts, C)
    np.testing.assert_array_equal(_np(r.dispatch), seen["dispatch"])
    # the gates: softmax of router logits summed in another order
    np.testing.assert_allclose(_np(r.combine), seen["combine"], rtol=1e-5, atol=1e-6)
    _close(y_ref, y, "float32")
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=0, atol=AUX_ATOL)
    # the routing read back: each route's expert, and kept iff it holds a slot
    slots = r.dispatch.sum(-1)  # (n,G,E)
    held = torch.gather(slots, -1, r.experts)
    assert torch.equal(held > 0, r.kept)


def test_moe_overflow_drops_routes_like_the_reference(monkeypatch):
    cfg = dataclasses.replace(CFG, moe=dataclasses.replace(CFG.moe, capacity_factor=0.25))
    (y_ref, aux_ref, seen), (y, aux, r) = _moe_both(monkeypatch, cfg, 2, 64, seed=1)
    assert tmoe.capacity(cfg.moe, 128) == (64, 4)
    dropped = int((~r.kept).sum())
    assert dropped > 0
    # every route (token, round) either holds one slot or none
    assert int(seen["dispatch"].sum()) == r.kept.numel() - dropped
    np.testing.assert_array_equal(_np(r.dispatch), seen["dispatch"])
    _close(y_ref, y, "float32")
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=0, atol=AUX_ATOL)


def test_moe_bf16_matches_reference(monkeypatch):
    cfg = dataclasses.replace(rcfgs.get_smoke_config("qwen3-moe-235b-a22b"),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    (y_ref, aux_ref, seen), (y, aux, r) = _moe_both(monkeypatch, cfg, 2, 32, "bfloat16", seed=2)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(r.dispatch), seen["dispatch"])
    _close(y_ref, y, "bfloat16")
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=0, atol=AUX_ATOL)


def test_moe_ties_go_to_the_lower_expert():
    """Equal router probabilities: each round takes the lowest unchosen
    expert, as jnp.argmax does."""
    cfg = CFG
    p = {"router": torch.zeros((cfg.d_model, cfg.moe.num_experts))}
    r = tmoe.route(p, cfg, torch.randn(1, 6, cfg.d_model), 4)
    assert r.experts.tolist() == [[[0, 1]] * 6]
    assert torch.allclose(r.gates, torch.full_like(r.gates, 0.5))
    assert r.kept[0, :4].all() and not r.kept[0, 4:].any()  # C = 4 slots an expert


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


MLA = rcfgs.get_smoke_config("deepseek-v2-lite-16b")


def _mla_params(cfg, rng) -> dict:
    m, dm, H = cfg.mla, cfg.d_model, cfg.num_heads

    def w(*shape):
        return (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)

    return {"wq": w(dm, H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
            "wdkv": w(dm, m.kv_lora_rank), "wkr": w(dm, m.qk_rope_head_dim),
            "kv_norm": {"scale": (1 + 0.1 * rng.randn(m.kv_lora_rank)).astype(np.float32)},
            "wuk": w(m.kv_lora_rank, H * m.qk_nope_head_dim),
            "wuv": w(m.kv_lora_rank, H * m.v_head_dim), "wo": w(H * m.v_head_dim, dm)}


def _mla_inputs(cfg, B, S, dtype="float32", seed=0):
    rng = np.random.RandomState(seed)
    ref_p, port_p = _tree_pair(_mla_params(cfg, rng), dtype)
    xj, xt = _pair(rng.randn(B, S, cfg.d_model).astype(np.float32), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    return ref_p, port_p, xj, xt, jnp.asarray(pos), torch.from_numpy(pos.copy())


@pytest.mark.parametrize("q_chunk", [0, 4], ids=["whole", "chunked"])
@pytest.mark.parametrize("unroll", [False, True], ids=["scan", "unrolled"])
def test_mla_train_matches_reference(q_chunk, unroll):
    cfg = dataclasses.replace(MLA, attn_q_chunk=q_chunk, force_unroll=unroll)
    ref_p, port_p, xj, xt, pj, pt = _mla_inputs(cfg, 2, 16, seed=3)
    _close(rattn.mla_train(ref_p, cfg, xj, pj), tattn.mla_train(port_p, cfg, xt, pt), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_and_absorbed_decode_match_reference(dtype):
    cfg = dataclasses.replace(MLA, param_dtype=dtype, compute_dtype=dtype)
    m = cfg.mla
    B, S, s_max = 2, 12, 20
    ref_p, port_p, xj, xt, pj, pt = _mla_inputs(cfg, B, S, dtype, seed=4)
    rc = rattn.KVCache(k=jnp.zeros((B, s_max, m.kv_lora_rank + m.qk_rope_head_dim)),
                       v=jnp.zeros((B, 0)))
    tc = tattn.KVCache(k=torch.zeros((B, s_max, m.kv_lora_rank + m.qk_rope_head_dim)),
                       v=torch.zeros((B, 0)))
    out_r, rc = rattn.mla_prefill(ref_p, cfg, xj, pj, rc)
    out_t, tc = tattn.mla_prefill(port_p, cfg, xt, pt, tc)
    _close(out_r, out_t, dtype)
    _close(rc.k, tc.k, dtype)
    assert tuple(tc.v.shape) == (B, 0)
    rng = np.random.RandomState(5)
    for step in range(2):
        xj1, xt1 = _pair(rng.randn(B, 1, cfg.d_model).astype(np.float32), dtype)
        out_r, rc = rattn.mla_decode(ref_p, cfg, xj1, rc, jnp.int32(S + step))
        out_t, tc = tattn.mla_decode(port_p, cfg, xt1, tc, S + step)
        _close(out_r, out_t, dtype)
        _close(rc.k, tc.k, dtype)


def test_mla_decode_past_the_cache_clamps_its_write_like_the_reference():
    """A prompt filling all S_max positions: the next entry lands on the
    last position, while RoPE and the mask see position S_max."""
    cfg = MLA
    m = cfg.mla
    B, S = 1, 8
    ref_p, port_p, xj, xt, pj, pt = _mla_inputs(cfg, B, S, seed=6)
    width = m.kv_lora_rank + m.qk_rope_head_dim
    _, rc = rattn.mla_prefill(ref_p, cfg, xj, pj,
                              rattn.KVCache(k=jnp.zeros((B, S, width)), v=jnp.zeros((B, 0))))
    _, tc = tattn.mla_prefill(port_p, cfg, xt, pt,
                              tattn.KVCache(k=torch.zeros((B, S, width)), v=torch.zeros((B, 0))))
    before = tc.k.clone()
    xj1, xt1 = _pair(np.random.RandomState(7).randn(B, 1, cfg.d_model).astype(np.float32),
                     "float32")
    out_r, rc = rattn.mla_decode(ref_p, cfg, xj1, rc, jnp.int32(S))
    out_t, tc = tattn.mla_decode(port_p, cfg, xt1, tc, S)
    _close(out_r, out_t, "float32")
    _close(rc.k, tc.k, "float32")
    assert torch.equal(tc.k[:, :-1], before[:, :-1]) and not torch.equal(tc.k[:, -1], before[:, -1])
