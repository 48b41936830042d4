"""The port's architecture configs, layers and LM stacks (dense, VLM, MoE,
MLA, hybrid Mamba2 and RWKV6; ``repro_torch.configs``,
``repro_torch.models``) against the JAX reference's, on the CPU.

The same inputs, made from a seed with numpy, go through both packages.
Tolerances: f32 results within 1e-5 absolute at the layers (5e-6 relative
where values grow) and 1e-4 absolute on logits and caches, the difference
of XLA's and torch's summation orders; bf16 results within 1/64 of the
result's max-abs (a couple of bf16 ulps: both round each product to bf16,
but in other orders and with other fused f32 intermediates).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfgs
import repro_torch.configs as tcfgs
from repro.configs import cosmosann as rcos
from repro.models import layers as rl
from repro.models import model as RM
from repro_torch.configs import cosmosann as tcos
from repro_torch.models import layers as tl
from repro_torch.models import model as TM

F32_LAYER_ATOL = 1e-5
LOGIT_ATOL = 1e-4
BF16_REL = 1 / 64
DENSE = ["smollm-135m", "qwen3-14b", "chatglm3-6b", "starcoder2-15b", "paligemma-3b"]
# MoE (GQA and MLA), hybrid Mamba2 and RWKV6: S=16 is a multiple of each
# smoke config's SSM chunk, as a prefill needs
MOE_SSM = ["qwen3-moe-235b-a22b", "deepseek-v2-lite-16b", "zamba2-1.2b", "rwkv6-7b"]
DECODING = DENSE + MOE_SSM
AUX_ATOL = 1e-6


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _close(ref, port, dtype: str, atol: float = F32_LAYER_ATOL) -> None:
    ref, port = _np(ref), _np(port)
    assert ref.shape == port.shape
    if dtype == "bfloat16":
        np.testing.assert_allclose(port, ref, rtol=0, atol=BF16_REL * np.abs(ref).max())
    else:
        np.testing.assert_allclose(port, ref, rtol=5e-6, atol=atol)


def _pair(a: np.ndarray, dtype: str):
    """(jax array, torch tensor) of the same values in ``dtype``."""
    t = torch.from_numpy(a)
    j = jnp.asarray(a)
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", rcfgs.ARCH_IDS + ["cosmosann"])
def test_configs_equal_field_for_field(arch):
    assert tcfgs.ARCH_IDS == rcfgs.ARCH_IDS
    for fn in ("get_config", "get_smoke_config"):
        ref, port = getattr(rcfgs, fn)(arch), getattr(tcfgs, fn)(arch)
        assert dataclasses.asdict(ref) == dataclasses.asdict(port)
        if arch != "cosmosann":
            assert (ref.param_count(), ref.active_param_count(), ref.pattern, ref.uniform,
                    ref.has_decode, ref.sub_quadratic, ref.resolved_head_dim) == (
                port.param_count(), port.active_param_count(), port.pattern, port.uniform,
                port.has_decode, port.sub_quadratic, port.resolved_head_dim)
    with pytest.raises(KeyError):
        tcfgs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", rcfgs.ARCH_IDS)
def test_input_specs_and_cells_equal(arch):
    ref_cfg, port_cfg = rcfgs.get_config(arch), tcfgs.get_config(arch)
    assert sorted(tcfgs.SHAPES) == sorted(rcfgs.SHAPES)
    for name, shape in rcfgs.SHAPES.items():
        assert dataclasses.asdict(tcfgs.SHAPES[name]) == dataclasses.asdict(shape)
        assert tcfgs.cell_supported(port_cfg, tcfgs.SHAPES[name]) == rcfgs.cell_supported(
            ref_cfg, shape)
        ref, port = rcfgs.input_specs(ref_cfg, shape), tcfgs.input_specs(port_cfg, tcfgs.SHAPES[name])
        assert sorted(ref) == sorted(port)
        for k in ref:
            assert port[k].device.type == "meta"
            assert tuple(port[k].shape) == tuple(ref[k].shape)
            assert str(port[k].dtype).removeprefix("torch.") == str(ref[k].dtype)


@pytest.mark.parametrize("which", ["config", "smoke"])
def test_shard_specs_equal(which):
    ref_cfg, port_cfg = getattr(rcos, which)(), getattr(tcos, which)()
    ref, port = rcos.shard_specs(ref_cfg, 4), tcos.shard_specs(port_cfg, 4)
    assert sorted(ref) == sorted(port)
    for k in ref:
        assert port[k].device.type == "meta"
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
        assert str(port[k].dtype).removeprefix("torch.") == str(ref[k].dtype), k


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.RandomState(0)
    x = (3.0 * rng.randn(2, 5, 64)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(64)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    sj, st = _pair(scale, dtype)
    ref = rl.rmsnorm({"scale": sj}, xj, 1e-5)
    port = tl.rmsnorm({"scale": st}, xt, 1e-5)
    assert port.dtype == xt.dtype
    _close(ref, port, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,theta", [("full", 10000.0), ("full", 1e6), ("partial", 10000.0),
                                        ("none", 10000.0)])
def test_apply_rope_matches_reference(mode, theta, dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 40, 3, 32).astype(np.float32)
    pos = np.stack([np.arange(40), np.arange(100, 140)]).astype(np.int32)
    xj, xt = _pair(x, dtype)
    ref = rl.apply_rope(xj, jnp.asarray(pos), theta, mode)
    port = tl.apply_rope(xt, torch.from_numpy(pos), theta, mode)
    _close(ref, port, dtype)
    if mode == "partial":  # the second half passes through untouched
        np.testing.assert_array_equal(_np(port)[..., 16:], _np(xt)[..., 16:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_apply_matches_reference(kind, dtype):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 7, 48).astype(np.float32)
    ws = {"w1": (48, 96), "w2": (96, 48)} | ({"w3": (48, 96)} if kind == "swiglu" else {})
    ws = {k: (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32) for k, s in ws.items()}
    xj, xt = _pair(x, dtype)
    ref = rl.mlp_apply({k: _pair(v, dtype)[0] for k, v in ws.items()}, xj, kind)
    port = tl.mlp_apply({k: _pair(v, dtype)[1] for k, v in ws.items()}, xt, kind)
    _close(ref, port, dtype)


def test_initializers_truncated_and_seeded():
    gen = torch.Generator("cpu").manual_seed(7)
    w = tl.dense_init(gen, (256, 512), torch.float32)
    e = tl.embed_init(gen, (300, 64), torch.bfloat16)
    std = 1 / 16
    assert w.dtype == torch.float32 and e.dtype == torch.bfloat16
    assert float(w.abs().max()) <= 2 * std * (1 + 1e-6)
    assert float(e.float().abs().max()) <= 0.04 * (1 + 2 ** -8)
    # a N(0, 1) truncated to [-2, 2] has std 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.01
    again = tl.dense_init(torch.Generator("cpu").manual_seed(7), (256, 512), torch.float32)
    assert torch.equal(w, again)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode and caches
# ---------------------------------------------------------------------------


def _batch(cfg, rng, B=2, S=16):
    if cfg.input_mode == "tokens":
        return {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.input_mode == "frames":
        return {"frames": rng.randn(B, S, cfg.d_model).astype(np.float32)}
    Ni = cfg.num_image_tokens
    return {"tokens": rng.randint(0, cfg.vocab_size, (B, S - Ni)).astype(np.int32),
            "image_embeds": rng.randn(B, Ni, cfg.d_model).astype(np.float32)}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in b.items()}


def _carried(cfg, seed=1):
    ref = RM.init_params(jax.random.PRNGKey(seed), cfg)
    return ref, TM.params_from_reference(jax.tree.map(np.asarray, ref), cfg, "cpu")


def _leaves(seg):
    """A segment's leaves in order: a KV (k, v) pair or an SSM state dict."""
    return [seg[k] for k in sorted(seg)] if isinstance(seg, dict) else list(seg)


def _caches_close(ref_cache, port_cache, atol=LOGIT_ATOL):
    port = TM.cache_to_reference(port_cache)
    assert len(port) == len(ref_cache)
    for r, p in zip(ref_cache, port):
        assert isinstance(p, dict) == isinstance(r, dict)
        assert not isinstance(p, dict) or sorted(p) == sorted(r)
        for a, b in zip(_leaves(r), _leaves(p)):
            assert b.shape == a.shape
            np.testing.assert_allclose(b, _np(a), rtol=0, atol=atol)


def _serve_parity(cfg, B=2, S=16, s_max=32, decodes=2, atol=LOGIT_ATOL):
    """prefill then ``decodes`` greedy steps in both packages (tokens fed
    from the reference), logits and caches compared after each call."""
    ref, port = _carried(cfg)
    b = _batch(cfg, np.random.RandomState(0), B, S)
    logits, _, r_aux = RM.forward_train(ref, cfg, _jax_batch(b), remat="none")
    with torch.no_grad():
        t_logits, _, aux = TM.forward_train(port, cfg, _torch_batch(b), remat="none")
    np.testing.assert_allclose(_np(t_logits), _np(logits), rtol=0, atol=atol)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=0, atol=AUX_ATOL)
    assert (float(aux) == 0.0) == (cfg.moe is None)
    rc = RM.init_cache(cfg, B, s_max, dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, s_max, torch.float32, "cpu")
    rl_, rc = RM.prefill(ref, cfg, _jax_batch(b), rc)
    tl_, tc = TM.prefill(port, cfg, _torch_batch(b), tc)
    np.testing.assert_allclose(_np(tl_), _np(rl_), rtol=0, atol=atol)
    _caches_close(rc, tc, atol)
    for step in range(decodes):
        tok = np.argmax(_np(rl_)[:, 0], -1)[:, None].astype(np.int32)
        # the port's decode also from the reference's own cache, carried across
        carried = TM.cache_from_reference(jax.tree.map(np.asarray, rc), "cpu")
        cl_, _ = TM.decode_step(port, cfg, torch.from_numpy(tok.astype(np.int64)), carried,
                                S + step)
        rl_, rc = RM.decode_step(ref, cfg, jnp.asarray(tok), rc, jnp.int32(S + step))
        tl_, tc = TM.decode_step(port, cfg, torch.from_numpy(tok.astype(np.int64)), tc, S + step)
        np.testing.assert_allclose(_np(tl_), _np(rl_), rtol=0, atol=atol)
        np.testing.assert_allclose(_np(cl_), _np(rl_), rtol=0, atol=atol)
        _caches_close(rc, tc, atol)


@pytest.mark.parametrize("arch", DECODING)
def test_forward_prefill_decode_match_reference(arch):
    """Forward, prefill and two decodes; caches (KV, MLA's packed stream,
    SSM states) carried both ways; the MoE aux within AUX_ATOL."""
    _serve_parity(rcfgs.get_smoke_config(arch))


@pytest.mark.parametrize("case", ["q_chunk", "force_unroll"])
def test_chunked_attention_and_unrolled_segments_match_reference(case):
    """The query-block loop (S=16 in blocks of 4) and one cache segment per
    layer, against the reference's scan and its per-layer segments."""
    cfg = rcfgs.get_smoke_config("qwen3-14b")
    cfg = dataclasses.replace(cfg, **({"attn_q_chunk": 4} if case == "q_chunk"
                                      else {"force_unroll": True}))
    assert len(TM.segments(cfg)) == (2 if case == "force_unroll" else 1)
    _serve_parity(cfg, decodes=1)


def test_bf16_prefill_and_decode_match_reference():
    cfg = dataclasses.replace(rcfgs.get_smoke_config("smollm-135m"),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    ref, port = _carried(cfg)
    assert port.embed.dtype == torch.bfloat16
    b = _batch(cfg, np.random.RandomState(3), 2, 12)
    rc = RM.init_cache(cfg, 2, 24, dtype=jnp.float32)
    tc = TM.init_cache(cfg, 2, 24, torch.float32, "cpu")
    rl_, rc = RM.prefill(ref, cfg, _jax_batch(b), rc)
    tl_, tc = TM.prefill(port, cfg, _torch_batch(b), tc)
    _close(rl_, tl_, "bfloat16")
    tok = np.argmax(_np(rl_)[:, 0], -1)[:, None].astype(np.int32)
    rl_, rc = RM.decode_step(ref, cfg, jnp.asarray(tok), rc, jnp.int32(12))
    tl_, tc = TM.decode_step(port, cfg, torch.from_numpy(tok.astype(np.int64)), tc, 12)
    _close(rl_, tl_, "bfloat16")
    for r, p in zip(rc, TM.cache_to_reference(tc)):
        for a, q in zip(r, p):
            np.testing.assert_allclose(q, _np(a), rtol=0, atol=BF16_REL * np.abs(_np(a)).max())


def test_decode_past_the_cache_clamps_its_write_like_the_reference():
    """A prompt filling all S_max positions: the next token's k, v land on
    the last position (the reference's dynamic_update_slice clamps), while
    RoPE and the mask see position S_max."""
    cfg = rcfgs.get_smoke_config("smollm-135m")
    ref, port = _carried(cfg)
    b = _batch(cfg, np.random.RandomState(4), 1, 8)
    rc = RM.init_cache(cfg, 1, 8, dtype=jnp.float32)
    tc = TM.init_cache(cfg, 1, 8, torch.float32, "cpu")
    rl_, rc = RM.prefill(ref, cfg, _jax_batch(b), rc)
    tl_, tc = TM.prefill(port, cfg, _torch_batch(b), tc)
    tok = np.argmax(_np(rl_)[:, 0], -1)[:, None].astype(np.int32)
    rl_, rc = RM.decode_step(ref, cfg, jnp.asarray(tok), rc, jnp.int32(8))
    tl_, tc = TM.decode_step(port, cfg, torch.from_numpy(tok.astype(np.int64)), tc, 8)
    np.testing.assert_allclose(_np(tl_), _np(rl_), rtol=0, atol=LOGIT_ATOL)
    _caches_close(rc, tc)


@pytest.mark.parametrize("arch", ["hubert-xlarge"])
def test_unported_blocks_raise_and_the_encoder_runs(arch):
    """The encoder-only stack's forward (no block raises any more: the MoE,
    MLA and SSM cases are in test_forward_prefill_decode_match_reference)."""
    cfg = tcfgs.get_smoke_config(arch)
    ref, port = _carried(cfg)  # frames in, encoder-only: no cache, no decode
    b = _batch(cfg, np.random.RandomState(5))
    logits, mask, _ = RM.forward_train(ref, cfg, _jax_batch(b), remat="none")
    with torch.no_grad():
        t_logits, t_mask, _ = TM.forward_train(port, cfg, _torch_batch(b), remat="none")
    np.testing.assert_allclose(_np(t_logits), _np(logits), rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(mask))


@pytest.mark.parametrize("arch", DECODING)
def test_init_params_has_the_reference_layout(arch):
    """Seeded init on the CPU: every leaf of the reference's pytree, layer by
    layer, with its shape and dtype; the same seed gives the same weights."""
    cfg = tcfgs.get_smoke_config(arch)
    ref = jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0), rcfgs.get_smoke_config(arch)))
    port = TM.init_params(torch.Generator("cpu").manual_seed(0), cfg, "cpu")
    want, off = {}, 0
    for (kind, ln), seg in zip(RM.segments(cfg), ref["blocks"]):
        for j in range(off, off + ln):
            for path, leaf in jax.tree_util.tree_flatten_with_path(seg)[0]:
                name = ".".join(str(p.key) for p in path)
                want[f"blocks.{j}.{name}"] = (tuple(leaf.shape[1:]), str(leaf.dtype))
        off += ln
    for k in ("embed", "lm_head"):
        if k in ref:
            want[k] = (tuple(ref[k].shape), str(ref[k].dtype))
    want["final_norm.scale"] = (tuple(ref["final_norm"]["scale"].shape),
                                str(ref["final_norm"]["scale"].dtype))
    got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in port.named_parameters()}
    assert got == want
    assert all(p.requires_grad for p in port.parameters())  # trainable (loss_fn)
    again = TM.init_params(torch.Generator("cpu").manual_seed(0), cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(port.parameters(), again.parameters()))


def test_entry_points_default_to_the_card():
    cfg = tcfgs.get_smoke_config("smollm-135m")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(torch.Generator("cpu").manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_cache(cfg, 1, 8)
