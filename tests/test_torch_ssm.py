"""The port's SSM mixers, Mamba2 and RWKV6 (``repro_torch.models.ssm``),
against the JAX reference's on the CPU.

The same parameters and inputs, made from a seed with numpy, go through
both packages: the chunked forward at chunks 4, 8 and 32, the one-token
steps, the prefill's state handed to a step, and the causal conv, in f32
within 1e-5. The port's chunked form is also held against its own
recurrent steps at the reference's tests/test_ssm.py tolerance (rtol 2e-3,
atol 2e-4: the two forms sum the decays in other orders), and a prefill
whose length is not a chunk multiple raises in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as rssm
from repro.models.config import ModelConfig, SSMConfig
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.config import SSMConfig as TSSMConfig

F32_TOL = 1e-5
REC_RTOL, REC_ATOL = 2e-3, 2e-4
BF16_REL = 1 / 64
KINDS = ["mamba2", "rwkv6"]


def _cfgs(kind: str, chunk: int = 8, dtype: str = "float32"):
    kw = dict(name="t", family="ssm", num_layers=1, d_model=32, num_heads=4, num_kv_heads=4,
              d_ff=64, vocab_size=100, param_dtype=dtype, compute_dtype=dtype)
    ssm = dict(kind=kind, d_state=16, head_dim=8, expand=2, chunk=chunk)
    return (ModelConfig(ssm=SSMConfig(**ssm), **kw),
            TModelConfig(ssm=TSSMConfig(**ssm), **kw))


def _params(kind: str, cfg, rng) -> dict:
    """Seeded weights in the reference's layout, with the f32 leaves (decay,
    skip and bonus terms) drawn off their constant inits."""
    s, dm = cfg.ssm, cfg.d_model
    din = s.expand * dm
    nh = din // s.head_dim

    def w(*shape, scale=1.0):
        return (scale * rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)

    norm = {"scale": (1 + 0.1 * rng.randn(din)).astype(np.float32)}
    if kind == "mamba2":
        conv_dim = din + 2 * s.d_state
        return {"in_proj": w(dm, 2 * din + 2 * s.d_state + nh),
                "conv_w": w(s.conv_width, conv_dim), "conv_b": w(1, conv_dim, scale=0.1)[0],
                "A_log": (0.5 * rng.randn(nh)).astype(np.float32),
                "D": (1 + 0.1 * rng.randn(nh)).astype(np.float32),
                "dt_bias": (0.5 * rng.randn(nh)).astype(np.float32),
                "out_norm": norm, "out_proj": w(din, dm)}
    return {"mu": rng.uniform(0, 1, (5, dm)).astype(np.float32),
            **{k: w(dm, din) for k in ("wr", "wk", "wv", "wg")},
            "w_lora_a": w(dm, 64), "w_lora_b": w(64, din, scale=0.1),
            "w0": (-2 + 0.5 * rng.randn(din)).astype(np.float32),
            "u": (0.3 * rng.randn(din)).astype(np.float32),
            "out_norm": norm, "wo": w(din, dm)}


F32_LEAVES = ("A_log", "D", "dt_bias", "w0", "u")


def _both(tree: dict, dtype: str = "float32"):
    ref, port = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            ref[k], port[k] = _both(v, dtype)
            continue
        ref[k], port[k] = jnp.asarray(v), torch.from_numpy(v)
        if dtype == "bfloat16" and k not in F32_LEAVES:
            ref[k], port[k] = ref[k].astype(jnp.bfloat16), port[k].to(torch.bfloat16)
    return ref, port


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _close(ref, port, rtol=F32_TOL, atol=F32_TOL):
    ref, port = _np(ref), _np(port)
    assert ref.shape == port.shape
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def _fns(mod, kind: str):
    if kind == "mamba2":
        return mod.mamba2_forward, mod.mamba2_step, mod.mamba2_init_state
    return mod.rwkv6_forward, mod.rwkv6_step, mod.rwkv6_init_state


def _x(rng, B, S, dm=32):
    x = (0.5 * rng.randn(B, S, dm)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_reference(kind, chunk):
    """Sequences of 32 (a chunk multiple) and 30 (padded to one)."""
    rcfg, tcfg = _cfgs(kind, chunk)
    rng = np.random.RandomState(chunk)
    rp, tp = _both(_params(kind, rcfg, rng))
    rfwd, tfwd = _fns(rssm, kind)[0], _fns(tssm, kind)[0]
    for S in (32, 30):
        xj, xt = _x(rng, 2, S)
        _close(rfwd(rp, rcfg, xj), tfwd(tp, tcfg, xt))


@pytest.mark.parametrize("kind", KINDS)
def test_steps_and_state_handoff_match_reference(kind):
    """A prefill (return_state) of 16 tokens in both, its state, then three
    steps from it: outputs and states at each."""
    rcfg, tcfg = _cfgs(kind, 8)
    rng = np.random.RandomState(11)
    rp, tp = _both(_params(kind, rcfg, rng))
    (rfwd, rstep, _), (tfwd, tstep, _) = _fns(rssm, kind), _fns(tssm, kind)
    xj, xt = _x(rng, 2, 16)
    yr, sr = rfwd(rp, rcfg, xj, return_state=True)
    yt, st = tfwd(tp, tcfg, xt, return_state=True)
    _close(yr, yt)
    assert sorted(st) == sorted(sr)
    for k in sr:
        _close(sr[k], st[k])
    for _ in range(3):
        xj, xt = _x(rng, 2, 1)
        yr, sr = rstep(rp, rcfg, xj, sr)
        yt, st = tstep(tp, tcfg, xt, st)
        _close(yr, yt)
        for k in sr:
            _close(sr[k], st[k])


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_chunked_matches_own_recurrence(kind, chunk):
    """The port's chunked forward against its own steps from a zero state,
    outputs and the final state (the reference's test_ssm.py check)."""
    _, tcfg = _cfgs(kind, chunk)
    rng = np.random.RandomState(20 + chunk)
    _, tp = _both(_params(kind, tcfg, rng))
    fwd, step, state0 = _fns(tssm, kind)
    _, xt = _x(rng, 2, 32)
    y, st_fwd = fwd(tp, tcfg, xt, return_state=True)
    st = state0(tcfg, 2)
    ys = []
    for t in range(32):
        yt, st = step(tp, tcfg, xt[:, t:t + 1], st)
        ys.append(yt)
    _close(y, torch.cat(ys, dim=1), REC_RTOL, REC_ATOL)
    for k in st:
        _close(st_fwd[k], st[k], REC_RTOL, REC_ATOL)


def test_causal_conv_matches_reference():
    rng = np.random.RandomState(30)
    x = rng.randn(2, 13, 24).astype(np.float32)
    w = rng.randn(4, 24).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    ref = rssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    port = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    _close(ref, port)
    # causal: the first output sees only the first input
    x2 = x.copy()
    x2[:, 1:] = 0
    first = tssm._causal_conv(torch.from_numpy(x2), torch.from_numpy(w), torch.from_numpy(b))
    _close(port[:, :1], first[:, :1])


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_off_the_chunk_raises_and_forward_pads(kind):
    rcfg, tcfg = _cfgs(kind, 8)
    rng = np.random.RandomState(40)
    rp, tp = _both(_params(kind, rcfg, rng))
    rfwd, tfwd = _fns(rssm, kind)[0], _fns(tssm, kind)[0]
    xj, xt = _x(rng, 1, 12)
    with pytest.raises(AssertionError, match="chunk multiple"):
        rfwd(rp, rcfg, xj, return_state=True)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tfwd(tp, tcfg, xt, return_state=True)
    _close(rfwd(rp, rcfg, xj), tfwd(tp, tcfg, xt))
    # shorter than a chunk: one chunk of its own length, state and all
    xj, xt = _x(rng, 1, 6)
    _, sr = rfwd(rp, rcfg, xj, return_state=True)
    _, st = tfwd(tp, tcfg, xt, return_state=True)
    for k in sr:
        _close(sr[k], st[k])


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_keeps_f32_leaves_and_matches_reference(kind):
    """bf16 weights and activations, the decay terms f32: the forward and
    a step on a cache in the activations' dtype within 1/64 of the max-abs;
    the step's carry dtypes are the reference's."""
    rcfg, tcfg = _cfgs(kind, 8, "bfloat16")
    rng = np.random.RandomState(50)
    rp, tp = _both(_params(kind, rcfg, rng), "bfloat16")
    (rfwd, rstep, rstate0), (tfwd, tstep, tstate0) = _fns(rssm, kind), _fns(tssm, kind)
    xj, xt = _x(rng, 2, 16)
    xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    yr, sr = rfwd(rp, rcfg, xj, return_state=True)
    yt, st = tfwd(tp, tcfg, xt, return_state=True)
    assert yt.dtype == torch.bfloat16 and st["S"].dtype == torch.float32
    for a, b in [(yr, yt)] + [(sr[k], st[k]) for k in sr]:
        _close(a, b, 0, BF16_REL * np.abs(_np(a)).max())
    x1 = (0.5 * rng.randn(2, 1, 32)).astype(np.float32)
    yr, sr = rstep(rp, rcfg, jnp.asarray(x1).astype(jnp.bfloat16), sr)
    yt, st = tstep(tp, tcfg, torch.from_numpy(x1).to(torch.bfloat16), st)
    assert {k: str(v.dtype) for k, v in sr.items()} == {
        k: str(v.dtype).removeprefix("torch.") for k, v in st.items()}
    for a, b in [(yr, yt)] + [(sr[k], st[k]) for k in sr]:
        _close(a, b, 0, BF16_REL * np.abs(_np(a)).max())
    assert str(tstate0(tcfg, 1)["S"].dtype) == "torch.float32"


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_step_on_an_f32_cache(kind):
    """A bf16 step on f32 states, as the engine's caches are. Mamba2: the
    conv runs in f32 on both sides. RWKV6: the port reads the shift in
    bf16 and stays bf16; it equals the reference's step on the same state
    with the shift held in bf16 (the reference promotes the step to f32
    instead, which its layer scan refuses)."""
    rcfg, tcfg = _cfgs(kind, 8, "bfloat16")
    rng = np.random.RandomState(60)
    rp, tp = _both(_params(kind, rcfg, rng), "bfloat16")
    state = {k: (0.1 * rng.randn(*v.shape)).astype(np.float32)
             for k, v in _fns(tssm, kind)[2](tcfg, 2).items()}
    carry = "conv" if kind == "mamba2" else "shift"  # values a bf16 model wrote
    state[carry] = torch.from_numpy(state[carry]).to(torch.bfloat16).float().numpy()
    x1 = torch.from_numpy(rng.randn(2, 1, 32).astype(np.float32)).to(torch.bfloat16)
    step_r, step_t = _fns(rssm, kind)[1], _fns(tssm, kind)[1]
    yt, st = step_t(tp, tcfg, x1, {k: torch.from_numpy(v) for k, v in state.items()})
    ref_state = {k: jnp.asarray(v) for k, v in state.items()}
    if kind == "rwkv6":
        ref_state["shift"] = ref_state["shift"].astype(jnp.bfloat16)
    yr, sr = step_r(rp, rcfg, jnp.asarray(x1.float().numpy()).astype(jnp.bfloat16), ref_state)
    assert yt.dtype == torch.bfloat16 and st["S"].dtype == torch.float32
    for a, b in [(yr, yt)] + [(sr[k], st[k]) for k in sr]:
        _close(a, b, 0, BF16_REL * np.abs(_np(a)).max())
