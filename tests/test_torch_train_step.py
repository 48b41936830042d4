"""The port's training loss, gradients, remat modes and step factories
(``repro_torch.models.model.loss_fn``, ``repro_torch.models.steps``) against
the JAX reference's, on the CPU.

Every architecture's smoke config, the reference's weights carried across
with ``params_from_reference`` and the same numpy batch from
``SyntheticStream``. Tolerances: the loss and its (ce, aux) within 1e-5
relative; each gradient leaf, stacked back by the reference's paths
(``reference_tree``), within 1e-4 of its max-abs (XLA and torch sum in
other orders; a leaf whose gradient is exactly zero must be zero in both).
"""
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as rcfgs
from repro.launch.mesh import make_host_mesh
from repro.models import model as RM
from repro.models import steps as rsteps
from repro.train.data import SyntheticStream
from repro.train.optimizer import OptConfig as ROptConfig
from repro_torch.configs import input_specs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import model as TM
from repro_torch.models import steps as tsteps
from repro_torch.train.optimizer import OptConfig, init_opt_state

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
B, S = 2, 16  # S is a multiple of every smoke config's SSM chunk


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _batch(cfg, seed=0, b=B, s=S) -> dict:
    return SyntheticStream(cfg, b, s, seed=seed).next_batch()


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _carried(cfg, seed=1):
    ref = RM.init_params(jax.random.PRNGKey(seed), cfg)
    return ref, TM.params_from_reference(jax.tree.map(np.asarray, ref), cfg, "cpu")


def _port_grads(port, cfg, batch, remat):
    params = list(port.parameters())
    loss, (ce, aux) = TM.loss_fn(port, cfg, _torch_batch(batch), remat)
    grads = torch.autograd.grad(loss, params)
    return loss, ce, aux, TM.reference_tree(port, cfg, list(grads))


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): _np(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _trees_close(ref_tree, port_tree, rel=GRAD_REL):
    ref, port = _flat(ref_tree), _flat(port_tree)
    assert sorted(ref) == sorted(port)
    for k, r in ref.items():
        assert port[k].shape == r.shape, k
        np.testing.assert_allclose(port[k], r, rtol=0, atol=rel * np.abs(r).max(), err_msg=k)


def _params_close(ref_tree, port_tree, max_step: float, outliers=1e-3):
    """Parameters after AdamW steps: within GRAD_REL of each leaf's max-abs,
    but for at most ``outliers`` of its elements, which must lie within
    ``max_step``. Adam divides each element's mean gradient by its RMS, so
    an element whose gradients nearly cancel (within the gradients'
    tolerance of zero) can move anywhere within the update's size, lr per
    step, either way."""
    ref, port = _flat(ref_tree), _flat(port_tree)
    assert sorted(ref) == sorted(port)
    for k, r in ref.items():
        diff = np.abs(port[k] - r)
        off = diff > GRAD_REL * np.abs(r).max()
        assert off.mean() <= outliers and diff.max() <= max_step, (k, off.sum(), diff.max())


@pytest.fixture(scope="module", params=rcfgs.ARCH_IDS)
def arch_case(request):
    """(cfg, ref params, port model, batch, the reference's loss, (ce, aux)
    and gradients), one per architecture."""
    cfg = rcfgs.get_smoke_config(request.param)
    ref, port = _carried(cfg)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, (ce, aux)), grads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(p, cfg, jb, remat="none"), has_aux=True))(ref)
    return cfg, ref, port, batch, (float(loss), float(ce), float(aux)), grads


def test_loss_and_gradients_match_reference(arch_case):
    """loss_fn's value, (ce, aux) and every gradient leaf: causal LMs, the
    VLM's text positions (image_embeds), the encoder's labels."""
    cfg, _, port, batch, (r_loss, r_ce, r_aux), r_grads = arch_case
    loss, ce, aux, grads = _port_grads(port, cfg, batch, "none")
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss.detach()), r_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(ce.detach()), r_ce, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux.detach()), r_aux, rtol=LOSS_RTOL, atol=1e-7)
    assert (r_aux == 0.0) == (cfg.moe is None)
    _trees_close(r_grads, grads)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-1.2b", "rwkv6-7b",
                                  "hubert-xlarge"])
def test_remat_modes_give_equal_gradients(arch):
    """'none', 'full' (each layer recomputed) and 'dots' (products saved)
    give the same loss and gradients bit for bit ('none' is held against
    the reference in test_loss_and_gradients_match_reference)."""
    cfg = rcfgs.get_smoke_config(arch)
    _, port = _carried(cfg)
    batch = _batch(cfg, seed=2)
    runs = {r: _port_grads(port, cfg, batch, r) for r in ("none", "full", "dots")}
    base = _flat(runs["none"][3])
    for r in ("full", "dots"):
        assert float(runs[r][0].detach()) == float(runs["none"][0].detach()), r
        for k, g in _flat(runs[r][3]).items():
            np.testing.assert_array_equal(g, base[k], err_msg=f"{r}: {k}")


class _OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched while active."""

    def __init__(self):
        super().__init__()
        self.n = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


def test_remat_modes_recompute_what_they_should():
    """The ops each mode runs again in the backward pass: 'full' recomputes
    each layer's products (aten.mm) and batched einsums (aten.bmm); 'dots'
    only the batched ones, having kept the products; 'none' neither."""
    cfg = rcfgs.get_smoke_config("smollm-135m")
    _, port = _carried(cfg)
    batch = _torch_batch(_batch(cfg, seed=3))
    ops = {}
    for r in ("none", "full", "dots"):
        loss, _ = TM.loss_fn(port, cfg, batch, r)
        with _OpCount() as c:
            torch.autograd.grad(loss, list(port.parameters()))
        ops[r] = (c.n[torch.ops.aten.mm.default], c.n[torch.ops.aten.bmm.default])
    (mm, bmm), (mm_full, bmm_full), (mm_dots, bmm_dots) = ops["none"], ops["full"], ops["dots"]
    assert mm_full > mm == mm_dots and bmm_full == bmm_dots > bmm, ops
    with pytest.raises(ValueError):
        TM.loss_fn(port, cfg, batch, "some")


def _ref_state_numpy(state):
    return jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-235b-a22b"])
def test_train_step_with_accum_matches_reference(arch):
    """make_train_step at accum=2 (micro-batch gradients summed in f32)
    against the reference's, from the same weights and batch of 4: loss,
    grad_norm and lr of two steps, then every moment (which carry the
    summed gradients) and parameter (``_params_close``)."""
    cfg = rcfgs.get_smoke_config(arch)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _batch(cfg, seed=4, b=4)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}
    rb = rsteps.make_train_step(cfg, make_host_mesh(), shapes, ROptConfig(**opt),
                                remat="full", accum=2, seed=5)
    r_state = rb.init()
    r0 = _ref_state_numpy(r_state)
    tb = tsteps.make_train_step(cfg, input_specs(cfg, ShapeSpec("t", S, 4, "train")),
                                OptConfig(**opt), remat="full", accum=2, device="cpu")
    model = TM.params_from_reference(r0.params, cfg, "cpu")
    t_state = tsteps.TrainState(model, init_opt_state(list(model.parameters()), OptConfig(**opt)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        r_state, rm = rb.fn(r_state, jb)
        t_state, tm = tb.fn(t_state, _torch_batch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=GRAD_REL)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=1e-7)
    r = _ref_state_numpy(r_state)
    t = tsteps.state_tree(t_state, cfg)
    assert int(t["opt"]["step"]) == int(r.opt.step) == 2
    _params_close(r.params, t["params"], max_step=2 * 2 * opt["lr"])
    _trees_close(r.opt.m, t["opt"]["m"])
    _trees_close(r.opt.v, t["opt"]["v"])


def test_train_step_bundle_shapes_and_init():
    """arg_shapes are meta tensors of the state and batch; init is seeded;
    the state moves in place (the port's donation)."""
    cfg = rcfgs.get_smoke_config("zamba2-1.2b")
    specs = input_specs(cfg, ShapeSpec("t", S, B, "train"))
    bundle = tsteps.make_train_step(cfg, specs, OptConfig(lr=1e-3, warmup_steps=1), seed=3,
                                    device="cpu")
    state_shapes, batch_shapes = bundle.arg_shapes
    assert batch_shapes is specs
    state = bundle.init()
    again = bundle.init()
    for p, q, s in zip(state.params.parameters(), again.params.parameters(),
                       state_shapes.params.parameters()):
        assert torch.equal(p, q) and s.device.type == "meta"
        assert (s.shape, s.dtype) == (p.shape, p.dtype)
    for m, s in zip(state.opt.m, state_shapes.opt.m):
        assert (m.shape, m.dtype, s.device.type) == (s.shape, torch.float32, "meta")
    before = [p.clone() for p in state.params.parameters()]
    ptrs = [p.data_ptr() for p in state.params.parameters()]
    new, metrics = bundle.fn(state, _torch_batch(_batch(cfg)))
    assert sorted(metrics) == ["grad_norm", "loss", "lr"]
    assert [p.data_ptr() for p in new.params.parameters()] == ptrs
    assert int(new.opt.step) == 1
    assert any(not torch.equal(a, p) for a, p in zip(before, new.params.parameters()))
    if not torch.cuda.is_available():  # the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsteps.make_train_step(cfg, specs)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-lite-16b", "zamba2-1.2b"])
def test_prefill_and_decode_steps_equal_the_model_functions(arch):
    """make_prefill_step / make_decode_step give what prefill and
    decode_step give, and their meta stand-ins have the real shapes."""
    cfg = rcfgs.get_smoke_config(arch)
    _, port = _carried(cfg)
    tok = _batch(cfg, seed=6)["tokens"]
    specs = input_specs(cfg, ShapeSpec("p", S, B, "prefill"))
    pre = tsteps.make_prefill_step(cfg, specs, 32, torch.float32, device="cpu")
    dec = tsteps.make_decode_step(cfg, B, 32, torch.float32)
    logits, cache = pre.fn(port, {"tokens": torch.from_numpy(tok)})
    want, want_cache = TM.prefill(port, cfg, {"tokens": torch.from_numpy(tok)},
                                  TM.init_cache(cfg, B, 32, torch.float32, "cpu"))
    assert torch.equal(logits, want)
    nxt = logits[:, 0].argmax(-1)[:, None]
    l2, cache = dec.fn(port, cache, nxt, torch.tensor(S, dtype=torch.int32))
    w2, want_cache = TM.decode_step(port, cfg, nxt, want_cache, S)
    assert torch.equal(l2, w2)
    _, c_shapes, t_shape, len_shape = dec.arg_shapes
    assert (tuple(t_shape.shape), t_shape.dtype, len_shape.shape) == ((B, 1), torch.int32, ())
    for seg, shp in zip(cache, c_shapes):
        for a, s in zip(TM.cache_leaves(seg), TM.cache_leaves(shp)):
            assert (a.shape, s.device.type) == (s.shape, "meta")
    assert pre.arg_shapes[1] is specs
    assert not logits.requires_grad  # serving builds no graph


def test_mamba2_gradient_is_finite_where_the_reference_overflows():
    """At zamba2-1.2b's chunk of 128 a chunk's cumulative decay passes ~88,
    and the reference's exp over the whole (Q, Q) grid overflows above the
    diagonal: its loss is finite but every gradient upstream is NaN. The
    port masks the exponent first: the same loss, finite gradients, and
    those gradients equal the reference's at a chunk of 16 (the same
    function, chunked otherwise) within the tolerances."""
    cfg = rcfgs.get_smoke_config("zamba2-1.2b")
    wide = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=128))
    ref, port = _carried(wide)
    batch = _batch(wide, seed=7, s=128)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def ref_grads(c):
        return jax.jit(jax.value_and_grad(lambda p: RM.loss_fn(p, c, jb, remat="none"),
                                          has_aux=True))(ref)

    (r_loss, _), r_wide = ref_grads(wide)
    assert not all(np.isfinite(v).all() for v in _flat(r_wide).values())
    loss, _, _, grads = _port_grads(port, wide, batch, "none")
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), rtol=LOSS_RTOL)
    assert all(np.isfinite(v).all() for v in _flat(grads).values())
    _, r_narrow = ref_grads(cfg)
    _trees_close(r_narrow, grads)
