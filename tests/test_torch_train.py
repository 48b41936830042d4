"""The port's training substrate (``repro_torch.train``: AdamW, the
schedule, the data stream, compression, checkpoints; the launcher
``repro_torch.launch.train``) against the JAX reference's, on the CPU.

The same inputs, made from a seed with numpy, go through both packages.
Tolerances: AdamW on identical gradients within 1e-6 relative (both
compute in f32, in the same order of operations; relative to each leaf's
max-abs for elements near zero); the schedule and norm
within 1e-6 relative; data batches and int8 payloads equal byte for byte;
training losses within the reference's own kill-and-resume tolerance
(rtol 1e-4, atol 1e-5).
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as rcfgs
from repro.launch.train import train as ref_train
from repro.models import model as RM
from repro.train import checkpoint as rckpt
from repro.train import compression as rcomp
from repro.train import optimizer as ropt
from repro.train.data import SyntheticStream as RStream
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train.data import SyntheticStream as TStream

OPT_RTOL = 1e-6
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)  # the reference's test_checkpoint_restart_bit_identical
RESUME = dict(steps=20, global_batch=2, seq_len=32, lr=1e-3, log_every=100)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): _np(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-14b", "zamba2-1.2b"])
def test_adamw_matches_reference_on_identical_gradients(arch):
    """Two AdamW steps (decay, clipping active) on the reference's own
    gradients: parameters, m and v within OPT_RTOL of each element and of
    its leaf's max-abs (an element near zero after p - lr·delta keeps the
    rounding of the larger operands, and XLA fuses the update's products
    where torch rounds each); the metrics too."""
    cfg = rcfgs.get_smoke_config(arch)
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, clip_norm=0.5)
    ref = RM.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(1)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)), ref)
    port = TM.params_from_reference(jax.tree.map(np.asarray, ref), cfg, "cpu")
    params = list(port.parameters())
    t_grads = [torch.zeros_like(p) for p in params]
    TM.load_reference_tree(port, cfg, jax.tree.map(np.asarray, grads), t_grads)
    r_state = ropt.init_opt_state(ref, ropt.OptConfig(**oc))
    t_state = topt.init_opt_state(params, topt.OptConfig(**oc))
    update = jax.jit(ropt.adamw_update, static_argnums=3)
    for _ in range(2):
        ref, r_state, rm = update(ref, grads, r_state, ropt.OptConfig(**oc))
        t_state, tm = topt.adamw_update(params, t_grads, t_state, topt.OptConfig(**oc),
                                        TM.reference_ndims(port, cfg))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=OPT_RTOL)
    assert int(t_state.step) == int(r_state.step) == 2
    for r, t in ((ref, None), (r_state.m, t_state.m), (r_state.v, t_state.v)):
        rf, tf = _flat(r), _flat(TM.reference_tree(port, cfg, t))
        assert sorted(rf) == sorted(tf)
        for k in rf:
            np.testing.assert_allclose(tf[k], rf[k], rtol=OPT_RTOL,
                                       atol=OPT_RTOL * np.abs(rf[k]).max(), err_msg=k)


def test_weight_decay_follows_the_reference_stacked_ndim():
    """With zero gradients only decay moves a leaf: every block leaf (a 1-D
    norm scale included: it is (L, d) in the reference's stack) shrinks by
    lr * wd, while final_norm.scale (1-D there too) stays; as in the
    reference."""
    cfg = rcfgs.get_smoke_config("smollm-135m")
    oc = topt.OptConfig(lr=0.1, warmup_steps=1, total_steps=10, weight_decay=0.5)
    ref = RM.init_params(jax.random.PRNGKey(0), cfg)
    port = TM.params_from_reference(jax.tree.map(np.asarray, ref), cfg, "cpu")
    params = list(port.parameters())
    zeros = [torch.zeros_like(p) for p in params]
    state = topt.init_opt_state(params, oc)
    ndims = TM.reference_ndims(port, cfg)
    assert [nd - p.ndim for nd, p in zip(ndims, params)] == [
        int(n.startswith("blocks.")) for n, _ in port.named_parameters()]
    topt.adamw_update(params, zeros, state, oc, ndims)
    new_ref, _, _ = ropt.adamw_update(ref, jax.tree.map(jnp.zeros_like, ref),
                                      ropt.init_opt_state(ref, ropt.OptConfig(**vars(oc))),
                                      ropt.OptConfig(**vars(oc)))
    shrink = 1 - 0.1 * 0.5
    assert torch.equal(port.final_norm["scale"], torch.ones(cfg.d_model))
    np.testing.assert_allclose(port.blocks[0]["norm1"]["scale"].detach().numpy(), shrink,
                               rtol=1e-6)
    for k, v in _flat(new_ref).items():
        np.testing.assert_allclose(_flat(TM.reference_tree(port, cfg))[k], v, rtol=OPT_RTOL)
    # the port's own ndims would leave the block's norm scales undecayed
    port2 = TM.params_from_reference(jax.tree.map(np.asarray, ref), cfg, "cpu")
    p2 = list(port2.parameters())
    topt.adamw_update(p2, zeros, topt.init_opt_state(p2, oc), oc)
    assert torch.equal(port2.blocks[0]["norm1"]["scale"], torch.ones(cfg.d_model))


def test_adamw_descends_quadratic():
    cfg = topt.OptConfig(lr=0.3, warmup_steps=1, total_steps=10000, weight_decay=0.0)
    w = torch.tensor([5.0, -3.0])
    opt = topt.init_opt_state([w], cfg)
    for _ in range(100):
        opt, _ = topt.adamw_update([w], [2 * w], opt, cfg)
    assert float(w.abs().max()) < 0.5


def test_lr_schedule_and_global_norm_match_reference():
    for oc in (dict(lr=1.0, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=0, total_steps=1),
               dict(lr=2e-3, warmup_steps=3, total_steps=30)):
        for s in (0, 1, 2, 5, 10, 29, 50, 100, 150):
            r = float(ropt.lr_schedule(ropt.OptConfig(**oc), jnp.int32(s)))
            t = topt.lr_schedule(topt.OptConfig(**oc), torch.tensor(s, dtype=torch.int32))
            assert t.dtype == torch.float32
            np.testing.assert_allclose(float(t), r, rtol=OPT_RTOL, err_msg=f"{oc} {s}")
    rng = np.random.RandomState(2)
    gs = [rng.randn(*shp).astype(np.float32) * 3 for shp in ((7, 5), (11,), (3, 4, 2))]
    r = float(ropt.global_norm([jnp.asarray(g) for g in gs]))
    t = topt.global_norm([torch.from_numpy(g).to(torch.bfloat16).float() for g in gs])
    r16 = float(ropt.global_norm([jnp.asarray(g).astype(jnp.bfloat16) for g in gs]))
    np.testing.assert_allclose(float(topt.global_norm([torch.from_numpy(g) for g in gs])), r,
                               rtol=OPT_RTOL)
    np.testing.assert_allclose(float(t), r16, rtol=OPT_RTOL)  # bf16 leaves summed in f32


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-135m", "hubert-xlarge", "paligemma-3b"])
def test_synthetic_stream_batches_equal_the_reference(arch):
    """Tokens, frames and labels, VLM tokens and image embeddings: byte for
    byte, per host shard, and after a restore from a snapshot."""
    cfg = rcfgs.get_smoke_config(arch)
    for hosts in (1, 2):
        for h in range(hosts):
            r, t = RStream(cfg, 8, 16, seed=3, host_id=h, num_hosts=hosts), TStream(
                cfg, 8, 16, seed=3, host_id=h, num_hosts=hosts)
            for _ in range(3):
                rb, tb = r.next_batch(), t.next_batch()
                assert sorted(rb) == sorted(tb)
                for k in rb:
                    assert rb[k].dtype == tb[k].dtype and rb[k].tobytes() == tb[k].tobytes()
            assert t.snapshot() == r.snapshot()
    r = RStream(cfg, 8, 16, seed=3)
    r.next_batch()
    t = TStream(cfg, 8, 16, seed=0)
    t.restore(r.snapshot())
    nxt, got = r.next_batch(), t.next_batch()
    assert all(got[k].tobytes() == nxt[k].tobytes() for k in nxt)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_int8_compression_matches_reference():
    """Payloads, scales and error-feedback residuals equal the reference's
    on ragged and whole blocks, with a residual carried in."""
    rng = np.random.RandomState(4)
    for shape in ((1000,), (37, 5), (256,), (3, 256)):
        g = (rng.randn(*shape) * 10).astype(np.float32)
        rc, rres = rcomp.int8_compress(jnp.asarray(g))
        tc, tres = tcomp.int8_compress(torch.from_numpy(g))
        np.testing.assert_array_equal(tc.q.numpy(), np.asarray(rc.q))
        np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(rc.scale))
        np.testing.assert_array_equal(tres.numpy(), np.asarray(rres))
        np.testing.assert_array_equal(
            tcomp.int8_decompress(tc, shape, torch.float32).numpy(),
            np.asarray(rcomp.int8_decompress(rc, shape, jnp.float32)))
        assert tc.q.dtype == torch.int8 and tc.q.numel() <= g.size + 255
    grads = [rng.randn(37, 5).astype(np.float32), rng.randn(8).astype(np.float32)]
    for mode in ("none", "bf16", "int8"):
        rr = rcomp.init_residuals({"a": jnp.asarray(grads[0]), "b": jnp.asarray(grads[1])}, mode)
        tr = tcomp.init_residuals([torch.from_numpy(g) for g in grads], mode)
        assert [tuple(r.shape) for r in tr] == [rr["a"].shape, rr["b"].shape]
        for _ in range(2):  # the second round feeds the first's residuals back
            rcg, rr = rcomp.compress_grads({"a": jnp.asarray(grads[0]), "b": jnp.asarray(
                grads[1])}, rr, mode)
            tcg, tr = tcomp.compress_grads([torch.from_numpy(g) for g in grads], tr, mode)
            rout = rcomp.decompress_grads(rcg, {"a": grads[0], "b": grads[1]}, mode)
            tout = tcomp.decompress_grads(tcg, [torch.from_numpy(g) for g in grads], mode)
            for t, k in zip(tout, ("a", "b")):
                np.testing.assert_array_equal(_np(t), _np(rout[k]))
            for t, k in zip(tr, ("a", "b")):
                np.testing.assert_array_equal(_np(t), _np(rr[k]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoints_move_between_the_packages(tmp_path):
    """The reference's files read by the port, the port's read by the
    reference (f32 and int leaves), manifests alike; torn steps ignored."""
    rng = np.random.RandomState(5)
    tree = {"a": rng.randn(4, 3).astype(np.float32), "b": {"c": np.arange(6, dtype=np.int32)},
            "s": np.int32(7)}
    rckpt.save(str(tmp_path / "ref"), 3, tree, extra={"step": 3, "data": {"step": 3, "seed": 0}})
    got, extra = tckpt.restore(str(tmp_path / "ref"), tree)
    assert extra == {"step": 3, "data": {"step": 3, "seed": 0}}
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(_flat(got)[k], v)
    ttree = {"a": torch.from_numpy(tree["a"]), "b": {"c": torch.from_numpy(tree["b"]["c"])},
             "s": torch.tensor(7, dtype=torch.int32)}
    tckpt.save(str(tmp_path / "port"), 3, ttree, extra={"step": 3})
    back, _ = rckpt.restore(str(tmp_path / "port"), tree)
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(np.asarray(_flat(back)[k]), v)
        assert _flat(back)[k].dtype == v.dtype
    read = lambda d: json.load(open(tmp_path / d / "step_00000003" / "manifest.json"))
    assert read("ref")["leaves"] == read("port")["leaves"]
    for name in sorted(os.listdir(tmp_path / "ref" / "step_00000003")):
        if name.endswith(".npy"):
            assert (tmp_path / "ref" / "step_00000003" / name).read_bytes() == (
                tmp_path / "port" / "step_00000003" / name).read_bytes()
    os.makedirs(tmp_path / "port" / "step_00000009")  # torn: no manifest
    assert tckpt.latest_step(str(tmp_path / "port")) == 3
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), tree)


def test_bf16_leaves_in_the_reference_format(tmp_path):
    """A bf16 leaf written with ml_dtypes (as the reference's save writes
    one) is read back exactly, and the port writes the same bytes."""
    a = (np.random.RandomState(6).randn(5, 7) * 3).astype(np.float32).astype(ml_dtypes.bfloat16)
    rckpt.save(str(tmp_path / "ref"), 1, {"w": a, "f": np.ones(3, np.float32)})
    t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    got, _ = tckpt.restore(str(tmp_path / "ref"), {"w": None, "f": None})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)
    tckpt.save(str(tmp_path / "port"), 1, {"w": t, "f": torch.ones(3)})
    for name in ("w.npy", "manifest.json"):
        assert (tmp_path / "ref" / "step_00000001" / name).read_bytes() == (
            tmp_path / "port" / "step_00000001" / name).read_bytes()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_unbroken():
    """The reference trainer's unbroken 20-step run (RESUME)."""
    return ref_train(rcfgs.get_smoke_config("smollm-135m"), **RESUME)


def test_loss_descends_smollm():
    """The reference's test_loss_descends_smollm, on the port's launcher."""
    out = tlaunch.train(rcfgs.get_smoke_config("smollm-135m"), steps=30, global_batch=4,
                        seq_len=64, lr=2e-3, log_every=100, device="cpu")
    losses = out["losses"]
    assert len(losses) == 30 and losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_checkpoint_restart_matches_unbroken_run(tmp_path, capsys):
    """Kill at step 10 (a checkpoint), resume to 20: the last 5 losses equal
    an unbroken run's, as the reference's test requires; the log lines are
    the reference's."""
    cfg = rcfgs.get_smoke_config("smollm-135m")
    full = tlaunch.train(cfg, device="cpu", **RESUME)
    d = str(tmp_path / "ck")
    part = tlaunch.train(cfg, stop_after=10, ckpt_dir=d, ckpt_every=10, device="cpu", **RESUME)
    assert len(part["losses"]) == 10 and tckpt.latest_step(d) == 10
    resumed = tlaunch.train(cfg, ckpt_dir=d, ckpt_every=10, device="cpu", **RESUME)
    assert len(resumed["losses"]) == 10
    np.testing.assert_allclose(resumed["losses"][-5:], full["losses"][-5:], **LOSS_TOL)
    np.testing.assert_allclose(part["losses"], full["losses"][:10], rtol=0, atol=0)
    out = capsys.readouterr().out
    assert "resumed from step 10" in out and "step    19 loss" in out


def test_resume_from_the_reference_trainers_checkpoint(tmp_path, ref_unbroken):
    """The reference trainer killed at step 10 in a checkpoint directory,
    then the port's trainer resumes there: its losses for steps 10-19 equal
    the reference's unbroken run's."""
    cfg = rcfgs.get_smoke_config("smollm-135m")
    d = str(tmp_path / "ck")
    ref_train(cfg, stop_after=10, ckpt_dir=d, ckpt_every=10, **RESUME)
    out = tlaunch.train(cfg, ckpt_dir=d, ckpt_every=10, device="cpu", **RESUME)
    assert len(out["losses"]) == 10
    np.testing.assert_allclose(out["losses"], ref_unbroken["losses"][10:], **LOSS_TOL)
    # and the port's step-20 checkpoint restores into the reference's state
    assert tckpt.latest_step(d) == 20
    manifest = json.load(open(os.path.join(d, "step_00000020", "manifest.json")))
    assert manifest["extra"] == {"step": 20, "data": {"step": 20, "seed": 0}}
    assert "opt/step" in manifest["leaves"] and "params/blocks/0/mixer/wq" in manifest["leaves"]


def test_launcher_main_and_its_device(capsys):
    tlaunch.main(["--arch", "smollm-135m", "--smoke", "--steps", "3", "--global-batch", "2",
                  "--seq-len", "32", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step     0 loss ") and " gnorm " in out[0] and " lr 3.00e-04 " in out[0]
    assert out[-1].startswith("final loss: ")
    if not torch.cuda.is_available():  # the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(["--arch", "smollm-135m", "--smoke", "--steps", "1"])
