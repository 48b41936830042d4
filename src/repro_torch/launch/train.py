"""Training launcher: ``python -m repro_torch.launch.train --arch smollm-135m``
(the port of ``repro.launch.train``).

Runs real steps on the CUDA card unless ``--device cpu`` is given. Under a
running process group of more than one rank it trains on
``make_host_mesh()``, a data mesh over the group's ranks: the state
sharded by the step factory's specs and a checkpoint restored onto them.
Otherwise (one card) it takes the mesh-free step: a one-rank mesh shards
nothing, and its DTensor dispatch would only slow each step down.
Fault-tolerance wired in: checkpoint every N steps (atomic manifests, the
reference's on-disk format), auto-resume from the newest complete
checkpoint, deterministic data cursor. A checkpoint of the reference's
trainer resumes here, and an f32 one of the port's resumes there.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from ..configs import get_config, get_smoke_config
from ..configs.shapes import ShapeSpec, input_specs
from ..device import DeviceLike, resolve_device
from ..models import steps as steps_mod
from ..models.config import ModelConfig
from ..train import checkpoint as ckpt
from ..train.data import SyntheticStream
from ..train.optimizer import OptConfig
from .mesh import make_host_mesh


def train(
    cfg: ModelConfig,
    steps: int = 50,
    global_batch: int = 8,
    seq_len: int = 128,
    ckpt_dir: str | None = None,
    ckpt_every: int = 25,
    stop_after: int | None = None,  # simulate a crash at this step
    resume: bool = True,
    remat: str = "none",
    lr: float = 3e-4,
    log_every: int = 10,
    device: DeviceLike = None,
) -> dict:
    dev = resolve_device(device)
    sharded = dist.is_initialized() and dist.get_world_size() > 1
    mesh = make_host_mesh(device=dev) if sharded else None
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps)

    spec = ShapeSpec("train", seq_len, global_batch, "train")
    bundle = steps_mod.make_train_step(cfg, mesh, input_specs(cfg, spec), opt_cfg, remat=remat,
                                       device=dev)

    stream = SyntheticStream(cfg, global_batch, seq_len)
    state = bundle.init()
    start_step = 0
    if ckpt_dir and resume and (ckpt.latest_step(ckpt_dir) is not None):
        tree, extra = ckpt.restore(ckpt_dir, steps_mod.state_tree(state, cfg),
                                   shardings=bundle.arg_shardings and bundle.arg_shardings[0])
        state = steps_mod.load_state_tree(state, cfg, tree)
        start_step = extra["step"]
        stream.restore(extra["data"])
        print(f"resumed from step {start_step}")

    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in stream.next_batch().items()}
        state, metrics = bundle.fn(state, batch)
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            print(
                f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} "
                f"({(time.time()-t0)/(step-start_step+1):.2f}s/step)",
                flush=True,
            )
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, steps_mod.state_tree(state, cfg),
                      extra={"step": step + 1, "data": stream.snapshot()})
        if stop_after is not None and step + 1 >= stop_after:
            break  # simulated crash/preemption
    return {"losses": losses, "final_loss": losses[-1] if losses else None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' trains there)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    out = train(cfg, steps=args.steps, global_batch=args.global_batch,
                seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, remat=args.remat, lr=args.lr,
                device=args.device)
    print(f"final loss: {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
