"""AdamW with warmup-cosine schedule, global-norm clipping, and optional
low-precision moments (the port of ``repro.train.optimizer``).

Master arithmetic in f32 whatever the parameter's dtype: a bf16 parameter
gets its update in f32, cast back. ``m`` and ``v`` keep ``m_dtype`` and
``v_dtype`` (f32 by default), unlike ``torch.optim.AdamW``, which keeps
bf16 moments for bf16 parameters. The state holds one moment per
parameter, in the order of the parameter list, and ``adamw_update``
writes the parameters and moments in place.

Weight decay applies to leaves of two or more dimensions *in the
reference's stacked pytree*: ``ndims`` gives each leaf's count there (a
layer's leaf carries the stack's leading axis, so its 1-D norm scales and
biases are decayed; ``models.model.reference_ndims``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    m_dtype: str = "float32"
    v_dtype: str = "float32"


class OptState(NamedTuple):
    m: list  # one per parameter, m_dtype
    v: list  # one per parameter, v_dtype
    step: torch.Tensor  # () int32: updates taken


def _dt(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def init_opt_state(params: Sequence[torch.Tensor], cfg: OptConfig) -> OptState:
    """Zero moments beside each parameter, on its device (a DTensor
    parameter's moments are DTensors of its placements)."""
    m = [torch.zeros_like(p, dtype=_dt(cfg.m_dtype)) for p in params]
    v = [torch.zeros_like(p, dtype=_dt(cfg.v_dtype)) for p in params]
    dev = params[0].device if params else None
    return OptState(m=m, v=v, step=torch.zeros((), dtype=torch.int32, device=dev))


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine to a tenth of it, in f32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over every leaf of its squares, in f32. A sharded
    leaf's (DTensor) sum is reduced over every rank first, so the norm is
    the whole gradient's."""
    return torch.sqrt(torch.stack([_full(g.float().square().sum()) for g in grads]).sum())


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if hasattr(t, "full_tensor") else t


@torch.no_grad()
def adamw_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                 state: OptState, cfg: OptConfig,
                 ndims: Optional[Sequence[int]] = None) -> tuple[OptState, dict]:
    """One AdamW step over ``params`` (written in place), its gradients
    clipped by their f32 global norm. ``ndims``: each leaf's dimension
    count in the reference's pytree (default its own). Returns the new
    state (its moments written in place) and {"grad_norm", "lr"}."""
    ndims = [p.ndim for p in params] if ndims is None else ndims
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    stepf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    for p, g, m, v, nd in zip(params, grads, state.m, state.v, ndims):
        g = g.float() * scale
        m32 = m.float() * cfg.b1 + g * (1.0 - cfg.b1)
        v32 = v.float() * cfg.b2 + g * g * (1.0 - cfg.b2)
        delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        p32 = p.float()
        if nd >= 2:
            delta = delta + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return OptState(m=state.m, v=state.v, step=step), {"grad_norm": gnorm, "lr": lr}
