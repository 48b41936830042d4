"""Step factories: train / prefill / decode (the port of
``repro.models.steps``).

Each factory returns a ``StepBundle``: the step function, stand-ins for
every argument as tensors on ``device="meta"`` (shapes and dtypes, no
storage: what the reference's ``ShapeDtypeStruct`` trees give a dry-run),
and, for the train step, ``init``, which builds the real initial state.
The reference's ``mesh`` and shardings wait for the port's multi-card
decision: the factories take a ``device`` (the card unless the caller
asks otherwise) instead.

The train step updates its state in place (parameters and moments), the
port's counterpart of the reference's donated state. With ``accum`` > 1
the batch is split into ``accum`` micro-batches along its leading axis and
their gradients are summed in f32, as the reference sums them into f32
zeros, then averaged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..train.optimizer import OptConfig, OptState, adamw_update, init_opt_state
from . import model as M
from .config import ModelConfig


class TrainState(NamedTuple):
    params: M.Model
    opt: OptState  # one moment per parameter, in ``params.parameters()`` order


@dataclasses.dataclass
class StepBundle:
    fn: Callable  # the step
    arg_shapes: tuple  # meta-tensor stand-ins for fn's arguments
    init: Optional[Callable] = None  # builds the real initial state


def state_tree(state: TrainState, cfg: ModelConfig) -> dict:
    """The state keyed as the reference's ``TrainState`` pytree is
    (``params/blocks/0/mixer/wq`` stacked, ``opt/m/...``, ``opt/v/...``,
    ``opt/step``): what a checkpoint holds."""
    model, opt = state
    return {"params": M.reference_tree(model, cfg),
            "opt": {"m": M.reference_tree(model, cfg, opt.m),
                    "v": M.reference_tree(model, cfg, opt.v), "step": opt.step}}


def load_state_tree(state: TrainState, cfg: ModelConfig, tree: dict) -> TrainState:
    """Copy a ``state_tree``-keyed tree (e.g. restored from a checkpoint)
    into ``state`` in place; returns the state with the tree's step."""
    model, opt = state
    M.load_reference_tree(model, cfg, tree["params"])
    M.load_reference_tree(model, cfg, tree["opt"]["m"], opt.m)
    M.load_reference_tree(model, cfg, tree["opt"]["v"], opt.v)
    step = torch.as_tensor(tree["opt"]["step"], dtype=torch.int32).to(opt.step.device)
    return TrainState(model, opt._replace(step=step))


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def make_train_step(
    cfg: ModelConfig,
    batch_shapes: dict,
    opt_cfg: OptConfig = OptConfig(),
    remat: str = "full",
    accum: int = 1,
    seed: int = 0,
    device: DeviceLike = None,
) -> StepBundle:
    """fn(state, batch) -> (state, {"loss", "grad_norm", "lr"}), the batch's
    tensors on the state's device. ``init`` draws the weights from
    ``torch.Generator(device).manual_seed(seed)``."""
    dev = resolve_device(device)
    shapes = M.param_shapes(cfg)
    state_shapes = TrainState(shapes, init_opt_state(list(shapes.parameters()), opt_cfg))

    def grads_of(model: M.Model, params: list, batch: dict):
        loss, _ = M.loss_fn(model, cfg, batch, remat)
        return loss.detach(), torch.autograd.grad(loss, params)

    def step(state: TrainState, batch: dict):
        model = state.params
        params = list(model.parameters())
        if accum > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, grads = grads_of(model, params, mb)
                for s, g in zip(gsum, grads):
                    s.add_(g)
                lsum = lsum + loss
            grads = [s / accum for s in gsum]
            loss = lsum / accum
        else:
            loss, grads = grads_of(model, params, batch)
        opt, metrics = adamw_update(params, grads, state.opt, opt_cfg,
                                    M.reference_ndims(model, cfg))
        return TrainState(model, opt), {"loss": loss, **metrics}

    def init() -> TrainState:
        model = M.init_params(torch.Generator(dev).manual_seed(seed), cfg, dev)
        return TrainState(model, init_opt_state(list(model.parameters()), opt_cfg))

    return StepBundle(fn=step, arg_shapes=(state_shapes, batch_shapes), init=init)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def make_prefill_step(
    cfg: ModelConfig,
    batch_shapes: dict,
    s_max: int,
    cache_dtype=torch.bfloat16,
    device: DeviceLike = None,
) -> StepBundle:
    """fn(model, batch) -> (last-position logits, a new cache of s_max
    positions holding the prompt)."""
    dev = resolve_device(device)
    B = next(iter(batch_shapes.values())).shape[0]

    def step(model: M.Model, batch: dict):
        return M.prefill(model, cfg, batch, M.init_cache(cfg, B, s_max, cache_dtype, dev))

    return StepBundle(fn=step, arg_shapes=(M.param_shapes(cfg), batch_shapes))


def make_decode_step(
    cfg: ModelConfig,
    batch: int,
    s_max: int,
    cache_dtype=torch.bfloat16,
) -> StepBundle:
    """fn(model, cache, tokens, cache_len) -> (logits, the cache written in
    place), on the model's device; tokens (batch, 1) ids, or (batch, 1,
    d_model) frames."""
    if cfg.input_mode == "frames":
        tok = torch.empty((batch, 1, cfg.d_model), dtype=torch.bfloat16, device="meta")
    else:
        tok = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    length = torch.empty((), dtype=torch.int32, device="meta")

    def step(model: M.Model, cache, tokens, cache_len):
        return M.decode_step(model, cfg, tokens, cache, int(cache_len))

    return StepBundle(fn=step, arg_shapes=(M.param_shapes(cfg), M.cache_shapes(
        cfg, batch, s_max, cache_dtype), tok, length))
