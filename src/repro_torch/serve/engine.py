"""ServeEngine — batched LM serving (prefill + decode) for the arch pool
(the port of ``repro.serve.engine``).

Continuous-batching-lite: requests join a fixed-width slot table; prefill
fills a slot's KV cache, decode advances all active slots one token per
step, finished slots are recycled. Greedy sampling (temperature 0, the
first index on ties) keeps tests deterministic.

The reference's quirks are kept bit for bit: the caches are f32 whatever
``param_dtype`` says; each admitted prompt is prefilled alone into a fresh
one-slot cache and copied into its slot; and a step runs one batched
decode at the *first active slot's* ``cache_len`` for every slot, so slots
admitted at different times share one write position and one mask. The
SSM states of every slot, empty ones included, advance at each step, and
an SSM prompt longer than its chunk must be a multiple of it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import model as M
from ..models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: M.Model, batch_slots: int = 4,
                 s_max: int = 256, eos_id: Optional[int] = None):
        assert cfg.has_decode, "encoder-only archs cannot serve decode"
        # the engine runs where the model lies: init_params puts it on the
        # card unless the caller asks for the CPU
        where = {p.device for p in model.parameters()}
        if len(where) != 1:
            raise ValueError(f"model parameters on {sorted(map(str, where))}")
        self.device = resolve_device(where.pop())
        self.cfg = cfg
        self.model = model
        self.slots: list[Optional[Request]] = [None] * batch_slots
        self.s_max = s_max
        self.eos = eos_id
        self.cache = M.init_cache(cfg, batch_slots, s_max, torch.float32, self.device)
        self.cache_len = np.zeros(batch_slots, np.int32)
        self.queue: list[Request] = []
        self.completed: dict[int, Request] = {}

    # ------------------------------------------------------------------
    def submit(self, rid: int, prompt: np.ndarray, max_new_tokens: int = 16):
        self.queue.append(Request(rid, np.asarray(prompt, np.int32), max_new_tokens))

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    def _admit(self):
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                # per-slot prefill into a fresh one-slot cache
                batch = {"tokens": self._tokens(req.prompt[None, :])}
                cache_i = M.init_cache(self.cfg, 1, self.s_max, torch.float32, self.device)
                logits, cache_i = M.prefill(self.model, self.cfg, batch, cache_i)
                self._write_slot_cache(i, cache_i)
                self.cache_len[i] = len(req.prompt)
                req.out_tokens.append(int(torch.argmax(logits[0, 0])))

    def _write_slot_cache(self, i: int, cache_i):
        # caches are lists of per-segment stacks (KV caches or SSM state
        # dicts) with leaves (seg, B, ...)
        for full, one in zip(self.cache, cache_i):
            for f, o in zip(M.cache_leaves(full), M.cache_leaves(one)):
                f[:, i:i + 1] = o.to(f.dtype)

    # ------------------------------------------------------------------
    def step(self):
        """Admit waiting requests, run one decode step for active slots."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return False
        tokens = np.zeros((len(self.slots), 1), np.int32)
        for i in active:
            tokens[i, 0] = self.slots[i].out_tokens[-1]
        # one batched decode step at the first active slot's cache_len
        logits, self.cache = M.decode_step(self.model, self.cfg, self._tokens(tokens),
                                           self.cache, int(self.cache_len[active[0]]))
        next_tok = torch.argmax(logits[:, 0], dim=-1).tolist()
        for i in active:
            req = self.slots[i]
            tok = next_tok[i]
            req.out_tokens.append(tok)
            self.cache_len[i] += 1
            if len(req.out_tokens) >= req.max_new_tokens or (
                self.eos is not None and tok == self.eos
            ) or self.cache_len[i] >= self.s_max - 1:
                req.done = True
                self.completed[req.rid] = req
                self.slots[i] = None
        return True

    def run(self, max_steps: int = 1000) -> dict[int, list[int]]:
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        return {rid: r.out_tokens for rid, r in self.completed.items()}
