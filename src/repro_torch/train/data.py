"""Deterministic synthetic data pipeline (token / frame / vlm batches): the
port's copy of ``repro.train.data``, numpy only, so its batches are the
reference's byte for byte.

Production-shaped: sharded per-host loading (each data-parallel host slice
generates only its shard), a resumable cursor that checkpoints with the
train state, and packing-free fixed-length batches. Content is synthetic
(seeded PRNG over a Zipf-ish unigram table) — the substrate the paper's
workloads (embedding corpora) would stream through.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..models.config import ModelConfig


@dataclasses.dataclass
class DataState:
    step: int = 0
    seed: int = 0


class SyntheticStream:
    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        assert global_batch % num_hosts == 0
        self.cfg = cfg
        self.local_batch = global_batch // num_hosts
        self.seq = seq_len
        self.state = DataState(step=0, seed=seed)
        self.host = host_id
        # Zipf-ish unigram distribution for non-degenerate CE losses
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self._probs = (1.0 / ranks**1.1)
        self._probs /= self._probs.sum()

    def _rng(self) -> np.random.RandomState:
        return np.random.RandomState(
            (self.state.seed * 1_000_003 + self.state.step * 7919 + self.host) % (2**31)
        )

    def next_batch(self) -> dict:
        rng = self._rng()
        self.state.step += 1
        cfg, B, S = self.cfg, self.local_batch, self.seq
        if cfg.input_mode == "tokens":
            tok = rng.choice(cfg.vocab_size, size=(B, S), p=self._probs).astype(np.int32)
            return {"tokens": tok}
        if cfg.input_mode == "frames":
            return {
                "frames": rng.randn(B, S, cfg.d_model).astype(np.float32),
                "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
            }
        Ni = cfg.num_image_tokens
        return {
            "tokens": rng.choice(cfg.vocab_size, size=(B, S - Ni), p=self._probs).astype(np.int32),
            "image_embeds": rng.randn(B, Ni, cfg.d_model).astype(np.float32),
        }

    # -- checkpointable cursor ------------------------------------------
    def snapshot(self) -> dict:
        return dataclasses.asdict(self.state)

    def restore(self, snap: dict):
        self.state = DataState(**snap)
