"""Inputs made from ``--seed``: corpus, queries and inserted documents.

``make_data`` is a frozen copy of ``chip_smoke.make_data`` (with its
constants). The benchmark keeps its own copy so that a change to the
program cannot move its inputs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from vbench import reference

# chip_smoke's synthetic data: 1000 clusters on a rank-32 latent, centres
# 2.0 N(0, 1) apart, points 0.6 N(0, 1) around their centre, 0.05 noise
N_CLUSTERS, LATENT, CENTER_SCALE, SPREAD, NOISE = 1000, 32, 2.0, 0.6, 0.05


def make_data(n: int, dim: int, seed: int, device):
    """Clustered points on a low-rank latent, projected to dim, plus small
    noise. Returns (n points, a function drawing more from the same
    distribution). Copied from ``chip_smoke.make_data``."""
    g = torch.Generator(device=device).manual_seed(seed)
    proj = torch.randn(LATENT, dim, generator=g, device=device) / math.sqrt(LATENT)
    centers = CENTER_SCALE * torch.randn(N_CLUSTERS, LATENT, generator=g, device=device)

    def draw(m: int):
        assign = torch.randint(N_CLUSTERS, (m,), generator=g, device=device)
        z = centers[assign] + SPREAD * torch.randn(m, LATENT, generator=g, device=device)
        return z @ proj + NOISE * torch.randn(m, dim, generator=g, device=device)

    return draw(n), draw


class Inputs:
    """Everything one run feeds the system, drawn once at set-up, on the
    device, in a few large calls: the corpus, a pool of queries that the
    window cycles through, and a pool of documents for inserts. Both sides
    (the program and the reference) read these arrays and nothing else."""

    def __init__(self, seed: int, n: int, dim: int, queries: int, inserts: int, device):
        # float32 products without TF32, whatever the process set before: a
        # seed gives the same points in every process
        with reference.matmul_precision(False):
            corpus, draw = make_data(n, dim, seed, device)
            pool = draw(queries)
            extra = draw(inserts) if inserts else corpus[:0]
        self.corpus = corpus.cpu().numpy()
        self.queries = pool.cpu().numpy()
        self.extra = extra.cpu().numpy()
