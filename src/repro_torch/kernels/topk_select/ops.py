"""Wrapper of the topk_select kernels: plain version for CPU tensors, the CUDA kernels otherwise."""
from __future__ import annotations

import math

import torch

from .. import _build
from .ref import topk_select_ref

RANK_MAX_N = 1024  # kRankMaxN in kernel.cu: longer rows take the long form
LONG_MAX_L = 1024  # kLongMaxL in kernel.cu: larger L takes the iterating form
LONG_BLOCKS = 256  # stage-1 blocks (one per chunk) the long form aims for: 2 per SM on 132
LONG_MIN_CHUNK = 1024  # shortest chunk worth a block of its own


# form codes of the C launcher
FORMS = {"rank": 0, "long": 1, "iter": 2}


def topk_form(N: int, L: int) -> str:
    """The kernel form for rows of N keeping L, from the shape alone: rows up
    to RANK_MAX_N take the rank form (a bitonic sort), longer ones the
    two-stage long form, and L > LONG_MAX_L the iterating one."""
    if N <= RANK_MAX_N:
        return "rank"
    return "long" if L <= LONG_MAX_L else "iter"


def long_chunks(B: int, N: int, L: int) -> tuple[int, int]:
    """(S, chunk) of the long form: each row in S chunks of ``chunk`` entries
    (a multiple of 4, so 16-byte loads stay aligned; the last chunk may be
    shorter, none is empty), enough chunks that B*S blocks reach about
    LONG_BLOCKS, each chunk at least max(L, LONG_MIN_CHUNK) long unless the
    row is shorter, so the merge reads S*L <= max(N, L) keys."""
    want = max(1, math.ceil(LONG_BLOCKS / max(B, 1)))
    s = max(1, min(want, N // max(L, LONG_MIN_CHUNK)))
    chunk = 4 * math.ceil(math.ceil(N / s) / 4)
    return math.ceil(N / chunk), chunk


def topk_select(dists: torch.Tensor, L: int, mark_nonfinite: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The L smallest of each row of (B, N) f32: (vals (B, L), idx (B, L) i32),
    ascending, ties to the lower position, +inf entries included. Raw
    positions by default (the beam merge and frontier pick gather by them);
    ``mark_nonfinite`` writes -1 for non-finite values (brute force, Q-Flat,
    rerank)."""
    if dists.dim() != 2 or dists.dtype != torch.float32:
        raise ValueError("topk_select: dists must be (B, N) float32")
    B, N = dists.shape
    if not 0 < L <= N:
        raise ValueError(f"topk_select: need 0 < L={L} <= N={N}")
    if dists.device.type == "cpu":
        return topk_select_ref(dists, L, mark_nonfinite)
    _build.check_cuda("topk_select", dists)
    vals = torch.empty((B, L), dtype=torch.float32, device=dists.device)
    idx = torch.empty((B, L), dtype=torch.int32, device=dists.device)
    if B == 0:
        return vals, idx
    form = topk_form(N, L)
    S, chunk, ws = 1, N, None
    if form == "long":
        S, chunk = long_chunks(B, N, L)
        ws = torch.empty((B, S, L), dtype=torch.int64, device=dists.device)
    _build.launch("repro_topk_select", dists.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                  None if ws is None else ws.data_ptr(), B, N, L, S, chunk,
                  int(mark_nonfinite), FORMS[form])
    setattr(topk_select, f"{form}_launches", getattr(topk_select, f"{form}_launches") + 1)
    return vals, idx


topk_select.rank_launches = 0
topk_select.long_launches = 0
topk_select.iter_launches = 0
