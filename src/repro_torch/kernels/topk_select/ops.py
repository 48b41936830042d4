"""Wrapper of the topk_select kernels: plain version for CPU tensors, the CUDA
kernels otherwise, through the ``repro_torch::topk_select`` operator
(``kernels._ops``)."""
from __future__ import annotations

import math

import torch

from .. import _build, _ops
from .ref import topk_select_ref

RANK_MAX_N = 1024  # kRankMaxN in kernel.cu: longer rows take the long form
LONG_MAX_L = 1024  # kLongMaxL in kernel.cu: larger L takes the sort or radix form
LONG_BLOCKS = 256  # stage-1 blocks (one per chunk) the long form aims for: 2 per SM on 132
LONG_MIN_CHUNK = 1024  # shortest chunk worth a block of its own
SORT_MIN_P = 2048  # kSortMinP: keys a sort block holds at least (1024 threads, 2 keys each)
SORT_MAX_N = 16384  # kSortMaxP: longer rows (at L > LONG_MAX_L) take the radix form
RADIX_MIN_P = 4096  # the radix form's sort holds at least this many candidates
RADIX_DIGIT_BITS = 11  # kDigitBits: bits of the key a histogram pass resolves
RADIX_BLOCKS = 256  # blocks (one per chunk) a radix pass aims for: 2 per SM on 132
RADIX_MIN_CHUNK = 4096  # shortest chunk worth a block of its own
RADIX_STATE_BYTES = 24  # sizeof(RowState) in kernel.cu


# form codes of the C launcher
FORMS = {"rank": 0, "long": 1, "sort": 2, "radix": 3}


def topk_form(N: int, L: int) -> str:
    """The kernel form for rows of N keeping L, from the shape alone: rows up
    to RANK_MAX_N take the rank form (a bitonic sort in registers), longer
    ones the two-stage long form while L <= LONG_MAX_L; a larger L takes the
    sort form (one block sorts the row) up to SORT_MAX_N entries, the radix
    select above."""
    if N <= RANK_MAX_N:
        return "rank"
    if L <= LONG_MAX_L:
        return "long"
    return "sort" if N <= SORT_MAX_N else "radix"


def sort_keys(n: int, least: int = SORT_MIN_P) -> int:
    """Keys a sort block holds for n: a power of two >= max(n, least), at most
    SORT_MAX_N."""
    return min(SORT_MAX_N, max(least, 1 << max(0, n - 1).bit_length()))


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


def radix_plan(B: int, N: int, L: int, min_p: int = RADIX_MIN_P,
               blocks: int = RADIX_BLOCKS) -> dict:
    """The radix form's launch plan (radix_layout in kernel.cu computes the
    same): keys of 32 value bits and pos_bits position bits, at most
    ``passes`` histogram passes of RADIX_DIGIT_BITS; each row in S chunks of
    ``chunk`` entries (multiples of 4, none empty) so B*S blocks reach about
    ``blocks``; a sort of P keys, so a row is done once at most cap =
    max(P, L) keys share or lie below its prefix; for L > P, ``runs`` sorted
    runs of P joined by ``rounds`` merge passes. ``kernels``: launches a call
    makes (clear, passes, compact, sort, merges); ``ws_bytes``: its
    workspace."""
    pos_bits = max(1, (N - 1).bit_length())
    passes = -(-(32 + pos_bits) // RADIX_DIGIT_BITS)
    P = sort_keys(L, min_p)
    cap = max(P, L)
    runs = -(-L // P) if L > P else 1
    rounds = (runs - 1).bit_length()
    want = max(1, math.ceil(blocks / max(B, 1)))
    s = max(1, min(want, N // RADIX_MIN_CHUNK))
    chunk = 4 * math.ceil(math.ceil(N / s) / 4)
    hist = passes * B * (1 << RADIX_DIGIT_BITS) * 4
    at = -(-(hist + B * 4) // 16) * 16
    at = -(-(at + 2 * B * RADIX_STATE_BYTES) // 16) * 16
    ws = at + B * cap * 8 * (2 if runs > 1 else 1)
    return dict(pos_bits=pos_bits, passes=passes, P=P, cap=cap, runs=runs, rounds=rounds,
                S=math.ceil(N / chunk), chunk=chunk, kernels=3 + passes + rounds, ws_bytes=ws)


def kernels_per_call(B: int, N: int, L: int) -> int:
    """The CUDA kernels one topk_select call launches (for device timing)."""
    form = topk_form(N, L)
    if form == "long":
        return 2
    return radix_plan(B, N, L)["kernels"] if form == "radix" else 1


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
    return _OP(dists, L, mark_nonfinite)


def _launch(dists: torch.Tensor, L: int, mark_nonfinite: bool
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA implementation: the form the shape picks."""
    B, N = dists.shape
    _build.check_cuda("topk_select", dists)
    vals = torch.empty((B, L), dtype=torch.float32, device=dists.device)
    idx = torch.empty((B, L), dtype=torch.int32, device=dists.device)
    if B == 0:
        return vals, idx
    form = topk_form(N, L)
    S, chunk, P, ws = 1, N, 0, None
    if form == "long":
        S, chunk = long_chunks(B, N, L)
        ws = torch.empty((B, S, L), dtype=torch.int64, device=dists.device)
    elif form == "sort":
        P = sort_keys(N)
    elif form == "radix":
        plan = radix_plan(B, N, L)
        S, chunk, P = plan["S"], plan["chunk"], plan["P"]
        ws = torch.empty(plan["ws_bytes"], dtype=torch.uint8, device=dists.device)
    _build.launch("repro_topk_select", dists.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                  None if ws is None else ws.data_ptr(), B, N, L, S, chunk, P,
                  int(mark_nonfinite), FORMS[form])
    setattr(topk_select, f"{form}_launches", getattr(topk_select, f"{form}_launches") + 1)
    return vals, idx


def _fake(dists, L, mark_nonfinite):
    B = dists.shape[0]
    return dists.new_empty((B, L)), dists.new_empty((B, L), dtype=torch.int32)


def _flops(dists, L, mark_nonfinite, out_val=None) -> int:
    """One comparison per key: B·N."""
    return dists.shape[0] * dists.shape[1]


_OP = _ops.define("topk_select", "(Tensor dists, int L, bool mark_nonfinite) -> (Tensor, Tensor)",
                  topk_select_ref, _launch, _fake, _flops)
topk_select.rank_launches = 0
topk_select.long_launches = 0
topk_select.sort_launches = 0
topk_select.radix_launches = 0
