"""Wrapper of the pq_adc kernels: plain version for CPU tensors, a CUDA kernel
otherwise, through the ``repro_torch::pq_adc`` operator (``kernels._ops``)."""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build, _ops
from .ref import pq_adc_ref

SMEM_PER_BLOCK = 232_448  # Hopper's opt-in shared memory per block (H100, H200)
# Fewer rows per query than this take the l2 form: the staged form costs
# 5-6 us whatever the rows (the version OR, barriers, one copy per chunk),
# the l2 form about 0.04 us more per row per query at B=128. Measured on the
# H100 (scripts/torch_round_kernels.py --designs, M=96, K=256, rows of two
# schemas / of one; PERF.md): at 96 rows l2 0.00584 / 0.00485 ms
# against staged 0.00622 / 0.00553, at 112 rows l2 0.00693 / 0.00546
# against 0.00626 / 0.00559. So the build's beam (W=1, 41 rows) takes l2,
# the search round (W=4, 164 rows) staged. The search's start node (C=1)
# and a few rows through adc_distance_versioned take l2 too, and so does a
# table one block cannot hold (V*M*K*4 past about 210 KB, e.g. M=192 or
# three schemas at M=96): no configuration of the index has one.
STAGED_MIN_ROWS = 100
# staged form: candidates per pass (two threads each), the bytes before the
# table, most schema versions (one 32-bit mask) -- kStagedTile, kHeader and
# the mask in kernel.cu
STAGED_TILE = 192
STAGED_HEADER = 128
STAGED_MAX_V = 32
# form codes of the C launcher
FORMS = {"gathered_l2": 0, "gathered": 1, "dense": 2}
# designs of the dense form that adc_form does not take (kernel.cu), timed by
# scripts/torch_scan_kernels.py --designs
DENSE_DESIGNS = {"singles": 3}
DENSE_MAX_V = 8  # versions the dense kernel spreads by three ballots


def staged_smem_bytes(V: int, M: int, K: int) -> int:
    """Dynamic shared memory of one staged block (staged_smem in kernel.cu):
    the header, V tables of M x K, and per candidate of a tile its code bytes
    (an odd number of words)."""
    stride = ((-(-M // 4)) | 1) * 4
    return STAGED_HEADER + V * M * K * 4 + STAGED_TILE * stride


def dense_subspace(slot: int, lane: int, M: int, pairs: int) -> int:
    """The dense form's lane plan (dense_m in kernel.cu): the subspace that
    lane ``lane`` looks up in ``slot``, or -1. The first 64 * pairs
    subspaces go two to a lane, the rest one to a lane."""
    if slot < 2 * pairs:
        return 64 * (slot // 2) + 2 * lane + slot % 2
    m = 64 * pairs + 32 * (slot - 2 * pairs) + lane
    return m if m < M else -1


def dense_pairs(M: int) -> int:
    """Pair groups of the dense form's plan (2-byte code loads; M even)."""
    return M // 64 if M % 2 == 0 else 0


def dense_smem_bytes(V: int, M: int, K: int) -> int:
    """Shared memory of a dense block: V tables of ceil(M/32) slots x K codes
    x 32 lanes of f32."""
    return V * -(-M // 32) * K * 32 * 4


def dense_word(v: int, slot: int, code: int, lane: int, K: int, V: int) -> int:
    """The shared-memory word of (v, slot, code) for ``lane``: its bank is the
    lane, and a table's V versions of an entry sit side by side."""
    return ((slot * K + code) * V + v) * 32 + lane


def adc_form(C: int, V: int, M: int, K: int, gathered: bool) -> str:
    """The kernel form for C rows per query ('gathered', 'gathered_l2' or
    'dense'), from the shape alone."""
    if C < STAGED_MIN_ROWS:
        return "gathered_l2"
    if not gathered:
        fits = dense_smem_bytes(V, M, K) <= SMEM_PER_BLOCK and K % 4 == 0 and V <= DENSE_MAX_V
        return "dense" if fits else "gathered_l2"
    fits = staged_smem_bytes(V, M, K) <= SMEM_PER_BLOCK
    return "gathered" if fits and K % 4 == 0 and V <= STAGED_MAX_V else "gathered_l2"


def pq_adc(luts: torch.Tensor, codes: torch.Tensor, versions: torch.Tensor,
           ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ADC distances (B, C) = sum_m luts[b, versions[r], m, codes[r, m]].

    luts (B, V, M, K) f32, codes (N, M) u8, versions (N,) u8; with ids (B, C)
    i32 the rows are r = ids[b, c] (gathered form, one beam round), without
    them every row r = c of the N (dense form, Q-Flat). ids < 0 may yield any
    value; callers mask those lanes."""
    if luts.dim() != 4 or codes.dim() != 2 or versions.dim() != 1:
        raise ValueError("pq_adc: luts (B,V,M,K), codes (N,M), versions (N,)")
    B, V, M, K = luts.shape
    N = codes.shape[0]
    if codes.shape[1] != M or versions.shape[0] != N:
        raise ValueError(f"pq_adc: codes {tuple(codes.shape)} / versions "
                         f"{tuple(versions.shape)} do not match M={M}")
    if luts.dtype != torch.float32 or codes.dtype != torch.uint8 or versions.dtype != torch.uint8:
        raise TypeError("pq_adc: luts f32, codes u8, versions u8")
    if ids is not None and (ids.dim() != 2 or ids.shape[0] != B or ids.dtype != torch.int32):
        raise ValueError("pq_adc: ids must be (B, C) int32")
    return _OP(luts, codes, versions, ids)


def _launch(luts: torch.Tensor, codes: torch.Tensor, versions: torch.Tensor,
            ids: Optional[torch.Tensor]) -> torch.Tensor:
    """The CUDA implementation: one launch of the form the shape picks."""
    B, V, M, K = luts.shape
    N = codes.shape[0]
    tensors = (luts, codes, versions) + ((ids,) if ids is not None else ())
    _build.check_cuda("pq_adc", *tensors)
    C = N if ids is None else ids.shape[1]
    out = torch.empty((B, C), dtype=torch.float32, device=luts.device)
    if B == 0 or C == 0:
        return out
    form = adc_form(C, V, M, K, ids is not None)
    if form != "gathered_l2" and luts.data_ptr() % 16:
        luts = luts.clone()  # the table copies need 16-byte alignment; a fresh tensor has it
    _build.launch(
        "repro_pq_adc", luts.data_ptr(), codes.data_ptr(), versions.data_ptr(),
        ids.data_ptr() if ids is not None else None, out.data_ptr(),
        B, V, M, K, N, C, FORMS[form],
    )
    setattr(pq_adc, f"{form}_launches", getattr(pq_adc, f"{form}_launches") + 1)
    return out


def _fake(luts, codes, versions, ids):
    C = codes.shape[0] if ids is None else ids.shape[1]
    return luts.new_empty((luts.shape[0], C))


def _flops(luts, codes, versions, ids, out_val=None) -> int:
    """One addition per subspace for each (query, row): B·C·M (the bound
    counts the rows with a valid id; a fake tensor cannot tell them)."""
    return out_val.shape[0] * out_val.shape[1] * luts.shape[2]


_OP = _ops.define("pq_adc", "(Tensor luts, Tensor codes, Tensor versions, Tensor? ids) -> Tensor",
                  pq_adc_ref, _launch, _fake, _flops)
pq_adc.gathered_launches = 0
pq_adc.gathered_l2_launches = 0
pq_adc.dense_launches = 0
