"""Wrapper of the pq_adc kernel: plain version for CPU tensors, the CUDA kernel otherwise."""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from .ref import pq_adc_ref


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
    if luts.device.type == "cpu":
        return pq_adc_ref(luts, codes, versions, ids)
    tensors = (luts, codes, versions) + ((ids,) if ids is not None else ())
    _build.check_cuda("pq_adc", *tensors)
    C = N if ids is None else ids.shape[1]
    out = torch.empty((B, C), dtype=torch.float32, device=luts.device)
    if B == 0 or C == 0:
        return out
    _build.launch(
        "repro_pq_adc", luts.data_ptr(), codes.data_ptr(), versions.data_ptr(),
        ids.data_ptr() if ids is not None else None, out.data_ptr(),
        B, V, M, K, N, C,
    )
    if ids is None:
        pq_adc.dense_launches += 1
    else:
        pq_adc.gathered_launches += 1
    return out


pq_adc.dense_launches = 0
pq_adc.gathered_launches = 0
