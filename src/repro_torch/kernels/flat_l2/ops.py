"""Wrappers of the flat_l2 kernels: plain versions for CPU tensors, CUDA kernels
otherwise, through the ``repro_torch::flat_l2`` and
``repro_torch::flat_l2_gathered`` operators (``kernels._ops``)."""
from __future__ import annotations

import torch

from .. import _build, _ops
from .ref import flat_l2_gathered_ref, flat_l2_ref


def _metric_ip(metric: str) -> int:
    if metric == "l2":
        return 0
    if metric in ("ip", "cosine"):
        return 1
    raise ValueError(f"unknown metric {metric!r}")


def flat_l2(q: torch.Tensor, x: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Dense distances (B, N) f32 from q (B, D) and x (N, D), both f32 or both
    bf16: l2 = |q|^2 + |x|^2 - 2 q.x clamped at 0, ip = -q.x."""
    ip = _metric_ip(metric)
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError("flat_l2: q (B, D) and x (N, D)")
    if q.dtype != x.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("flat_l2: q and x both float32 or both bfloat16")
    return _DENSE(q, x, ip)


def _dense_launch(q: torch.Tensor, x: torch.Tensor, ip: int) -> torch.Tensor:
    """The CUDA implementation: the f32 (3xTF32) or the bf16 kernel."""
    _build.check_cuda("flat_l2", q, x)
    B, D = q.shape
    N = x.shape[0]
    out = torch.empty((B, N), dtype=torch.float32, device=q.device)
    if B == 0 or N == 0:
        return out
    _build.launch("repro_flat_l2_dense", q.data_ptr(), x.data_ptr(), out.data_ptr(),
                  B, N, D, int(q.dtype == torch.bfloat16), ip)
    if q.dtype == torch.bfloat16:
        flat_l2.bf16_launches += 1
    else:
        flat_l2.launches += 1
    return out


def _dense_flops(q, x, ip, out_val=None) -> int:
    """2·B·N·D: one product and one sum per (query, row, coordinate), three
    times over for f32 (the 3xTF32 kernel's three products)."""
    return (3 if q.dtype == torch.float32 else 1) * 2 * q.shape[0] * x.shape[0] * q.shape[1]


_DENSE = _ops.define(
    "flat_l2", "(Tensor q, Tensor x, int ip) -> Tensor",
    lambda q, x, ip: flat_l2_ref(q, x, _METRICS[ip]), _dense_launch,
    lambda q, x, ip: q.new_empty((q.shape[0], x.shape[0]), dtype=torch.float32), _dense_flops)
_METRICS = ("l2", "ip")


def flat_l2_gathered(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor,
                     metric: str = "l2") -> torch.Tensor:
    """Distances (B, C) f32 from q (B, D) to the rows x[ids[b, c]] of x (N, D),
    difference form (sum (q - x)^2; ip: -q.x). ids < 0 may yield any value."""
    ip = _metric_ip(metric)
    if q.dim() != 2 or x.dim() != 2 or ids.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError("flat_l2_gathered: q (B, D), x (N, D), ids (B, C)")
    if q.shape[0] != ids.shape[0]:
        raise ValueError("flat_l2_gathered: ids must have one row per query")
    if q.dtype != torch.float32 or x.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError("flat_l2_gathered: q, x float32 and ids int32")
    return _GATHERED(q, x, ids, ip)


def _gathered_launch(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor,
                     ip: int) -> torch.Tensor:
    """The CUDA implementation."""
    _build.check_cuda("flat_l2_gathered", q, x, ids)
    B, D = q.shape
    N, C = x.shape[0], ids.shape[1]
    out = torch.empty((B, C), dtype=torch.float32, device=q.device)
    if B == 0 or C == 0:
        return out
    _build.launch("repro_flat_l2_gathered", q.data_ptr(), x.data_ptr(), ids.data_ptr(),
                  out.data_ptr(), B, N, C, D, ip)
    flat_l2_gathered.launches += 1
    return out


def _gathered_flops(q, x, ids, ip, out_val=None) -> int:
    """3·B·C·D: a difference, a product and a sum per coordinate."""
    return 3 * ids.shape[0] * ids.shape[1] * q.shape[1]


_GATHERED = _ops.define(
    "flat_l2_gathered", "(Tensor q, Tensor x, Tensor ids, int ip) -> Tensor",
    lambda q, x, ids, ip: flat_l2_gathered_ref(q, x, ids, _METRICS[ip]), _gathered_launch,
    lambda q, x, ids, ip: q.new_empty(tuple(ids.shape), dtype=torch.float32), _gathered_flops)


flat_l2.launches = 0  # f32, the tensor-core kernel
flat_l2.bf16_launches = 0
flat_l2_gathered.launches = 0
