"""Wrapper of the pq_encode kernel: plain version for CPU tensors, the CUDA
kernel otherwise, through the ``repro_torch::pq_encode`` operator
(``kernels._ops``)."""
from __future__ import annotations

import torch

from .. import _build, _ops
from .ref import pq_encode_ref

MAX_DSUB = 32  # the kernel keeps one row's subvector in registers


def pq_encode(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per subspace: x (N, D) f32, codebooks (M, K, dsub)
    f32 with D = M * dsub and K <= 256 -> codes (N, M) u8."""
    if x.dim() != 2 or codebooks.dim() != 3:
        raise ValueError("pq_encode: x (N, D), codebooks (M, K, dsub)")
    N, D = x.shape
    M, K, dsub = codebooks.shape
    if D != M * dsub or K > 256:
        raise ValueError(f"pq_encode: D={D} != M*dsub={M}*{dsub} or K={K} > 256")
    if x.dtype != torch.float32 or codebooks.dtype != torch.float32:
        raise TypeError("pq_encode: x and codebooks float32")
    if x.device.type == "cuda" and dsub > MAX_DSUB:
        raise ValueError(f"pq_encode: dsub={dsub} > {MAX_DSUB}")
    return _OP(x, codebooks)


def _launch(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """The CUDA implementation."""
    N = x.shape[0]
    M, K, dsub = codebooks.shape
    _build.check_cuda("pq_encode", x, codebooks)
    codes = torch.empty((N, M), dtype=torch.uint8, device=x.device)
    if N == 0:
        return codes
    _build.launch("repro_pq_encode", x.data_ptr(), codebooks.data_ptr(), codes.data_ptr(),
                  N, M, K, dsub)
    pq_encode.launches += 1
    # launches by rows, so a table can weigh each shape's time
    pq_encode.launches_by_rows[N] = pq_encode.launches_by_rows.get(N, 0) + 1
    return codes


def _fake(x, codebooks):
    return x.new_empty((x.shape[0], codebooks.shape[0]), dtype=torch.uint8)


def _flops(x, codebooks, out_val=None) -> int:
    """A product and a sum per centroid coordinate: N·M·K·2·dsub."""
    M, K, dsub = codebooks.shape
    return x.shape[0] * M * K * 2 * dsub


_OP = _ops.define("pq_encode", "(Tensor x, Tensor codebooks) -> Tensor",
                  pq_encode_ref, _launch, _fake, _flops)
pq_encode.launches = 0
pq_encode.launches_by_rows = {}
