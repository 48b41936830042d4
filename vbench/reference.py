"""The plain reference: exact nearest neighbours by brute force.

Plain PyTorch, computed on the device it is given in blocks of queries, in
float32 with TF32 off. It reads only the arrays the harness made from the
seed (corpus, inserted documents, queries) and imports nothing of the
program. ``precision="tf32"`` computes the same in TF32: that is the
control, the reference put in the program's place one precision below the
configuration's float32 (on the CPU, where there is no TF32, the operands'
mantissas are rounded to TF32's 10 bits, which is what the tensor cores do
to them).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

QUERY_BLOCK = 1024  # queries per distance block
ROW_BLOCK = 65536  # corpus rows per distance block


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for float32 products, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) with its mantissa rounded to TF32's 10 bits."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def sq_dists(q: torch.Tensor, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(B, N) squared L2 distances, ||q||² - 2 q·x + ||x||²."""
    tf32 = precision == "tf32"
    if tf32 and q.device.type == "cpu":
        q, x = round_tf32(q), round_tf32(x)
    with matmul_precision(tf32):
        d = q.square().sum(1, keepdim=True) - 2.0 * (q @ x.T) + x.square().sum(1)[None, :]
    return d.clamp_min_(0.0)


def exact_topk(queries: np.ndarray, corpus: np.ndarray, k: int, device,
               precision: str = "f32") -> tuple[np.ndarray, np.ndarray]:
    """The k nearest rows of ``corpus`` to each query: (ids (B, k) int64,
    squared distances (B, k) float32), ascending, ties to the lower row."""
    dev = torch.device(device)
    B = len(queries)
    ids = np.empty((B, k), np.int64)
    dists = np.empty((B, k), np.float32)
    for lo in range(0, B, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, B)
        q = torch.from_numpy(np.ascontiguousarray(queries[lo:hi])).to(dev)
        best_d = torch.full((hi - lo, 0), float("inf"), device=dev)
        best_i = torch.zeros((hi - lo, 0), dtype=torch.int64, device=dev)
        for r0 in range(0, len(corpus), ROW_BLOCK):
            r1 = min(r0 + ROW_BLOCK, len(corpus))
            x = torch.from_numpy(np.ascontiguousarray(corpus[r0:r1])).to(dev)
            d = sq_dists(q, x, precision)
            rows = torch.arange(r0, r1, device=dev)
            cand_d = torch.cat([best_d, d], 1)
            cand_i = torch.cat([best_i, rows[None, :].expand(hi - lo, -1)], 1)
            # stable sort: equal distances keep the lower row first
            order = torch.sort(cand_d, dim=1, stable=True).indices[:, :k]
            best_d = torch.gather(cand_d, 1, order)
            best_i = torch.gather(cand_i, 1, order)
        ids[lo:hi] = best_i.cpu().numpy()
        dists[lo:hi] = best_d.cpu().numpy()
    return ids, dists


def pair_dists(queries: np.ndarray, rows: np.ndarray, ids: np.ndarray, device) -> np.ndarray:
    """Exact squared distance of each query to each of its ids (rows of
    ``rows``), (B, k), in float64 from the float32 inputs; nan where an id is
    < 0."""
    dev = torch.device(device)
    table = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    out = np.full(ids.shape, np.nan, np.float64)
    ok = ids >= 0
    for lo in range(0, len(ids), QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, len(ids))
        q = torch.from_numpy(np.ascontiguousarray(queries[lo:hi])).to(dev, torch.float64)
        sel = torch.from_numpy(np.where(ok[lo:hi], ids[lo:hi], 0)).to(dev)
        x = table[sel].double()
        d = (x - q[:, None, :]).square().sum(-1).cpu().numpy()
        out[lo:hi] = np.where(ok[lo:hi], d, np.nan)
    return out
