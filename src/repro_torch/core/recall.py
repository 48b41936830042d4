"""Ground truth and Recall k@k (§2.1: "how many of the k results returned by a
search are the true top-k nearest neighbors"): the port of ``repro.core.recall``.

``ground_truth`` runs on the device of the tensors it is given, through the
``flat_l2`` and ``topk_select`` kernels on CUDA.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.flat_l2.ops import flat_l2
from ..kernels.topk_select.ops import topk_select


def ground_truth(queries, vectors, live, k: int, metric: str = "l2",
                 device=None) -> np.ndarray:
    """Exact top-k slot ids per query, (B, k). Inputs are numpy arrays or
    tensors; numpy inputs go to ``device`` (CUDA unless "cpu")."""
    dev = resolve_device(device) if not isinstance(queries, torch.Tensor) else queries.device
    q = torch.as_tensor(queries, dtype=torch.float32).to(dev).contiguous()
    v = torch.as_tensor(vectors, dtype=torch.float32).to(dev).contiguous()
    lv = torch.as_tensor(live).to(dev)
    d = flat_l2(q, v, metric)
    d = torch.where(lv[None, :], d, torch.full_like(d, float("inf")))
    _, idx = topk_select(d, k)
    return idx.cpu().numpy()


def recall_at_k(result_ids: np.ndarray, gt_ids: np.ndarray, k: int) -> float:
    """Average |result ∩ gt| / k over the query batch."""
    res = np.asarray(result_ids)[:, :k]
    gt = np.asarray(gt_ids)[:, :k]
    hits = 0
    for r, t in zip(res, gt):
        hits += len(set(int(x) for x in r if x >= 0) & set(int(x) for x in t))
    return hits / (len(res) * k)
