"""One partition: a ``repro_torch.core.DiskANNIndex`` on the device.

Built through ``insert`` from the seed's corpus (document i is row i), then,
where the configuration asks, the re-quantization completed with
``requantize_all`` as background maintenance would. Requests: ``search``
(one call answers a batch) and ``insert``.
"""
from __future__ import annotations

import time

import numpy as np
import torch


class System:
    def __init__(self, cfg: dict, corpus: np.ndarray, device, capacity_extra: int = 0):
        from repro_torch.core import DiskANNIndex, GraphConfig

        g = GraphConfig(
            capacity=len(corpus) + capacity_extra + 1024, R=cfg["R"],
            slack=cfg["R_slack"] / cfg["R"], L_build=cfg["L_build"],
            L_search=cfg["L_search"], alpha=cfg["alpha"], M=cfg["M"], metric=cfg["metric"],
            batch_size=cfg["insert_batch"], bootstrap_sample=cfg["bootstrap_sample"],
            refine_sample=cfg["refine_sample"], beam_width=cfg["beam_width"])
        if g.R_slack != cfg["R_slack"]:
            raise ValueError(f"R_slack {cfg['R_slack']} is not R x slack ({g.R_slack})")
        self.cfg = cfg
        self.index = DiskANNIndex(g, corpus.shape[1], seed=0, device=device)
        self.index.insert(list(range(len(corpus))), corpus)
        if cfg.get("requantize_at_setup"):
            self.index.requantize_all()
        self.spans = None

    # -- requests -------------------------------------------------------
    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray, dict]:
        L, kprime = self.cfg["L_search"], self.cfg["rerank"]
        ids, dists, st = self.index.search(queries, k=k, L=L, rerank_multiplier=kprime / k,
                                           beam_width=self.cfg["beam_width"])
        B = len(queries)
        return ids, dists, dict(queries=B, lanes=B, cmps=st.cmps * B, hops=st.hops * B,
                                full_reads=st.full_reads * B, L=max(L, kprime), k=k,
                                kprime=kprime, schemas=len(self.index.schemas))

    def insert(self, doc_ids: list, vectors: np.ndarray) -> None:
        t = time.perf_counter()
        self.index.insert(doc_ids, vectors)
        if self.spans is not None:
            if self.index.device.type == "cuda":
                torch.cuda.synchronize()
            self.spans.append(("insert", t, time.perf_counter(), {}))

    # -- tracing: spans from the harness's side of each call ---------------
    def instrument(self, spans: list) -> None:
        """Record a span around each ``insert`` (host clock, the card
        synchronised at its end) into ``spans``."""
        self.spans = spans

    # -- read-back after the window ---------------------------------------
    def read_back(self, doc_ids: np.ndarray, vectors: np.ndarray) -> dict:
        """Acknowledged documents that are not live, or whose stored vector
        differs from the one written."""
        idx = self.index
        slots = np.array([idx.doc_to_slot.get(int(d), -1) for d in doc_ids], np.int64)
        found = slots >= 0
        s = np.where(found, slots, 0)
        live = idx.pv.live[s] & found
        same = (idx.pv.vectors[s] == vectors).all(1) & found
        return dict(lost=int((~(live & same)).sum()))

    def close(self) -> None:
        self.index = None
