"""A served collection: ``repro_torch.serve.VectorCollectionService`` of
hash-range physical partitions on the device.

Built through the service's own ``upsert`` (the engine's ingest queue):
document i is ``{"id": i, "cat": i % 10, "tier": i % 3}`` under the
partition key ``pk{i % partition_keys}``. Requests: ``serve``, closed-loop
clients of the service's engine (``VectorServeEngine.submit_query`` and
``drain``, the path ``VectorCollectionService.query`` takes), whose queued
queries form micro-batches of up to ``max_batch``.
"""
from __future__ import annotations

import time

import numpy as np
import torch


class System:
    def __init__(self, cfg: dict, corpus: np.ndarray, device, capacity_extra: int = 0):
        from repro_torch.core import GraphConfig
        from repro_torch.serve import EngineConfig, VectorCollectionService

        per = cfg["max_vectors_per_partition"]
        g = GraphConfig(
            capacity=per + 1024, R=cfg["R"], slack=cfg["R_slack"] / cfg["R"],
            L_build=cfg["L_build"], L_search=cfg["L_search"], alpha=cfg["alpha"], M=cfg["M"],
            metric=cfg["metric"], batch_size=cfg["insert_batch"],
            bootstrap_sample=cfg["bootstrap_sample"], refine_sample=cfg["refine_sample"],
            beam_width=cfg["beam_width"])
        if g.R_slack != cfg["R_slack"]:
            raise ValueError(f"R_slack {cfg['R_slack']} is not R x slack ({g.R_slack})")
        eng = EngineConfig(max_batch=cfg["max_batch"], dispatch_mode=cfg["dispatch_mode"],
                           beam_width=cfg["beam_width"],
                           search_list_multiplier=cfg["search_list_multiplier"],
                           tenant_ru_s=cfg["tenant_ru_s"], ingest_chunk=cfg["ingest_chunk"])
        self.cfg = cfg
        self.svc = VectorCollectionService(
            dim=corpus.shape[1], graph=g, max_vectors_per_partition=per,
            initial_partitions=cfg["partitions"], replicas=cfg["replicas"], engine_cfg=eng,
            device=device)
        self.device = torch.device(device)
        keys = cfg["partition_keys"]
        n = len(corpus)
        self.svc.upsert([self.doc(i) for i in range(n)], corpus,
                        partition_keys=[f"pk{i % keys}" for i in range(n)])
        if self.svc.collection.num_docs != n or len(self.svc.collection.partitions) != cfg["partitions"]:
            raise RuntimeError("the build lost documents or split a partition")
        self._unwrap = None

    @staticmethod
    def doc(i: int) -> dict:
        return {"id": i, "cat": i % 10, "tier": i % 3}

    # -- requests -------------------------------------------------------
    def serve(self, next_query, clients: int, k: int, until: float | None) -> list:
        """``clients`` closed-loop clients: each submits a query
        (``next_query()`` gives its tag and vector) and, while the host clock
        is before ``until``, its next one as soon as the micro-batch that
        answered it is done, so micro-batches form from the live queue.
        Returns each query's (tag, sent, answered, status, ids, dists), the
        answer's time taken as its micro-batch completes."""
        eng = self.svc.engine
        live, done = {}, []

        def finish(rid: int, t1: float) -> None:
            r = eng.pop_response(rid)
            tag, t0 = live.pop(rid)
            done.append((tag, t0, t1, 0, None, None) if r is None else
                        (tag, t0, t1, r.status, r.ids, r.dists))

        def submit() -> None:
            tag, q = next_query()
            t0 = time.perf_counter()
            rid = eng.submit_query(q, k=k)
            live[rid] = (tag, t0)
            if rid in eng.responses:  # refused at admission: that client stops
                finish(rid, time.perf_counter())

        inner = eng._dispatch

        def dispatch(key, batch) -> None:
            inner(key, batch)
            t1 = time.perf_counter()
            for r in batch:
                finish(r.rid, t1)
                if until is not None and t1 < until:
                    submit()

        eng._dispatch = dispatch  # the engine's call per micro-batch, on this instance
        try:
            for _ in range(clients):
                submit()
            eng.drain()
        finally:
            del eng._dispatch
        for rid in list(live):  # queued but never answered
            finish(rid, time.perf_counter())
        return done

    # -- tracing: spans from the harness's side of each call ---------------
    def instrument(self, spans: list) -> None:
        """Record a span around each ``SpmdFanout.search`` (host clock, the
        card synchronised at its end) into ``spans``, with the beam search's
        counters summed over the call's partitions."""
        from repro_torch.partition.fanout import SpmdFanout

        inner = SpmdFanout.search
        dev = self.device

        def search(fan, partitions, queries, k, **kw):
            t = time.perf_counter()
            ids, dists, info = inner(fan, partitions, queries, k, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            B = len(queries)
            st = info["stats_per_partition"]
            kprime = max(k, int(round(kw["rerank_multiplier"] * k)))
            spans.append(("fanout", t, time.perf_counter(), dict(
                queries=B, lanes=B * len(st), cmps=sum(s.cmps for s in st) * B,
                hops=sum(s.hops for s in st) * B, full_reads=sum(s.full_reads for s in st) * B,
                L=max(kw["L"], kprime), k=k, kprime=kprime,
                schemas=max(len(p.index.schemas) for p in partitions))))
            return ids, dists, info

        SpmdFanout.search = search
        self._unwrap = lambda: setattr(SpmdFanout, "search", inner)

    def close(self) -> None:
        if self._unwrap is not None:
            self._unwrap()
            self._unwrap = None
        self.svc = None
