"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have (half of a batch left out, an answer
altered where it is produced, the partitions' exchange left out, a write
that leaves the state unchanged), and for a fault in the beam search's ADC
that only recall sees (``vbench/faults.py``)."""
import numpy as np
import pytest

from vbench import harness

SEED = 4_000_000_007


def half(ids, dists):
    """The first half of a batch's answers, given again for the second half."""
    h = max(len(ids) // 2, 1)
    take = np.arange(len(ids)) % h
    return ids[take], dists[take]


def altered(ids, dists):
    """Each row's first id moved to the next document, its distance kept."""
    ids = ids.copy()
    ids[:, 0] = np.where(ids[:, 0] > 0, ids[:, 0] - 1, ids[:, 0] + 1)
    return ids, dists


def break_index(monkeypatch, fault):
    from repro_torch.core import DiskANNIndex

    inner = DiskANNIndex.search

    def search(self, queries, k, **kw):
        ids, dists, st = inner(self, queries, k, **kw)
        return (*fault(ids, dists), st)

    monkeypatch.setattr(DiskANNIndex, "search", search)


def break_fanout(monkeypatch, fault):
    from repro_torch.partition.fanout import SpmdFanout

    inner = SpmdFanout.search

    def search(self, partitions, queries, k, **kw):
        ids, dists, info = inner(self, partitions, queries, k, **kw)
        return (*fault(ids, dists), info)

    monkeypatch.setattr(SpmdFanout, "search", search)


@pytest.mark.parametrize("cell,fault", [
    ("p1-search-b128", "half"), ("p1-search-b128", "altered"),
    ("p1-upsert-mix", "half"), ("p1-upsert-mix", "altered"),
    ("p4-serve-c64", "half"), ("p4-serve-c64", "altered"),
])
def test_a_broken_answer(cell, fault, monkeypatch, tiny, few_threads):
    brk = break_fanout if cell.startswith("p4") else break_index
    brk(monkeypatch, {"half": half, "altered": altered}[fault])
    r = harness.run_cell(cell, SEED, 0.5, False, device="cpu", cfg_overrides=tiny)
    assert not r["correct"]
    failed = {k for k, c in r["checks"].items() if not c["holds"]}
    assert failed & ({"recall", "dist_gap"} if fault == "half" else {"dist_gap"}), r["checks"]


def test_the_partitions_exchange_left_out(monkeypatch, tiny, few_threads):
    from repro_torch.partition.fanout import SpmdFanout

    inner = SpmdFanout.search

    def one_partition(self, partitions, queries, k, **kw):
        return inner(self, list(partitions)[:1], queries, k, **kw)

    monkeypatch.setattr(SpmdFanout, "search", one_partition)
    r = harness.run_cell("p4-serve-c64", SEED, 0.5, False, device="cpu", cfg_overrides=tiny)
    assert not r["correct"] and not r["checks"]["recall"]["holds"]


def test_a_write_that_leaves_the_state_unchanged(monkeypatch, tiny, few_threads):
    from repro_torch.core import DiskANNIndex, QueryStats

    inner = DiskANNIndex.insert

    def insert(self, doc_ids, vectors):
        if len(doc_ids) > self.cfg.batch_size:  # the build's one call goes through
            return inner(self, doc_ids, vectors)
        return QueryStats(plan="insert")

    monkeypatch.setattr(DiskANNIndex, "insert", insert)
    r = harness.run_cell("p1-upsert-mix", SEED, 0.5, False, device="cpu", cfg_overrides=tiny)
    assert not r["correct"] and not r["checks"]["lost_writes"]["holds"]


@pytest.mark.parametrize("cell", ["p1-search-b128", "p4-serve-c64"])
def test_a_fault_in_the_adc_fails_recall(cell, tiny, few_threads):
    from vbench import faults

    undo = faults.planted("adc_shift")
    try:
        r = harness.run_cell(cell, SEED, 0.5, False, device="cpu", cfg_overrides=tiny)
    finally:
        undo()
    assert not r["correct"]
    assert not r["checks"]["recall"]["holds"] and r["checks"]["dist_gap"]["holds"], r["checks"]
