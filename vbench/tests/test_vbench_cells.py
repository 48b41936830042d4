"""Whole runs of each cell on the CPU at tiny widths (the port's plain
PyTorch path): a sound run is correct, and the control, the reference in
TF32 put in the program's place, is not."""
import json
from pathlib import Path

import pytest

from vbench import harness

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2 ** 31 + 977  # seeds run past 32 bits


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny, few_threads):
    r = harness.run_cell(cell, SEED, 0.5, False, device="cpu", cfg_overrides=tiny)
    assert r["correct"], r["checks"]
    names = {m["name"] for m in harness.find_cell(cell).end_to_end}
    assert set(r["metrics"]) == names
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tiny, few_threads):
    r = harness.run_cell(cell, SEED + 1, 0.3, False, device="cpu", cfg_overrides=tiny,
                         system="control")
    assert not r["correct"]
    assert not r["checks"]["dist_gap"]["holds"], r["checks"]


def test_same_seed_same_inputs():
    from vbench import data

    a = data.Inputs(SEED, 50, 16, 8, 4, "cpu")
    b = data.Inputs(SEED, 50, 16, 8, 4, "cpu")
    c = data.Inputs(SEED + 1, 50, 16, 8, 4, "cpu")
    assert (a.corpus == b.corpus).all() and (a.queries == b.queries).all()
    assert (a.extra == b.extra).all() and not (a.corpus == c.corpus).all()
