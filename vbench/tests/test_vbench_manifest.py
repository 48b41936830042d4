"""BENCHMARK.json against the benchmark's contract, and the harness finding
every configuration, traffic mix, system and metric by its name."""
import json
import re
from pathlib import Path

import pytest

from vbench import harness

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_sizes():
    assert set(MAN) == KEYS
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16 and 1 <= len(MAN["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
               and ".." not in p.split("/") for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert all(TEXT.match(w) for w in MAN["command"])
    script = MAN["command"][1]
    assert any(script.startswith(p + "/") for p in MAN["paths"]) and (ROOT / script).is_file()


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries_keys_and_names(section, keys):
    entries = MAN[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) <= keys, (e["name"], set(e) - keys)
        assert NAME.match(e["name"]), e["name"]
        for k in ("source", "why", "layer"):
            if k in e:
                assert TEXT.match(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES


def test_cells_and_configs():
    configs = {c["name"]: c for c in MAN["configs"]}
    used = set()
    pairs = set()
    for w in MAN["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(configs)
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    for c in MAN["configs"]:
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        # a reduced key is a cut of scale, stated in the file, never a width
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or k in ("dim", "M", "K", "R")
                       for k in c["reduced"])
        assert c["source"].startswith("https://")


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert 1 <= len(e2e) <= 16 and 1 <= len(MAN["per_layer"]) <= 128
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in MAN["workloads"]]
    reports = {c: {m for m, e in e2e.items() if c in e.get("workloads", cells)} for c in cells}
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells and m["moves"] in reports[c], (m["name"], c)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
        assert any(c in m.get("workloads", cells) for m in MAN["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = harness.find_cell(cell)
    assert (c.files / "systems" / f"{c.cfg['system']}.py").is_file()
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.load_module(c.files / "metrics" / f"{m['name']}.py").read)
    assert c.traffic["steps"] and c.cfg["limits"]["recall"] > 0
    for step in c.traffic["steps"]:
        assert callable(harness.load_module(c.files / "ops" / f"{step['op']}.py").run)


def test_every_file_under_paths_is_named_from_name_characters():
    for p in MAN["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
