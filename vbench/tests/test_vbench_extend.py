"""A new configuration, traffic mix, op and per-layer metric are added as
files and manifest entries alone: the harness runs the new cell, drives
the new op and judges it by its own checks, and reads the new metric,
without a change to any file it has."""
import json
import shutil
from pathlib import Path

from vbench import harness

ROOT = Path(__file__).resolve().parents[2]

# an op of its own: single-query searches, each checked to return the
# nearest document first, with its own check beside the common ones
ONE_BY_ONE = '''
import numpy as np
from vbench import reference
from vbench.load import Request, now

KNN = True


def run(gen, step, out, until):
    for _ in range(int(step["queries"])):
        rows = gen.rows(1)
        t0 = now()
        ids, dists, work = gen.sut.search(gen.inp.queries[rows], gen.k)
        out.append(Request("one_by_one", t0, now(), rows, gen.n_docs, np.asarray(ids),
                           np.asarray(dists), work=work))


def checks(requests, ctx, read):
    rows = np.concatenate([r.pool for r in requests])
    first = np.concatenate([r.ids[:, 0] for r in requests])
    best, _ = reference.exact_topk(ctx.inputs.queries[rows], ctx.inputs.corpus, 1, ctx.device)
    return {"nearest_first": (float((first == best[:, 0]).mean()), ">=", 0.5)}
'''


def test_a_cell_added_as_files(tmp_path, tiny, few_threads):
    bench = tmp_path / "vbench"
    for d in ("configs", "traffic", "ops", "metrics", "systems"):
        shutil.copytree(ROOT / "vbench" / d, bench / d)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = dict(json.loads((bench / "configs" / "cohere768-p1.json").read_text()), **tiny)
    cfg["name"] = "tiny-p1"
    cfg["k"] = 5
    (bench / "configs" / "tiny-p1.json").write_text(json.dumps(cfg))
    (bench / "ops" / "one_by_one.py").write_text(ONE_BY_ONE)
    (bench / "traffic" / "one-by-one.json").write_text(json.dumps(
        {"steps": [{"op": "one_by_one", "queries": 8}], "query_pool": 256,
         "warmup_rounds": 1, "trace_rounds": 2}))
    (bench / "metrics" / "index.hops_per_query.py").write_text(
        "def read(run):\n"
        "    w = [r.work for r in run.requests if r.work]\n"
        "    return sum(x['hops'] for x in w) / sum(x['queries'] for x in w)\n")
    man["configs"].append({"name": "tiny-p1", "source": "https://example.org/tiny",
                           "file": "vbench/configs/tiny-p1.json", "reduced": [], "why": "test"})
    man["workloads"].append({"name": "tiny.one", "config": "tiny-p1", "traffic": "one-by-one",
                             "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "index.hops_per_query", "unit": "hops/query",
                             "better": "lower", "source": "program_counter",
                             "layer": "index and planner", "moves": "qps",
                             "workloads": ["tiny.one"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    r = harness.run_cell("tiny.one", 11, 2.0, True, device="cpu", root=tmp_path)
    assert r["correct"], r["checks"]
    assert r["checks"]["nearest_first"]["holds"] and "recall" in r["checks"]
    assert r["metrics"]["index.hops_per_query"]["value"] > 0
    r = harness.run_cell("tiny.one", 11, 0.3, False, device="cpu", root=tmp_path)
    assert set(r["metrics"]) == {"qps", "query_p95_ms", "recall_at_10", "setup_s"}
