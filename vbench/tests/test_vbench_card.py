"""The entry point: without a CUDA card it prints no result and exits
non-zero; on a card, a short run of a cell prints the contract's line."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def run_py(*args, timeout=1200):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(ROOT / "vbench" / "run.py"), *args],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=timeout)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = run_py("--workload", "p1-search-b128", "--seed", "1", "--seconds", "1", "--trace", "0",
               timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
def test_short_run_on_the_card(card):
    p = run_py("--workload", "p1-search-b128", "--seed", "5", "--seconds", "2", "--trace", "0")
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert {"qps", "query_p95_ms", "recall_at_10", "setup_s"} <= set(line["metrics"])
    assert "card:" in p.stderr
