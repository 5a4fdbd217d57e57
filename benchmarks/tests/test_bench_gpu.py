"""The harness on the card: a short run of each cell, end to end and
traced, correct and with every metric the cell reports.  Run on a machine
with an NVIDIA GPU: ``python -m pytest benchmarks/tests -m gpu``."""
import json
import os
import subprocess
import sys

import pytest
import torch
from conftest import BENCH

from statbench import cells

ROOT = os.path.dirname(BENCH)
CELLS = [w["name"] for w in cells.manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    c = cells.find(cell)
    if torch.cuda.device_count() < c["entry"]["chips"]:
        pytest.skip(f"needs {c['entry']['chips']} GPUs")
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", cell, "--seed",
         "2147483647", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    want = c["per_layer"] if trace else c["end_to_end"]
    assert set(res["metrics"]) == {m["name"] for m in want}
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
