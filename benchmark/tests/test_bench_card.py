"""On the card (marker `cuda`): every cell at its own size, a short traced
run whose outputs are correct and whose per-layer metrics are all there,
each roofline share under 100%; and the control in the program's place,
whose outputs are not correct.

    python -m pytest benchmark/tests/test_bench_card.py -q -m cuda
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]

pytestmark = pytest.mark.cuda


def _run(workload, seed, *extra):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", "2", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_traced(cuda, workload):
    result = _run(workload, 2 ** 31 + 11, "--trace", "1")
    assert result["correct"] is True
    want = {m["name"] for m in BENCH["per_layer"]
            if workload in m.get("workloads", CELLS)}
    assert set(result["metrics"]) == want
    for name, metric in result["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < metric["value"] <= 100, name
    device = result["device"]
    assert device["platform"] == "gpu" and 0 < device["busy_s"]
    assert device["busy_s"] <= device["window_s"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(cuda, workload):
    result = _run(workload, 2 ** 31 + 12, "--trace", "0", "--system",
                  "control")
    assert result["correct"] is False
    assert result["checks"]["codestream_diff_shorts"]["value"] > 0
