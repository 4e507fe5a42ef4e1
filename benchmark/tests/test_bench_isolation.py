"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), nor the JAX package's benchmark; the reference imports
nothing of the port either. A run in a tree without the program prints
no result, and one that finds JAX loaded after the window prints none."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import run as bench_run

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark"
FOREIGN = {"jax", "jaxlib", "flax", "picsong_tpu", "bench"}


def _imports(path: Path) -> set[str]:
    """The top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_foreign_imports():
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert files
    for path in files:
        assert not _imports(path) & FOREIGN, path
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        assert "picsong_tpu_torch" not in _imports(path), path
    # the program is reached through the harness's system, the entries
    # and the launch counters
    assert _imports(BENCH_DIR / "harness" / "system.py") >= {
        "picsong_tpu_torch"}
    for path in (BENCH_DIR / "counters").glob("*.py"):
        assert "picsong_tpu_torch" in _imports(path), path


def test_names_are_compared_whole():
    assert "picsong_tpu_torch".split(".")[0] not in FOREIGN
    assert "picsong_tpu.engine".split(".")[0] in FOREIGN


def test_loaded_jax_is_found(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert bench_run._foreign_modules() == ["jaxlib.xla_client"]
    monkeypatch.delitem(sys.modules, "jaxlib.xla_client")
    monkeypatch.setitem(sys.modules, "picsong_tpu_torch_x", object())
    assert bench_run._foreign_modules() == []


def test_no_result_without_the_program(tmp_path):
    """A tree of BENCHMARK.json and the benchmark's files alone: the run
    exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    workload = json.loads((ROOT / "BENCHMARK.json").read_text())[
        "workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "3", "--seconds", "1", "--trace", "0", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "picsong_tpu_torch" in proc.stderr
