"""The benchmark's tests: the harness and the reference on the CPU at tiny
sizes, and (marker `cuda`) a few on the card.

    python -m pytest benchmark/tests -q             # on the CPU
    python -m pytest benchmark/tests -q -m cuda     # on the card
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips elsewhere)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest benchmark/tests -q -m cuda`")
    return torch.device("cuda")


# tiny configurations of the real ones' kinds, for the CPU: the program's
# plain versions take seconds a request there
TINY = {
    "tiny_gray": ("gray8_8192_lossy97", dict(
        width=128, height=128, wavelet_levels=2, is_lossy=False,
        lut_folder=str(ROOT / "benchmark/configs/luts/trained_lossless"))),
    "tiny_lossy": ("gray8_8192_lossy97", dict(
        width=128, height=96, wavelet_levels=2,
        lut_folder=str(ROOT / "benchmark/configs/luts/trained_lossy"))),
    "tiny_rgb": ("rgb8_2048x2560_lossless53", dict(
        width=64, height=128, wavelet_levels=2,
        lut_folder=str(ROOT / "benchmark/configs/luts/trained_lossless"))),
}
TINY_CELLS = {"g.host": ("tiny_gray", "host"),
              "r.device": ("tiny_rgb", "device"),
              "l.device": ("tiny_lossy", "device"),
              "r.host": ("tiny_rgb", "host")}


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    """A benchmark file of tiny cells beside their own configurations and
    mixes: the real mixes with a pool of two low-contrast images and two
    requests kept."""
    d = tmp_path_factory.mktemp("tiny")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = []
    for name, (base, change) in TINY.items():
        cfg = json.loads((ROOT / f"benchmark/configs/{base}.json").read_text())
        cfg.update(change)
        (d / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "file": f"{name}.json"})
    (d / "benchmark" / "traffic").mkdir(parents=True)
    for mix in ("host", "device"):
        t = json.loads((ROOT / f"benchmark/traffic/{mix}.json").read_text())
        t.update(pool={"min_images": 2, "min_bytes": 0}, keep=2,
                 content=dict(t["content"], amplitude=8, noise=2))
        (d / "benchmark" / "traffic" / f"{mix}.json").write_text(
            json.dumps(t))
    bench["workloads"] = [
        {"name": c, "config": cfg, "traffic": mix, "chips": 1, "why": "test"}
        for c, (cfg, mix) in TINY_CELLS.items()]
    for m in bench["per_layer"]:
        m["workloads"] = list(TINY_CELLS)
    path = d / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path
