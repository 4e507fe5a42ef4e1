"""The port stands without JAX and without the JAX package, and it has no
hidden fallbacks: the kernel loader raises instead of degrading, and the
BPC dispatch refuses devices it has no implementation for."""

import os
import re
import subprocess
import sys

import pytest
import torch

from picsong_tpu_torch import kernels
from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
from picsong_tpu_torch.entropy import bpc_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "picsong_tpu_torch")


# `import jax...` / `from jax...`, and `import picsong_tpu...` / `from
# picsong_tpu...` other than the port's own package
_FOREIGN = re.compile(r"^\s*(from|import)\s+(jax|picsong_tpu)([.\s,]|$)")


def test_no_jax_import_in_package():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, n) for n in files if n.endswith(".py")]
    offenders = [f"{path}: {line.strip()}" for path in paths
                 for line in open(path) if _FOREIGN.match(line)]
    assert offenders == []
    assert _FOREIGN.match("from picsong_tpu.core import spec")
    assert _FOREIGN.match("import picsong_tpu")
    assert not _FOREIGN.match("from picsong_tpu_torch.core import spec")


_NO_JAX_ROUND_TRIP = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["picsong_tpu"] = None  # and so does the JAX package
import numpy as np
from picsong_tpu_torch.core.image_io import read_pgm, write_pgm
from picsong_tpu_torch.engine import cli
d = sys.argv[1]
y, x = np.mgrid[0:64, 0:64]
img = np.clip(100 + 50 * np.sin(x / 5.0) + 7 * np.cos(y / 3.0), 0,
              255).astype(np.uint8)
write_pgm(d + "/in.pgm", img)
assert cli.main(["-cd", "0", "-i", d + "/in.pgm", "-o", d + "/o.enc",
                 "-wl", "2", "--device", "cpu"]) == 0
assert cli.main(["-cd", "1", "-i", d + "/o.enc", "-o", d + "/d.pgm",
                 "--device", "cpu"]) == 0
assert np.array_equal(read_pgm(d + "/d.pgm"), img)
assert cli.main(["-cd", "0", "-i", d + "/in.pgm", "-o", d + "/l.enc",
                 "-wl", "2", "-type", "1", "--device", "cpu"]) == 0
assert cli.main(["-cd", "1", "-i", d + "/l.enc", "-o", d + "/l.pgm",
                 "--device", "cpu"]) == 0
err = read_pgm(d + "/l.pgm").astype(float) - img
assert 10 * np.log10(255.0 ** 2 / np.mean(err * err)) > 35.0
with open(d + "/rgb.raw", "wb") as f:
    for c in range(3):
        f.write(np.roll(img, 7 * c, axis=1).tobytes())
assert cli.main(["-cd", "0", "-i", d + "/rgb.raw", "-o", d + "/r.enc",
                 "-xSize", "64", "-ySize", "64", "-isRGB", "1", "-wl", "1",
                 "--device", "cpu"]) == 0
assert cli.main(["-cd", "1", "-i", d + "/r.enc", "-o", d + "/r.raw",
                 "--device", "cpu"]) == 0
assert open(d + "/r.raw", "rb").read() == open(d + "/rgb.raw", "rb").read()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "picsong_tpu") and sys.modules[m])
assert loaded == [], loaded
print("NO-JAX-OK")
"""


def test_cli_round_trip_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_ROUND_TRIP,
                           str(tmp_path)], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO-JAX-OK" in proc.stdout


def test_kernel_loader_raises_without_nvcc(tmp_path):
    missing = str(tmp_path / "no-such-nvcc")
    with pytest.raises(kernels.KernelBuildError, match="no-such-nvcc"):
        kernels.build(nvcc=missing, build_dir=str(tmp_path / "build"))
    with pytest.raises(kernels.KernelBuildError):
        kernels.library(nvcc=missing, build_dir=str(tmp_path / "build"))
    assert not os.path.exists(tmp_path / "build" / kernels.LIB_NAME)


def test_kernel_loader_reports_compiler_output(tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: sm_90a refused' >&2\nexit 3\n")
    fake.chmod(0o755)
    with pytest.raises(kernels.KernelBuildError, match="sm_90a refused"):
        kernels.build(nvcc=str(fake), build_dir=str(tmp_path / "build"))


def test_find_nvcc_raises_when_absent(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
        kernels.find_nvcc()


def _meta_inputs(device):
    """Params, a LUT and the six per-block arrays (all zero) of two blocks,
    plus the mode keywords of cp=2 k=0."""
    params = LUTParams()
    lut = torch.tensor(neutral_lut(params, 1, 2), device=device)
    z = torch.zeros(2, dtype=torch.int32, device=device)
    meta = (z, z, z, z, z, torch.zeros(2, device=device))
    kw = dict(params=params, wavelet_levels=1, coding_passes=2, has_k=False,
              n_planes=4)
    return lut, meta, kw


def test_bpc_dispatch_refuses_other_devices():
    lut, meta, kw = _meta_inputs("meta")
    blocks = torch.zeros((2, 64, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no BPC-PaCo implementation"):
        bpc_cuda.encode_blocks(blocks, lut, *meta, **kw)
    streams = torch.zeros((2, 4096), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no BPC-PaCo implementation"):
        bpc_cuda.decode_blocks(streams, meta[0], lut, *meta, **kw)


def test_bpc_dispatch_refuses_mixed_devices():
    lut, meta, kw = _meta_inputs("cpu")
    blocks = torch.zeros((2, 64, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        bpc_cuda.encode_blocks(blocks, lut, *meta, **kw)


def test_bpc_dispatch_cpu_takes_plain_version_without_counting():
    lut, meta, kw = _meta_inputs("cpu")
    before = (dict(bpc_cuda.ENCODE_LAUNCHES), dict(bpc_cuda.DECODE_LAUNCHES))
    blocks = torch.zeros((2, 64, 64), dtype=torch.int32)
    blocks[1, 3, 5] = -9
    streams, sizes = bpc_cuda.encode_blocks(blocks, lut, *meta, **kw)
    out = bpc_cuda.decode_blocks(streams, sizes, lut, *meta, **kw)
    assert torch.equal(out, blocks)
    assert (bpc_cuda.ENCODE_LAUNCHES, bpc_cuda.DECODE_LAUNCHES) == before
