"""The port stands without JAX, and it has no hidden fallbacks: the kernel
loader raises instead of degrading, and the BPC dispatch refuses devices
it has no implementation for."""

import os
import subprocess
import sys

import pytest
import torch

from picsong_tpu.core.lut import LUTParams, neutral_lut
from picsong_tpu_torch import kernels
from picsong_tpu_torch.entropy import bpc_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "picsong_tpu_torch")


def test_no_jax_import_in_package():
    offenders = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            for line in open(path):
                s = line.strip()
                if s.startswith(("import jax", "from jax")):
                    offenders.append(f"{path}: {s}")
    assert offenders == []


_NO_JAX_ROUND_TRIP = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import numpy as np
from picsong_tpu.core.image_io import read_pgm, write_pgm
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
                if (m == "jax" or m.startswith("jax.")) and sys.modules[m])
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
    params = LUTParams()
    lut = torch.tensor(neutral_lut(params, 1, 2), device=device)
    z = torch.zeros(2, dtype=torch.int32, device=device)
    return params, lut, z


def test_bpc_dispatch_refuses_other_devices():
    params, lut, z = _meta_inputs("meta")
    blocks = torch.zeros((2, 64, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no BPC-PaCo implementation"):
        bpc_cuda.encode_blocks(blocks, lut, z, z, z, params=params,
                               n_planes=4)
    streams = torch.zeros((2, 4096), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no BPC-PaCo implementation"):
        bpc_cuda.decode_blocks(streams, z, lut, z, z, z, params=params,
                               n_planes=4)


def test_bpc_dispatch_refuses_mixed_devices():
    params, lut, z = _meta_inputs("cpu")
    blocks = torch.zeros((2, 64, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        bpc_cuda.encode_blocks(blocks, lut, z, z, z, params=params,
                               n_planes=4)


def test_bpc_dispatch_cpu_takes_plain_version_without_counting():
    params, lut, z = _meta_inputs("cpu")
    before = (bpc_cuda.ENCODE_LAUNCHES, bpc_cuda.DECODE_LAUNCHES)
    blocks = torch.zeros((2, 64, 64), dtype=torch.int32)
    blocks[1, 3, 5] = -9
    streams, sizes = bpc_cuda.encode_blocks(blocks, lut, z, z, z,
                                            params=params, n_planes=4)
    out = bpc_cuda.decode_blocks(streams, sizes, lut, z, z, z, params=params,
                                 n_planes=4)
    assert torch.equal(out, blocks)
    assert (bpc_cuda.ENCODE_LAUNCHES, bpc_cuda.DECODE_LAUNCHES) == before
