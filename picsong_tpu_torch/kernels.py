"""Build and bind the port's CUDA kernels.

Every `.cu` file in `csrc/` is compiled by `nvcc` for sm_90a, one compiler
process per source, all started together, and the objects are linked into
one shared library with a plain C interface,
`build/picsong_tpu_torch/libpicsong_kernels.so` under the repository root,
at first use (or when a source is newer than the library), and loaded with
`ctypes`. The sources include no PyTorch header, so a build takes seconds.

There is no fallback: a missing compiler, a failed build or a failed load
raises `KernelBuildError` with the compiler's output. No source needs
`--fmad=false`: the 9/7 kernels round through explicit intrinsics.

This module is also the one way a kernel reaches the card. The wrappers
(`entropy/bpc_cuda.py`, `transform/dwt_cuda.py`, `assembly/pack.py`,
`tools/probe.py`, `tools/probe2.py`) find their inputs' device with
`device_type`, check a C entry point's preconditions with `check_tensor`
and `check_aligned`, and call it through `launch`, only for CUDA tensors.
The peak rates of the card the kernels are built for, which their
`bound_ms` models read, live here beside `NVCC_FLAGS`.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "picsong_tpu_torch")
LIB_NAME = "libpicsong_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# the H100 SXM's memory rate, its int32 rate outside the tensor cores (132
# SMs x 64 int32 lanes x 1.98 GHz) and its float32 rate outside them
BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FLOAT32_OPS_PER_S = 67e12

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> argument types; every C entry point returns a cudaError_t as int
_SIGNATURES = {
    # blocks, lut, lut_len, ref_b, sig_b, sign_b, cp_sig_b, cp_sign_b,
    # k_over_l2, n, n_planes, prec, stride, mode, streams, sizes, counts,
    # stream
    "picsong_bpc_encode": [_P, _P, _I, *[_P] * 6, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P],
    # streams, sizes, lut, lut_len, ref_b, sig_b, sign_b, cp_sig_b,
    # cp_sign_b, k_over_l2, n, n_planes, prec, stride, mode, coeffs,
    # counts, stream
    "picsong_bpc_decode": [_P, _P, _P, _I, *[_P] * 6, _I, _I, _I, _I, _I,
                           _P, _P, _P],
    # tape, base, out, stream
    "picsong_probe": [_P, _P, _P, _P],
    # tape, amt, out, stream
    "picsong_probe2": [_P, _P, _P, _P],
    # s0, s1, s2, type, vec, batch_stride, row_stride, batch, comps, h, w,
    # levels, lossy, offset, consts, scratch, blocks, top, stream
    "picsong_dwt_forward": [_P, _P, _P, _I, _I, _L, _L, *[_I] * 7, _P, _P,
                            _P, _P, _P],
    # b0, b1, b2, vec, batch, comps, h, w, levels, lossy, offset, lo, hi,
    # type, consts, scratch, out, stream
    "picsong_dwt_reverse": [_P, _P, _P, *[_I] * 11, _P, _P, _P, _P],
    # s0, s1, s2, type, vec, row_stride, comps, h, w, level, levels, lossy,
    # offset, in0, in1, r0, r1, consts, bands, top, stream
    "picsong_dwt_forward_shard": [_P, _P, _P, _I, _I, _L, *[_I] * 11, _P, _P,
                                  _P, _P],
    # ll, hl, lh, hh, vec, comps, h, w, level, levels, lossy, with_finish,
    # offset, lo, hi, type, consts, in0, in1, r0, r1, out, stream
    "picsong_dwt_reverse_shard": [*[_P] * 4, *[_I] * 12, _P, *[_I] * 4, _P,
                                  _P],
    # streams, sizes, n, header (host, or null), capacity, status, out,
    # stream
    "picsong_pack": [_P, _P, _I, _P, _L, _P, _P, _P],
    # code, n, payload, status, streams, sizes, stream
    "picsong_unpack": [_P, _I, _L, _P, _P, _P, _P],
}

_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be compiled or loaded."""


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    `nvcc` on PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built")
    return found


def sources(csrc_dir: str = CSRC_DIR) -> list[str]:
    return sorted(glob.glob(os.path.join(csrc_dir, "*.cu")))


def _start(cmd: list[str]) -> subprocess.Popen:
    try:
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise KernelBuildError(f"cannot run {cmd[0]}: {e}") from e


def _finish(cmd: list[str], proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return out


def build(nvcc: str | None = None, build_dir: str = BUILD_DIR,
          csrc_dir: str = CSRC_DIR) -> tuple[str, str]:
    """Compile csrc_dir/*.cu (the package's csrc/ unless another tree's is
    named, as an A/B timing does) into build_dir/libpicsong_kernels.so.

    Returns (library path, compiler output, which holds ptxas's register
    and shared-memory report)."""
    nvcc = nvcc or find_nvcc()
    os.makedirs(build_dir, exist_ok=True)
    lib = os.path.join(build_dir, LIB_NAME)
    tag = f"{os.getpid()}.tmp"
    jobs = []
    try:
        for src in sources(csrc_dir):
            obj = os.path.join(build_dir,
                               f"{os.path.basename(src)[:-3]}.{tag}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((obj, cmd, _start(cmd)))
        log = [_finish(cmd, proc) for _, cmd, proc in jobs]
        link = [nvcc, "-shared", "-o", f"{lib}.{tag}",
                *(obj for obj, _, _ in jobs)]
        log.append(_finish(link, _start(link)))
    finally:
        for obj, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(f"{lib}.{tag}", lib)
    return lib, "".join(log)


def _stale(lib: str) -> bool:
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    deps = sources() + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def library(nvcc: str | None = None, build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    lib_path = os.path.join(build_dir, LIB_NAME)
    if lib_path in _loaded:
        return _loaded[lib_path]
    if _stale(lib_path):
        build(nvcc, build_dir)
    return load(lib_path)


def load(lib_path: str) -> ctypes.CDLL:
    """Load a built kernel library and declare its entry points."""
    if lib_path in _loaded:
        return _loaded[lib_path]
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError as e:
        raise KernelBuildError(f"cannot load {lib_path}: {e}") from e
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.picsong_cuda_error_string.argtypes = [ctypes.c_int]
    lib.picsong_cuda_error_string.restype = ctypes.c_char_p
    _loaded[lib_path] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.picsong_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def device_type(tensors, what: str) -> str:
    """The one device type of `tensors`, "cpu" or "cuda"; raises ValueError
    when they are on several devices or on a device no kernel or plain
    version of `what` runs on."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what} inputs are on several devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} implementation for device {dev}")
    return dev.type


def check_tensor(t: torch.Tensor, name: str, shape: tuple,
                 dtype: torch.dtype = torch.int32) -> None:
    """A C entry point's precondition on an argument: its dtype and shape,
    and contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(t: torch.Tensor, name: str) -> None:
    """The BPC and pack kernels move codeblock rows as 8- and 16-byte
    vectors."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def launch(entry: str, device: torch.device, *args, what: str) -> None:
    """Call the C entry point `entry` of `library()` with `args` and then
    the raw handle of `device`'s current stream, under `device` only when
    it is not the current device (entering `torch.cuda.device` and building
    a Stream object cost 3.6 and 5.6 us of a 2048^2 pack's host time on an
    H100; kernel_ab --pack). Does not synchronise; raises through `check`
    on a CUDA error, naming `what`."""
    lib = library()
    fn = getattr(lib, entry)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    check(lib, rc, what)
