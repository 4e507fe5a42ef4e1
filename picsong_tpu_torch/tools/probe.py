"""The window-refill probe on the card: `csrc/probe.cu` and its plain
version.

Counterpart of tools/pallas_probe.py, which probes the Mosaic primitives
the Pallas BPC coder uses. With the probe's own inputs (numpy
`default_rng(0)`: tape (128, 512) in [0, 200), base (128,) in [0, 448)) it
prints the build + first-run time, the steady time per call over 50
synchronised calls and out[0, :4]:

    python -m picsong_tpu_torch.tools.probe [--device cuda|cpu]

`run` checks the inputs, then takes the kernel for CUDA tensors and the
plain version for CPU tensors; `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import kernels
from ..entropy.bpc_cuda import BYTES_PER_S, INT32_OPS_PER_S
from ..transform.dwt_cuda import _on

C = 128        # codeblock chunk
CAP = 512      # tape row length
ROWS = 32
STEPS = 64
# int32 operations of one output cell: v >> 1, v > 100 and their sum, the
# shift that is the STEPS accumulation adds (64 wrapping adds of a step
# are step << 6 mod 2^32), the fetched word's add; and of one column: the
# window floor, the rank, the gather's index and row 0's doubling
OPS_PER_CELL = 3 + 1 + 1
OPS_PER_COLUMN = 4

LAUNCHES = 0


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around, as JAX's int32."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def plain(tape: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """What the Pallas kernel computes, as torch ops: (32, 128) int32."""
    v = tape[:ROWS, :C].long()
    acc = wrap32(STEPS * ((v >> 1) + (v > 100).long())).long()
    b = torch.div(base.long(), 128, rounding_mode="floor") * 128
    rank = torch.remainder(acc[0], 128)
    fetched = torch.gather(tape.long(), 1, (b + rank)[:, None])[:, 0]
    out = acc + fetched[None, :]
    row0 = torch.where(base[0] > 0, 2, 1).to(out.device)
    out = torch.cat([out[:1] * row0, out[1:]])
    return wrap32(out)


def words_moved(tape: torch.Tensor, base: torch.Tensor) -> int:
    """The int32 words the function must read or write on these inputs:
    tape[0:32, 0:128], each column's gathered word where it lies outside
    that block, base, and the (32, 128) output. Column n's gathered word
    lies inside the block iff n < 32 and base[n] < 128 (its window starts
    at 0)."""
    inside = int((base[:ROWS] < C).sum())
    return ROWS * C + (C - inside) + C + ROWS * C


def bound_ms(tape: torch.Tensor, base: torch.Tensor) -> tuple[float, str]:
    """The least time an H100 could take for the probe on these inputs,
    and what bounds it: the larger of `words_moved` over the memory rate
    and the int32 operations over the int32 rate."""
    bytes_s = words_moved(tape, base) * 4 / BYTES_PER_S
    ops_s = (ROWS * C * OPS_PER_CELL + C * OPS_PER_COLUMN) / INT32_OPS_PER_S
    return (max(bytes_s, ops_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def check_inputs(tape: torch.Tensor, base: torch.Tensor) -> None:
    """The kernel's domain; outside it the Mosaic kernel reads out of
    bounds, so the wrapper refuses instead of guessing."""
    for t, name, shape in ((tape, "tape", (C, CAP)), (base, "base", (C,))):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor, "
                             f"got {tuple(t.shape)}")
    if tape.device != base.device:
        raise ValueError("tape and base are on different devices")
    if bool(((base < 0) | (base >= CAP)).any()):
        raise ValueError(f"base must lie in [0, {CAP})")


def run(tape: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """The probe: CUDA tensors launch the kernel, CPU tensors take the
    plain version, anything else raises."""
    check_inputs(tape, base)
    if tape.device.type == "cpu":
        return plain(tape, base)
    if tape.device.type != "cuda":
        raise ValueError(f"no probe implementation for device {tape.device}")
    return launch(tape, base)


def launch(tape: torch.Tensor, base: torch.Tensor, lib=None) -> torch.Tensor:
    """The kernel launch alone, for CUDA tensors that `check_inputs`
    accepted (its domain check reads the device, so a timing loop keeps it
    out), on the tensors' device and its current stream. Does not
    synchronise. The kernel moves 16-byte vectors where tape and base are
    16-byte aligned, else words. `lib` is the kernel library to launch
    (default: the package's own)."""
    global LAUNCHES
    lib = lib or kernels.library()
    out = torch.empty((ROWS, C), dtype=torch.int32, device=tape.device)
    ctx, stream = _on(tape.device)
    with ctx:
        rc = lib.picsong_probe(tape.data_ptr(), base.data_ptr(),
                               out.data_ptr(), stream)
    LAUNCHES += 1
    kernels.check(lib, rc, "probe launch")
    return out


def inputs(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The inputs of tools/pallas_probe.py."""
    rng = np.random.default_rng(seed)
    tape = rng.integers(0, 200, size=(C, CAP)).astype(np.int32)
    base = rng.integers(0, CAP - 64, size=(C,)).astype(np.int32)
    return tape, base


def edge_inputs() -> tuple[np.ndarray, np.ndarray]:
    """Inputs at the kernel's edges: negative tape values, INT_MAX and
    INT_MIN rows whose accumulations wrap, a row just above the v > 100
    threshold, and base 511, 0 and 384 (base[0] > 0: row 0 doubled)."""
    i32 = np.iinfo(np.int32)
    rng = np.random.default_rng(7)
    tape = rng.integers(i32.min, i32.max, size=(C, CAP),
                        dtype=np.int64).astype(np.int32)
    tape[:ROWS:4] = i32.max
    tape[1:ROWS:4] = i32.min
    tape[2:ROWS:4] = rng.integers(-300, 0, size=(ROWS // 4, CAP))
    tape[3:ROWS:4] = 101
    base = rng.integers(0, CAP, size=C).astype(np.int32)
    base[:3] = [CAP - 1, 0, 384]
    return tape, base


def time_entry_point(run_fn, args: tuple[np.ndarray, ...],
                     argv: list[str] | None, calls: int) -> int:
    """The probes' command line: --device (default cuda) and --calls; runs
    `run_fn` once (build + first run), then `calls` times, synchronised,
    and prints both times and out[0, :4]."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--calls", type=int, default=calls)
    opts = ap.parse_args(argv)
    device = torch.device(opts.device)
    tensors = [torch.from_numpy(a).to(device) for a in args]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    out = run_fn(*tensors)
    sync()
    print(f"build+first run: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    for _ in range(opts.calls):
        out = run_fn(*tensors)
    sync()
    print(f"steady: {(time.perf_counter() - t0) / opts.calls * 1e3:.3f} "
          "ms/call", flush=True)
    print("out[0,:4] =", out[0, :4].cpu().numpy())
    return 0


def main(argv: list[str] | None = None) -> int:
    return time_entry_point(run, inputs(), argv, calls=50)


if __name__ == "__main__":
    raise SystemExit(main())
