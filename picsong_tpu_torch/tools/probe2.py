"""The rotate/transpose probe on the card: `csrc/probe2.cu` and its plain
version.

Counterpart of tools/pallas_probe2.py, which probes the Mosaic data
movements the Pallas BPC decoder uses. With the probe's own inputs (numpy
`default_rng(0)`: tape (512, 8, 128) in [0, 2^20), amt (128,) in
[0, 3968)) it prints the build + first-run time, the steady time per call
over 100 synchronised calls and out[0, :4]:

    python -m picsong_tpu_torch.tools.probe2 [--device cuda|cpu]

The output is what the Pallas kernel computes in interpret mode, where
`pltpu.roll` follows jnp.roll (out[i] = x[(i - shift) mod n]); the host
check at the end of tools/pallas_probe2.py rolls the other way and does
not describe the kernel.

`run` checks the inputs, then takes the kernel for CUDA tensors and the
plain version for CPU tensors; `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .probe import time_entry_point, wrap32

C = 128           # codeblock chunk
SUBLANES = 8
LANES = 128
SLABS = 4 * C     # four (8, 128) slabs per column
ROWS = 32
AMT_END = SLABS // C * SUBLANES * LANES
# int32 operations of one output cell (|x|, mod 8, the fetch's index, the
# add) and of one column (q, s, l and the slab row's address)
OPS_PER_CELL = 4
OPS_PER_COLUMN = 4

LAUNCHES = 0


def plain(tape: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """What the Pallas kernel computes, as torch ops: (32, 128) int32."""
    a = amt.long()
    q = torch.div(a, 1024, rounding_mode="floor")
    s = torch.div(torch.remainder(a, 1024), 128, rounding_mode="floor")
    lane_shift = torch.remainder(a, 128)
    n = torch.arange(C, device=tape.device)
    rows = tape[4 * n + q, torch.remainder(-s, SUBLANES)].long()   # (C, 128)
    j = torch.arange(LANES, device=tape.device)
    stage = torch.gather(rows, 1, torch.remainder(
        j[None, :] - lane_shift[:, None], LANES))                   # (C, 128)
    t = stage.T                                                     # (128, C)
    rank = torch.remainder(t[:ROWS].abs(), SUBLANES)
    fetched = torch.gather(t[:SUBLANES], 0, rank)                   # (32, C)
    return wrap32(fetched + t[:ROWS])


def words_moved(tape: torch.Tensor, amt: torch.Tensor) -> int:
    """The int32 words the function must read or write: only stage[n][0:32]
    reaches the output (rank < 8 indexes inside it), so it reads 32 tape
    words a column and amt, and writes the (32, 128) output."""
    return C * ROWS + C + ROWS * C


def bound_ms(tape: torch.Tensor, amt: torch.Tensor) -> tuple[float, str]:
    """The least time an H100 could take for the probe, and what bounds
    it: the larger of `words_moved` over the memory rate and the int32
    operations over the int32 rate."""
    bytes_s = words_moved(tape, amt) * 4 / kernels.BYTES_PER_S
    ops_s = ((ROWS * C * OPS_PER_CELL + C * OPS_PER_COLUMN)
             / kernels.INT32_OPS_PER_S)
    return (max(bytes_s, ops_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def check_inputs(tape: torch.Tensor, amt: torch.Tensor) -> None:
    """The kernel's domain; for amt < 0 the Mosaic kernel leaves a stage
    row unwritten, and from 4096 on it reads past the column's slabs, so
    the wrapper refuses instead of guessing."""
    for t, name, shape in ((tape, "tape", (SLABS, SUBLANES, LANES)),
                           (amt, "amt", (C,))):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor, "
                             f"got {tuple(t.shape)}")
    if bool(((amt < 0) | (amt >= AMT_END)).any()):
        raise ValueError(f"amt must lie in [0, {AMT_END})")


def run(tape: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """The probe: CUDA tensors launch the kernel, CPU tensors take the
    plain version, anything else raises."""
    device = kernels.device_type([tape, amt], "probe")
    check_inputs(tape, amt)
    if device == "cpu":
        return plain(tape, amt)
    return launch(tape, amt)


def launch(tape: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """The kernel launch alone, for CUDA tensors that `check_inputs`
    accepted (its domain check reads the device, so a timing loop keeps it
    out), on the tensors' device and its current stream. Does not
    synchronise."""
    global LAUNCHES
    out = torch.empty((ROWS, C), dtype=torch.int32, device=tape.device)
    kernels.launch("picsong_probe2", tape.device, tape.data_ptr(),
                   amt.data_ptr(), out.data_ptr(), what="probe2 launch")
    LAUNCHES += 1
    return out


def inputs(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The inputs of tools/pallas_probe2.py."""
    rng = np.random.default_rng(seed)
    tape_flat = rng.integers(0, 1 << 20, size=(C, 4096)).astype(np.int32)
    amt = rng.integers(0, 4096 - 128, size=(C,)).astype(np.int32)
    return tape_flat.reshape(SLABS, SUBLANES, LANES), amt


def edge_inputs() -> tuple[np.ndarray, np.ndarray]:
    """Inputs at the kernel's edges: INT_MIN (|INT_MIN| wraps), INT_MAX
    (sums wrap), small negative values, and amt 0, 4095 and the slab and
    row boundaries around 1024 and 128."""
    i32 = np.iinfo(np.int32)
    rng = np.random.default_rng(11)
    tape = rng.integers(i32.min, i32.max, size=(SLABS, SUBLANES, LANES),
                        dtype=np.int64).astype(np.int32)
    tape[::3, ::2, ::5] = i32.min
    tape[1::3, 1::2, ::7] = i32.max
    tape[2::3] = rng.integers(-9, 9, size=tape[2::3].shape)
    amt = rng.integers(0, AMT_END, size=C).astype(np.int32)
    amt[:6] = [0, AMT_END - 1, 1023, 1024, 127, 128]
    return tape, amt


def main(argv: list[str] | None = None) -> int:
    return time_entry_point(run, inputs(), argv, calls=100)


if __name__ == "__main__":
    raise SystemExit(main())
