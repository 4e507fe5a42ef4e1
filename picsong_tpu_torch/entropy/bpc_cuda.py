"""BPC-PaCo entry points: CPU tensors take the plain PyTorch coder, CUDA
tensors take the hand-written kernels, anything else raises.

`encode_blocks` / `decode_blocks` take the arguments and return the
results of `picsong_tpu.entropy.bpc_jax.encode_blocks` / `decode_blocks`,
as torch tensors on the inputs' device, in every mode: cp=2, cp=3, and
cp=2 with complexity scalability (`has_k`; k is ignored with cp=3, as
there). On CUDA they launch the mode's variant of `csrc/bpc_encode.cu` /
`csrc/bpc_decode.cu` through `kernels.launch`, on the current stream of
the inputs' device, without synchronising; there is no path from a CUDA
tensor to the plain version.

`ENCODE_LAUNCHES` / `DECODE_LAUNCHES` count kernel launches by mode
("cp2", "cp3", "bulk"; one per call on CUDA), so that a run can show which
variants its main path went through. The cp2 kernels also count, on the
card, the coder steps in scope (256 a coded plane of a block whose stream
is not a raw copy) and those they skipped because no lane codes there;
`encode_step_counts` and `decode_step_counts` read both totals of each.
"""

from __future__ import annotations

import torch

from ..core import spec
from ..core.lut import LUTParams

from .. import kernels
from ..obs.trace import spanned
from . import bpc

# the kernels' picsong::Mode values
MODES = {"cp2": 0, "cp3": 1, "bulk": 2}

# int32 operations of one coding step of a lane (ac_encode / ac_decode:
# the interval multiply, shift, add, compare and selects), the count the
# work bound of `bound_ms` charges per coded symbol
OPS_PER_STEP = 12
ENCODE_LAUNCHES = dict.fromkeys(MODES, 0)
DECODE_LAUNCHES = dict.fromkeys(MODES, 0)
# by kernel and device: the cp2 kernel's (steps in scope, steps skipped),
# int64
_STEP_COUNTS: dict[str, dict[torch.device, torch.Tensor]] = {
    "encode": {}, "decode": {}}


def reset_launches() -> None:
    for counts in (ENCODE_LAUNCHES, DECODE_LAUNCHES):
        counts.update(dict.fromkeys(MODES, 0))


def _step_totals(kernel: str) -> tuple[int, int]:
    total = sum((t.cpu() for t in _STEP_COUNTS[kernel].values()),
                torch.zeros(2, dtype=torch.int64))
    return int(total[0]), int(total[1])


def encode_step_counts() -> tuple[int, int]:
    """The cp2 encode kernel's coder steps in scope and steps skipped, over
    every card and every launch so far; one read of each card's counters,
    which waits for the work queued before it."""
    return _step_totals("encode")


def decode_step_counts() -> tuple[int, int]:
    """The same of the cp2 decode kernel."""
    return _step_totals("decode")


def _step_counts(kernel: str, device: torch.device) -> torch.Tensor:
    counts = _STEP_COUNTS[kernel].get(device)
    if counts is None:
        counts = torch.zeros(2, dtype=torch.int64, device=device)
        _STEP_COUNTS[kernel][device] = counts
    return counts


def mode_of(coding_passes: int, has_k: bool) -> str:
    """The kernel variant of a configuration."""
    if coding_passes not in (2, 3):
        raise ValueError(f"coding_passes must be 2 or 3, got {coding_passes}")
    if coding_passes == 3:
        return "cp3"
    return "bulk" if has_k else "cp2"


def bound_ms(blocks: torch.Tensor) -> tuple[float, str]:
    """The least time an H100 could take to encode (or decode) these
    (N, 64, 64) codeblocks, and what bounds it: the larger of the bytes
    (the blocks read once, the (N, 4096) streams written once; the reverse
    for decode) over the memory rate, and the coded symbols (every cell of
    every plane from each block's MSB down, plus one sign per nonzero
    coefficient) times OPS_PER_STEP over the int32 rate."""
    n = blocks.shape[0]
    mag = blocks.reshape(n, -1).abs().amax(dim=1).cpu().to(torch.int64)
    powers = 2 ** torch.arange(32, dtype=torch.int64)
    msb = (mag[:, None] >= powers[None, :]).sum(dim=1) - 1
    steps = float((msb + 1).sum()) * blocks[0].numel() + float(
        torch.count_nonzero(blocks))
    ops_s = steps * OPS_PER_STEP / kernels.INT32_OPS_PER_S
    bytes_s = 2 * n * blocks[0].numel() * 4 / kernels.BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def _meta_pointers(n: int, lut, meta, n_planes: int) -> list[int]:
    """Check the LUT, the six per-block arrays and n_planes; return the
    arrays' pointers."""
    if lut.numel() == 0:
        raise ValueError("lut must not be empty")
    kernels.check_tensor(lut, "lut", (lut.numel(),))
    names = ("ref_base", "sig_base", "sign_base", "cp_sig_base",
             "cp_sign_base", "k_over_l2")
    for name, t in zip(names, meta, strict=True):
        kernels.check_tensor(t, name, (n,), torch.float32
                             if name == "k_over_l2" else torch.int32)
    if not 1 <= n_planes <= 32:
        raise ValueError(f"n_planes must be in 1..32, got {n_planes}")
    return [t.data_ptr() for t in meta]


@spanned("picsong/k1")
def encode_blocks(blocks, lut, ref_b, sig_b, sign_b, cp_sig_b, cp_sign_b,
                  k_over_l2, *, params: LUTParams, wavelet_levels: int,
                  coding_passes: int, has_k: bool, n_planes: int):
    """(N, 64, 64) int32 codeblocks -> (streams (N, 4096), sizes (N,))."""
    meta = (ref_b, sig_b, sign_b, cp_sig_b, cp_sign_b, k_over_l2)
    kw = dict(params=params, wavelet_levels=wavelet_levels,
              coding_passes=coding_passes, has_k=has_k, n_planes=n_planes)
    mode = mode_of(coding_passes, has_k)
    if kernels.device_type([blocks, lut, *meta], "BPC-PaCo") == "cpu":
        return bpc.encode_blocks_plain(blocks, lut, *meta, **kw)
    n = blocks.shape[0]
    kernels.check_tensor(blocks, "blocks",
                         (n, spec.CBLOCK_LENGTH, spec.CBLOCK_WIDTH))
    kernels.check_aligned(blocks, "blocks")
    ptrs = _meta_pointers(n, lut, meta, n_planes)
    dev = blocks.device
    streams = torch.empty((n, spec.CBLOCK_SIZE), dtype=torch.int32,
                          device=dev)
    sizes = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return streams, sizes
    kernels.launch(
        "picsong_bpc_encode", dev, blocks.data_ptr(), lut.data_ptr(),
        lut.numel(), *ptrs, n, n_planes, params.mult_precision,
        params.stride_per_group(wavelet_levels), MODES[mode],
        streams.data_ptr(), sizes.data_ptr(),
        _step_counts("encode", dev).data_ptr(),
        what=f"bpc_encode {mode} launch")
    ENCODE_LAUNCHES[mode] += 1
    return streams, sizes


@spanned("picsong/k2")
def decode_blocks(streams, sizes, lut, ref_b, sig_b, sign_b, cp_sig_b,
                  cp_sign_b, k_over_l2, *, params: LUTParams,
                  wavelet_levels: int, coding_passes: int, has_k: bool,
                  n_planes: int):
    """(N, 4096) int32 streams + (N,) int32 sizes -> (N, 64, 64) int32."""
    meta = (ref_b, sig_b, sign_b, cp_sig_b, cp_sign_b, k_over_l2)
    kw = dict(params=params, wavelet_levels=wavelet_levels,
              coding_passes=coding_passes, has_k=has_k, n_planes=n_planes)
    mode = mode_of(coding_passes, has_k)
    if kernels.device_type([streams, sizes, lut, *meta], "BPC-PaCo") == "cpu":
        return bpc.decode_blocks_plain(streams, sizes, lut, *meta, **kw)
    n = streams.shape[0]
    kernels.check_tensor(streams, "streams", (n, spec.CBLOCK_SIZE))
    kernels.check_tensor(sizes, "sizes", (n,))
    kernels.check_aligned(streams, "streams")
    ptrs = _meta_pointers(n, lut, meta, n_planes)
    dev = streams.device
    out = torch.empty((n, spec.CBLOCK_LENGTH, spec.CBLOCK_WIDTH),
                      dtype=torch.int32, device=dev)
    if n == 0:
        return out
    kernels.launch(
        "picsong_bpc_decode", dev, streams.data_ptr(), sizes.data_ptr(),
        lut.data_ptr(), lut.numel(), *ptrs, n, n_planes,
        params.mult_precision, params.stride_per_group(wavelet_levels),
        MODES[mode], out.data_ptr(), _step_counts("decode", dev).data_ptr(),
        what=f"bpc_decode {mode} launch")
    DECODE_LAUNCHES[mode] += 1
    return out
