"""Codestream relocation on the codec's device: dense pack and unpack of
the per-codeblock streams, as torch ops.

The reference needs a CUB prefix sum, a binary-search index LUT and a
relocation kernel (BitStreamBuilder.cu); the layout itself is prefix-sum
addressing, so here it is one `cumsum` over `sizes - 1` plus one gather
(pack) or one scatter into a -1 filled buffer (unpack), as the JAX
package's device pack does (`StagedBPC._pack_dense_impl` /
`_unpack_dense_impl`). Only the packed bytes cross to or from the host.

Wire layout (the reference's):
  shorts[0..8]    header (real values on the first component, 0xFFFF
                  filler on the others)
  shorts[9+2i]    codeblock i MSB word     (buildBitStreamLUTBS:128)
  shorts[9+2i+1]  codeblock i size         (words used, the MSB word too)
  payload         words 1..size-1 of every codeblock, concatenated
  final short     0xFFFF filler (launchPrefixArrayGeneration:305)

The shorts live in int16 tensors (torch has no general uint16 arithmetic);
`.view(np.uint16)` of their NumPy form is the codestream.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import spec

HEADER_SHORTS = 9


def stream_length(n_blocks: int, payload: int) -> int:
    """Shorts in a packed codestream of `n_blocks` codeblocks carrying
    `payload` words after their MSB words."""
    return HEADER_SHORTS + 2 * n_blocks + payload + 1


def _as_int16(v: torch.Tensor) -> torch.Tensor:
    """The low 16 bits of int32/int64 values as int16, without relying on
    an out-of-range cast."""
    v = v & 0xFFFF
    return (v - ((v >> 15) << 16)).to(torch.int16)


def pack_streams(streams: torch.Tensor, sizes: torch.Tensor,
                 header: np.ndarray | None) -> torch.Tensor:
    """(N, 4096) int32 streams + (N,) sizes -> the packed codestream, an
    int16 tensor on the streams' device. Reads one scalar from the device:
    the payload length."""
    n = streams.shape[0]
    dev = streams.device
    counts = sizes.to(torch.int64) - 1
    ends = torch.cumsum(counts, 0)
    total = int(ends[-1]) if n else 0
    out = torch.full((stream_length(n, total),), -1, dtype=torch.int16,
                     device=dev)
    if header is not None:
        hdr = np.ascontiguousarray(header, dtype=np.uint16).view(np.int16)
        out[:HEADER_SHORTS] = torch.from_numpy(hdr.copy()).to(dev)
    pairs = torch.stack([streams[:, 0].to(torch.int64), sizes.to(torch.int64)],
                        dim=1)
    out[HEADER_SHORTS:HEADER_SHORTS + 2 * n] = _as_int16(pairs.reshape(-1))
    if total:
        block = torch.repeat_interleave(
            torch.arange(n, device=dev), counts, output_size=total)
        within = (torch.arange(total, device=dev)
                  - (ends - counts)[block] + 1)
        base = HEADER_SHORTS + 2 * n
        out[base:base + total] = _as_int16(
            streams.reshape(-1)[block * spec.CBLOCK_SIZE + within])
    return out


def block_fields(shorts: np.ndarray, n_blocks: int) -> tuple[np.ndarray,
                                                            np.ndarray]:
    """The MSB words and sizes of a packed codestream (uint16 shorts on the
    host), as int64, checked against its length."""
    shorts = np.asarray(shorts)
    pairs = shorts[HEADER_SHORTS:HEADER_SHORTS + 2 * n_blocks].view(np.uint16)
    if pairs.size != 2 * n_blocks:
        raise ValueError(f"codestream of {shorts.size} shorts is too short "
                         f"for {n_blocks} codeblocks")
    msb, sizes = pairs[0::2].astype(np.int64), pairs[1::2].astype(np.int64)
    if n_blocks and (sizes.min() < 1 or sizes.max() > spec.CBLOCK_SIZE):
        raise ValueError("codestream holds a codeblock size outside 1..4096")
    want = stream_length(n_blocks, int(sizes.sum()) - n_blocks)
    if shorts.size < want:
        raise ValueError(f"codestream of {shorts.size} shorts is shorter "
                         f"than its sizes say ({want})")
    return msb, sizes


def unpack_streams(stream: torch.Tensor, n_blocks: int,
                   payload: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A packed codestream (int16 tensor) of `n_blocks` codeblocks with
    `payload` words after their MSB words (from `block_fields`) ->
    ((N, 4096) int32 streams with -1 fill, (N,) int32 sizes), on the
    stream's device. Reads nothing back from the device."""
    dev = stream.device
    u = stream.to(torch.int32) & 0xFFFF
    pairs = u[HEADER_SHORTS:HEADER_SHORTS + 2 * n_blocks].reshape(n_blocks, 2)
    sizes = pairs[:, 1].contiguous()
    out = torch.full((n_blocks, spec.CBLOCK_SIZE), -1, dtype=torch.int32,
                     device=dev)
    out[:, 0] = pairs[:, 0]
    if payload:
        counts = sizes.to(torch.int64) - 1
        ends = torch.cumsum(counts, 0)
        block = torch.repeat_interleave(
            torch.arange(n_blocks, device=dev), counts, output_size=payload)
        within = (torch.arange(payload, device=dev)
                  - (ends - counts)[block] + 1)
        base = HEADER_SHORTS + 2 * n_blocks
        out.view(-1)[block * spec.CBLOCK_SIZE + within] = u[base:base + payload]
    return out, sizes
