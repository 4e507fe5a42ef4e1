"""Codestream relocation on the codec's device: dense pack and unpack of
the per-codeblock streams (X3).

`pack_streams` / `unpack_streams` dispatch on the tensors' device: CPU
tensors take the plain version (`pack_streams_plain` /
`unpack_streams_plain`, torch ops: one `cumsum` over `sizes - 1`, then a
gather (pack) or a scatter into a -1 filled buffer (unpack), as the JAX
package's device pack does, `StagedBPC._pack_dense_impl` /
`_unpack_dense_impl`); CUDA tensors take the hand-written kernels of
`csrc/pack.cu` (one launch a call: a CTA a tile of TILE_BLOCKS codeblocks
finds its offsets by a single-pass scan with decoupled look-back over
per-call status words, then one warp per codeblock moves its words in
16-byte stores or loads staged through shared memory; the reference's
InclusiveSum + buildBitStreamLUTBS in BitStreamBuilder.cu); anything else
raises. There is no path from a CUDA tensor to the plain version. The
kernels launch through `kernels.launch`, on the current stream of the
tensors' device, and synchronise only to read the payload total when the
caller does not give it. `PACK_LAUNCHES` / `UNPACK_LAUNCHES` count the calls
that launched them. Only the packed bytes cross to or from the host.

Wire layout (the reference's):
  shorts[0..8]    header (real values on the first component, 0xFFFF
                  filler on the others)
  shorts[9+2i]    codeblock i MSB word     (buildBitStreamLUTBS:128)
  shorts[9+2i+1]  codeblock i size         (words used, the MSB word too)
  payload         words 1..size-1 of every codeblock, concatenated
  final short     0xFFFF filler (launchPrefixArrayGeneration:305)

The shorts live in int16 tensors (torch has no general uint16 arithmetic);
`.view(np.uint16)` of their NumPy form is the codestream.

A batch of video frames is coded frame-major, `n_blocks` codeblocks a
frame, and packed as one codestream of all its blocks (no header): the
frames' (MSB, size) pairs and payloads are then contiguous, so
`split_frames` cuts the downloaded batch into per-frame codestreams on the
host, and `join_frames` glues per-frame codestreams into one for upload
(the JAX package's `fuse_packed`/`split_packed` and `_assemble_frame`).
A row-sharded image (`dist/sharded.py`) is the same with parts of unequal
block counts: each shard packs its share of the codeblocks, and
`join_frames` glues the shares into the image's codestream. Both stay
host NumPy: they cut and glue bytes that are already on the host.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..core import spec
from ..obs.trace import readback, spanned

HEADER_SHORTS = 9
# codeblocks a CTA of csrc/pack.cu takes, a tile of its scan (kTileBlocks),
# and the int64 words from one tile's status word to the next
# (kStatusStride: one 128-byte line each)
TILE_BLOCKS = 8
STATUS_STRIDE = 16

PACK_LAUNCHES = 0
UNPACK_LAUNCHES = 0


def reset_launches() -> None:
    global PACK_LAUNCHES, UNPACK_LAUNCHES
    PACK_LAUNCHES = UNPACK_LAUNCHES = 0


def stream_length(n_blocks: int, payload: int) -> int:
    """Shorts in a packed codestream of `n_blocks` codeblocks carrying
    `payload` words after their MSB words."""
    return HEADER_SHORTS + 2 * n_blocks + payload + 1


def status_words(n_blocks: int) -> int:
    """The int64 scratch words of one kernel call: a status word a tile
    (one tile when there are no blocks), STATUS_STRIDE words apart, then
    the payload total."""
    return max(1, -(-n_blocks // TILE_BLOCKS)) * STATUS_STRIDE + 1


def _as_int16(v: torch.Tensor) -> torch.Tensor:
    """The low 16 bits of int32/int64 values as int16, without relying on
    an out-of-range cast."""
    v = v & 0xFFFF
    return (v - ((v >> 15) << 16)).to(torch.int16)


def pack_streams_plain(streams: torch.Tensor, sizes: torch.Tensor,
                       header: np.ndarray | None,
                       payload: int | None = None) -> torch.Tensor:
    """X3's pack as torch ops: (N, 4096) int32 streams + (N,) sizes -> the
    packed codestream, an int16 tensor on the streams' device. Reads one
    scalar from the device, the payload length, unless the caller gives
    it (`sizes.sum() - N`)."""
    n = streams.shape[0]
    dev = streams.device
    counts = sizes.to(torch.int64) - 1
    ends = torch.cumsum(counts, 0)
    total = payload or 0
    if payload is None and n:
        with readback("picsong/x3.pack.read_total"):
            total = int(ends[-1])
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


def unpack_streams_plain(stream: torch.Tensor, n_blocks: int,
                         payload: int) -> tuple[torch.Tensor, torch.Tensor]:
    """X3's unpack as torch ops: a packed codestream (int16 tensor) of
    `n_blocks` codeblocks with `payload` words after their MSB words ->
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


# --------------------------------------------------------------------------
# The dispatching entry points and the kernels
# --------------------------------------------------------------------------

def _check_payload(payload: int | None) -> None:
    if payload is not None and payload < 0:
        raise ValueError(f"payload must be >= 0, got {payload}")


@spanned("picsong/x3.pack")
def pack_streams(streams: torch.Tensor, sizes: torch.Tensor,
                 header: np.ndarray | None,
                 payload: int | None = None) -> torch.Tensor:
    """(N, 4096) int32 streams + (N,) int32 sizes (1..4096) -> the packed
    codestream of `stream_length(N, payload)` shorts, an int16 tensor on
    the streams' device, with `header` (9 shorts) or the filler. Reads one
    scalar from the device, the payload length, unless the caller gives
    it (`sizes.sum() - N`)."""
    global PACK_LAUNCHES
    n = streams.shape[0] if streams.dim() else 0
    kernels.check_tensor(streams, "streams", (n, spec.CBLOCK_SIZE))
    kernels.check_tensor(sizes, "sizes", (n,))
    _check_payload(payload)
    if kernels.device_type([streams, sizes], "X3") == "cpu":
        return pack_streams_plain(streams, sizes, header, payload)
    kernels.check_aligned(streams, "streams")
    hdr = None
    if header is not None:
        hdr = np.ascontiguousarray(header, dtype=np.uint16)
        if hdr.shape != (HEADER_SHORTS,):
            raise ValueError(f"header must hold {HEADER_SHORTS} shorts, got "
                             f"shape {hdr.shape}")
        hdr = (ctypes.c_uint16 * HEADER_SHORTS)(*hdr.tolist())
    dev = streams.device
    # the worst case (every block a raw copy) when the total is unknown;
    # the exact prefix is returned after the one read
    capacity = (spec.CBLOCK_SIZE - 1) * n if payload is None else payload
    out = torch.empty(stream_length(n, capacity), dtype=torch.int16,
                      device=dev)
    # per-call scratch, zeroed on the current stream: calls in flight on
    # other streams or devices never share it
    status = torch.zeros(status_words(n), dtype=torch.int64, device=dev)
    kernels.launch(
        "picsong_pack", dev, streams.data_ptr(), sizes.data_ptr(), n,
        None if hdr is None else ctypes.addressof(hdr), capacity,
        status.data_ptr(), out.data_ptr(), what="pack launch")
    PACK_LAUNCHES += 1
    if payload is None:
        with readback("picsong/x3.pack.read_total"):
            total = int(status[-1])
        return out[:stream_length(n, total)]
    return out


@spanned("picsong/x3.unpack")
def unpack_streams(stream: torch.Tensor, n_blocks: int,
                   payload: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A packed codestream (int16 tensor) of `n_blocks` codeblocks with
    `payload` words after their MSB words (from `block_fields`) ->
    ((N, 4096) int32 streams with -1 fill, (N,) int32 sizes), on the
    stream's device. Reads nothing back from the device."""
    global UNPACK_LAUNCHES
    if n_blocks < 0:
        raise ValueError(f"n_blocks must be >= 0, got {n_blocks}")
    _check_payload(payload)
    if stream.dtype != torch.int16:
        raise TypeError(f"stream must be torch.int16, got {stream.dtype}")
    if stream.dim() != 1 or not stream.is_contiguous():
        raise ValueError("stream must be a contiguous 1-D tensor")
    if stream.numel() < stream_length(n_blocks, payload):
        raise ValueError(f"stream of {stream.numel()} shorts is shorter than "
                         f"{n_blocks} codeblocks with {payload} payload "
                         "words")
    if kernels.device_type([stream], "X3") == "cpu":
        return unpack_streams_plain(stream, n_blocks, payload)
    dev = stream.device
    out = torch.empty((n_blocks, spec.CBLOCK_SIZE), dtype=torch.int32,
                      device=dev)
    sizes = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    if n_blocks == 0:
        return out, sizes
    status = torch.zeros(status_words(n_blocks), dtype=torch.int64,
                         device=dev)
    kernels.launch(
        "picsong_unpack", dev, stream.data_ptr(), n_blocks, payload,
        status.data_ptr(), out.data_ptr(), sizes.data_ptr(),
        what="unpack launch")
    UNPACK_LAUNCHES += 1
    return out, sizes


def bound_ms(n_blocks: int, payload: int) -> dict[str, tuple[float, str]]:
    """The least time an H100 could take to pack (and to unpack) `n_blocks`
    codeblocks carrying `payload` words after their MSB words, by
    direction, and what bounds it: the bytes over the memory rate. Pack:
    the sizes, the MSB words and the payload words read as int32, the
    codestream written. Unpack: the codestream read, the (N, 4096) int32
    rows and the sizes written. The work is a copy: no operation count
    comes near the bytes."""
    code = 2 * stream_length(n_blocks, payload)
    moved = {"pack": 4 * (2 * n_blocks + payload) + code,
             "unpack": code + 4 * n_blocks * (spec.CBLOCK_SIZE + 1)}
    return {d: (b / kernels.BYTES_PER_S * 1e3, "bytes")
            for d, b in moved.items()}


def _counts(n_parts: int, n_blocks) -> np.ndarray:
    """Block counts of `n_parts` parts: `n_blocks` each (an int), or the
    sequence as given."""
    if np.ndim(n_blocks) == 0:
        return np.full(n_parts, int(n_blocks), dtype=np.int64)
    counts = np.asarray(n_blocks, dtype=np.int64)
    if counts.shape != (n_parts,):
        raise ValueError(f"{counts.size} block counts for {n_parts} parts")
    return counts


def split_frames(shorts: np.ndarray, n_frames: int, n_blocks,
                 header: np.ndarray | None) -> list[np.ndarray]:
    """The packed codestream of `n_frames` parts' blocks, part-major
    (uint16 shorts on the host) -> one codestream per part, each the shorts
    `pack_streams` gives for that part's blocks and `header`. `n_blocks` is
    the block count of every part (the frames of a video batch), or one
    count per part (the shares of a row-sharded image, some of them
    empty)."""
    counts = _counts(n_frames, n_blocks)
    ends = np.concatenate([[0], np.cumsum(counts)])
    n = int(ends[-1])
    sizes = block_fields(shorts, n)[1]
    pairs = shorts[HEADER_SHORTS:HEADER_SHORTS + 2 * n]
    words = np.concatenate([[0], np.cumsum(sizes - 1)])[ends]
    starts = HEADER_SHORTS + 2 * n + words
    out = []
    for f in range(n_frames):
        k = int(counts[f])
        frame = np.full(stream_length(k, int(words[f + 1] - words[f])),
                        0xFFFF, dtype=np.uint16)
        if header is not None:
            frame[:HEADER_SHORTS] = header
        body = HEADER_SHORTS + 2 * k
        frame[HEADER_SHORTS:body] = pairs[2 * ends[f]:2 * ends[f + 1]]
        frame[body:-1] = shorts[starts[f]:starts[f + 1]]
        out.append(frame)
    return out


def join_frames(streams: list[np.ndarray], n_blocks,
                header: np.ndarray | None = None) -> tuple[
        np.ndarray, np.ndarray, np.ndarray]:
    """Per-part codestreams (uint16 shorts) of `n_blocks` codeblocks each,
    or of one count per part as in `split_frames` -> (one codestream of all
    their blocks, part-major, with `header` or a filler header; the blocks'
    MSB words; their sizes): the input of one `unpack_streams` for a video
    batch, or a row-sharded image's codestream."""
    counts = _counts(len(streams), n_blocks)
    fields = [block_fields(s, int(k)) for s, k in zip(streams, counts)]
    pairs = [s[HEADER_SHORTS:HEADER_SHORTS + 2 * int(k)]
             for s, k in zip(streams, counts)]
    payloads = [s[HEADER_SHORTS + 2 * int(k):
                  HEADER_SHORTS + 2 * int(k) + int(z.sum()) - int(k)]
                for s, k, (_, z) in zip(streams, counts, fields)]
    filler = np.full(HEADER_SHORTS, 0xFFFF, dtype=np.uint16)
    head = filler if header is None else np.asarray(header, dtype=np.uint16)
    joined = np.concatenate([head, *pairs, *payloads, filler[:1]])
    return (joined, np.concatenate([m for m, _ in fields]),
            np.concatenate([z for _, z in fields]))
