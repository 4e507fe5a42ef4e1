"""Pipelined video engine on torch: `encode_video` and `decode_video`.

Counterpart of `picsong_tpu.engine.video`, with its signatures (plus
`device`), file bytes and `_SIZE` sidecar. The reference overlaps disk
reads, copies, kernels and disk writes with N CUDA streams fed by reader
and writer threads (Engines/CodingEngine.cu:758-983, 203-262;
DecodingEngine.cu:866-1043). Here B frames ride one `BatchCodec` launch
per component, and four roles overlap:

  reader thread     -> bounded queue of padded frame batches in pinned
                       host memory (decoding: of joined codestreams)
  compute loop      -> uploads a batch and enqueues its device work on a
                       compute stream; it never waits for that batch
  downloader thread -> once the batch's event has completed, packs its
                       streams (encoding) and copies the results into
                       pinned host memory on a copy stream, in batch order
  writer thread     -> cuts and writes the results, in batch order

The encoder needs a batch's bitplane count (its coefficient maximum)
before the batch's BPC launch, so the compute loop runs one batch behind
itself: it enqueues batch b's DWT and the copy of its maximum, then waits
for batch b-1's maximum, which the card had a whole iteration to produce,
and launches batch b-1's coder. The count is exact for every batch, and
as the coder starts at each block's own MSB the bytes do not depend on
it: `check_planes_bound` on the downloaded MSB words can only fail on a
bug, and then it raises.

Only packed codestreams cross PCIe: per component and batch, one copy of
the payload length (enqueued by the compute loop) and one of the packed
shorts (`assembly/pack.py`); decoding uploads a batch's joined codestream
per component and unpacks it on the card.

On the CPU (device="cpu") the same loop runs with the plain coder and no
streams, events or pinned memory.

With `devices` > 1 (frame data parallelism, the JAX engine's
`FrameParallelCodec` mesh) the batch is rounded up to a multiple of the
device count and each batch's frames are split into that many contiguous
shares, each coded by its own `BatchCodec` on its own device
(`dist/sharded.py::FrameParallelCodec`, placed by `make_devices`), with
one BPC launch per component and share. The roles stay the same: the
compute loop enqueues every share's work on its device's compute stream,
the batch's bitplane count is the max over the shares' maxima, the
downloader packs each share on its own device's copy stream, and the
writer cuts every share's frames in frame order, so the file is the one
`devices=1` writes.

Stage timers keep the reference's printed metrics (CodingEngine.cu:258,
495, 1049): reader / writer stall = time the compute loop was blocked on
that side; compute = the compute loop's own time (its wait for the
previous batch's maximum included); download = the downloader's time per
batch, from its wait for the batch's work to the end of its copies.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..assembly import pack
from ..core import spec
from ..core.header import CodecConfig, pack_header
from ..core.image_io import (append_raw_frame, mirror_pad, read_codestream,
                             read_raw_frame, read_sizes, sample_dtype,
                             write_codestream)
from ..dist.sharded import FrameParallelCodec, make_devices
from ..entropy import bpc

# device memory that batches in flight may hold
_INFLIGHT_BYTES = int(2e9)
# frame batches queued between the reader and the compute loop, and
# between the downloader and the writer
_QUEUE_DEPTH = 2


@dataclass
class VideoStats:
    frames: int = 0
    reader_stall_s: float = 0.0   # compute loop blocked waiting for frames
    writer_stall_s: float = 0.0   # compute loop blocked on writer backlog
    writer_busy_s: float = 0.0    # writer thread pack+write time
    download_s: float = 0.0       # device->host result transfers
    compute_s: float = 0.0        # device enqueue time in the compute loop
    wall_s: float = 0.0
    batches: int = 0
    batch: int = 1
    n_planes: int = 0

    def as_dict(self) -> dict:
        return dict(frames=self.frames, reader_stall_s=self.reader_stall_s,
                    writer_stall_s=self.writer_stall_s,
                    writer_busy_s=self.writer_busy_s,
                    download_s=self.download_s,
                    compute_s=self.compute_s, wall_s=self.wall_s,
                    batches=self.batches, batch=self.batch,
                    n_planes=self.n_planes)


class _ReaderError:
    """Sentinel carrying a reader-thread exception to the compute loop."""

    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclass
class _Prefetcher:
    """Reader thread with a bounded queue (the double-buffer input lane).

    A fetch failure (truncated frame, unreadable file) is forwarded as a
    sentinel so the compute loop's get() re-raises instead of blocking
    forever on a dead thread (the reference's reader thread fails the
    whole process on I/O error, CodingEngine.cu:231-254)."""

    fetch: callable
    count: int
    depth: int
    q: queue.Queue = field(init=False)

    def __post_init__(self):
        self.q = queue.Queue(maxsize=self.depth)
        self._stop = False
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        for i in range(self.count):
            try:
                item = (i, self.fetch(i))
            except BaseException as e:   # surfaced on the consumer's get()
                item = _ReaderError(e)
            while not self._stop:
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if self._stop or isinstance(item, _ReaderError):
                return

    def get(self):
        item = self.q.get()
        if isinstance(item, _ReaderError):
            raise item.exc
        return item

    def close(self):
        """Stop and join the thread (it ends within its current fetch and
        one put timeout): a reader blocked in q.put on a full queue would
        otherwise leak one thread and one frame batch per failed call."""
        self._stop = True
        self.t.join()


class _Writer:
    """Ordered worker thread: items are processed in put() order."""

    def __init__(self, fn, depth: int):
        self.fn = fn
        self.q = queue.Queue(maxsize=depth)
        self.busy_s = 0.0
        self.error: BaseException | None = None
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            t0 = time.perf_counter()
            try:
                self.fn(*item)
            except BaseException as e:   # surfaced on put()/join()
                self.error = e
                # keep draining so a producer blocked in q.put() wakes up
                while True:
                    item = self.q.get()
                    if item is None:
                        return
            self.busy_s += time.perf_counter() - t0

    def put(self, *item):
        if self.error is not None:
            raise self.error
        self.q.put(item)
        if self.error is not None:
            raise self.error

    def join(self):
        self.q.put(None)
        self.t.join()
        if self.error is not None:
            raise self.error

    def shutdown(self):
        """Idempotent, non-raising sentinel + join for error-path cleanup,
        so that a failed call leaks no thread."""
        if self.t.is_alive():
            self.q.put(None)
            self.t.join()


class _Device:
    """The codec's device as the video threads use it: on CUDA a compute
    and a copy stream, events and pinned host buffers; on the CPU none of
    them, and every wait returns at once."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.compute = torch.cuda.Stream(device) if self.cuda else None
        self.copy = torch.cuda.Stream(device) if self.cuda else None

    def on(self, stream=None):
        """Context of a thread that touches the card: its device and, if
        given, its stream (torch's current stream is per thread)."""
        stack = contextlib.ExitStack()
        if self.cuda:
            stack.enter_context(torch.cuda.device(self.device))
            if stream is not None:
                stack.enter_context(torch.cuda.stream(stream))
        return stack

    def event(self):
        """An event behind the work enqueued so far on the current stream."""
        if not self.cuda:
            return None
        e = torch.cuda.Event()
        e.record()
        return e

    @staticmethod
    def wait(event) -> None:
        if event is not None:
            event.synchronize()

    def host(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.cuda)

    def upload(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True)

    def download(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of `t` into pinned host memory, enqueued on the current
        stream (on the CPU, `t` itself)."""
        if not self.cuda:
            return t
        out = self.host(t.shape, t.dtype)
        out.copy_(t, non_blocking=True)
        return out


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype.newbyteorder("="))).dtype


def _shares(cfg: CodecConfig, luts, params, batch: int, devices,
            device) -> tuple[FrameParallelCodec, list]:
    """The frame-parallel codec of a batch rounded up to a multiple of the
    device count, and per share (its BatchCodec, its `_Device`, its first
    frame in the batch)."""
    devs = make_devices(devices, device)
    batch = -(-batch // len(devs)) * len(devs)
    fp = FrameParallelCodec(cfg, luts, params, devs, batch)
    return fp, [(bc, _Device(bc.device), j * fp.share)
                for j, bc in enumerate(fp.codecs)]


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------

def encode_video(input_path: str, output_path: str, cfg: CodecConfig,
                 luts, params, frames: int, batch: int = 8,
                 progress: bool = False, frame_offset: int = 0,
                 devices=1, device="cuda") -> VideoStats:
    """Encode a planar RAW video (grayscale or RGB) frame sequence.

    frame_offset encodes frames [frame_offset, frame_offset + frames) of
    the input, the per-host slab window for multi-host striping. devices
    (a count, or a sequence of devices; `dist/sharded.py::make_devices`)
    splits each batch's frames over that many devices."""
    fp, shares = _shares(cfg, luts, params, max(1, min(batch, frames)),
                         devices, device)
    batch, share = fp.batch, fp.share
    header = pack_header(cfg)
    stats = VideoStats(batch=batch)
    t0 = time.perf_counter()
    n_comp = 3 if cfg.is_rgb else 1
    n_batches = -(-frames // batch)
    ncb_s = share * fp.ncb
    # a batch in flight holds its int32 stream buffers on the devices
    max_inflight = max(1, _INFLIGHT_BYTES
                       // (batch * fp.ncb * spec.CBLOCK_SIZE * 4 * n_comp))

    dtype = sample_dtype(cfg.bps, cfg.endianess, cfg.is_signed)
    shape = ((batch, 3, fp.ah, fp.aw) if cfg.is_rgb
             else (batch, fp.ah, fp.aw))
    first = shares[0][1]

    def read_plane(i):
        return mirror_pad(read_raw_frame(input_path, cfg.width, cfg.height, i,
                                         dtype), fp.aw, fp.ah)

    def fetch_batch(bi):
        with first.on():
            buf = first.host(shape, _torch_dtype(dtype))
        host = buf.numpy()
        for j in range(batch):
            i = min(bi * batch + j, frames - 1) + frame_offset  # tail: repeat
            if cfg.is_rgb:
                for c in range(3):
                    host[j, c] = read_plane(i * 3 + c)
            else:
                host[j] = read_plane(i)
        return buf

    def write_batch(bi, comp_shorts):
        """comp_shorts: per component, each share's packed shorts."""
        nreal = min(frames - bi * batch, batch)
        per_comp = [[f for s in parts for f in pack.split_frames(
                        s, share, fp.ncb, header if c == 0 else None)]
                    for c, parts in enumerate(comp_shorts)]
        for f in range(nreal):
            for c in range(n_comp):
                write_codestream(output_path, per_comp[c][f],
                                 first=(bi == 0 and f == 0 and c == 0))
        stats.frames += nreal
        if progress:
            print(f"\rframe {stats.frames}/{frames}", end="", flush=True)

    def download(bi, launched, n_planes):
        """Each share's pack and download on its copy stream, once its
        coder's event has completed."""
        td = time.perf_counter()
        comp_shorts = [[] for _ in range(n_comp)]
        for (_, dev, _), (coded, payloads, done) in zip(shares, launched):
            dev.wait(done)
            with dev.on(dev.copy):
                host = [dev.download(pack.pack_streams(s, z, None, payload=p))
                        for (s, z), p in zip(coded, payloads.tolist())]
                dev.wait(dev.event())
            for c, h in enumerate(host):
                shorts = h.numpy().view(np.uint16)
                bpc.check_planes_bound(*pack.block_fields(shorts, ncb_s),
                                       n_planes)
                comp_shorts[c].append(shorts)
        stats.download_s += time.perf_counter() - td
        writer.put(bi, comp_shorts)

    def launch(bi, staged):
        """Batch bi's coders, once the coefficient maxima of all its shares
        are on the host: one bitplane count for the batch."""
        for _, _, ready in staged:
            first.wait(ready)
        n_planes = bpc.planes_for_magnitude(max(int(m) for _, m, _ in staged))
        launched = []
        for (bc, dev, _), (blocks, _, _) in zip(shares, staged):
            with dev.on(dev.compute):
                coded = bc.encode_blocks(blocks, n_planes)
                payloads = dev.download(torch.stack(
                    [z.sum(dtype=torch.int64) for _, z in coded]) - ncb_s)
                launched.append((coded, payloads, dev.event()))
        stats.n_planes = max(stats.n_planes, n_planes)
        stats.batches += 1
        return bi, launched, n_planes

    writer = _Writer(write_batch, depth=_QUEUE_DEPTH)
    downloader = _Writer(download, depth=max_inflight)
    reader = _Prefetcher(fetch_batch, n_batches, _QUEUE_DEPTH)
    try:
        previous = None
        for bi in range(n_batches + 1):
            staged = None
            if bi < n_batches:
                tr = time.perf_counter()
                _, host = reader.get()
                stats.reader_stall_s += time.perf_counter() - tr
            tc = time.perf_counter()
            if bi < n_batches:
                # enqueue batch bi first, so that the card has its DWT to
                # run while the host waits for batch bi-1's maxima
                staged = []
                for bc, dev, lo in shares:
                    with dev.on(dev.compute):
                        blocks, max_mag = bc.prep_batch(
                            dev.upload(host[lo:lo + share]))
                        staged.append((blocks, dev.download(max_mag),
                                       dev.event()))
                staged = (bi, staged)
            launched = launch(*previous) if previous else None
            previous = staged
            stats.compute_s += time.perf_counter() - tc
            if launched is not None:
                tw = time.perf_counter()
                downloader.put(*launched)
                stats.writer_stall_s += time.perf_counter() - tw
        downloader.join()
        writer.join()
    finally:
        # error path: release all three threads so a failed call never
        # leaks one
        reader.close()
        downloader.shutdown()
        writer.shutdown()
    stats.writer_busy_s = writer.busy_s
    if progress:
        print()
    stats.wall_s = time.perf_counter() - t0
    return stats


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def decode_video(input_path: str, output_path: str, cfg: CodecConfig,
                 luts, params, batch: int = 8, progress: bool = False,
                 devices=1, frame_offset: int = 0,
                 frames: int | None = None, device="cuda") -> VideoStats:
    """Decode an appended-codestream video file back to planar RAW.

    frame_offset/frames select a window of the video: the `_SIZE`
    sidecar's prefix offsets give random access to any frame (the
    reference's resume-at-frame-i analogue, IOManager.ipp:176-208,
    DecodingEngine.cu:257-283). devices as in `encode_video`."""
    all_sizes = read_sizes(input_path)
    n_comp = 3 if cfg.is_rgb else 1
    total_frames = len(all_sizes) // n_comp
    if frames is None:
        frames = total_frames - frame_offset
    all_offsets = np.concatenate([[0], np.cumsum(all_sizes)])
    lo = frame_offset * n_comp
    sizes = all_sizes[lo:(frame_offset + frames) * n_comp]
    offsets = all_offsets[lo:]          # absolute short offsets, local index
    n_frames = frames
    fp, shares = _shares(cfg, luts, params, max(1, min(batch, n_frames)),
                         devices, device)
    batch, share = fp.batch, fp.share
    stats = VideoStats(batch=batch)
    t0 = time.perf_counter()
    n_batches = -(-n_frames // batch)
    ncb_s = share * fp.ncb
    dtype = sample_dtype(cfg.bps, cfg.endianess, cfg.is_signed)
    # a batch in flight holds its decoded samples on the devices
    max_inflight = max(1, _INFLIGHT_BYTES // (batch * fp.ah * fp.aw
                                              * n_comp * dtype.itemsize))
    first = shares[0][1]

    def fetch_batch(bi):
        """Read B frames' codestreams -> per component and share (the
        share's joined codestream in pinned memory, its payload length),
        and the batch's bitplane count."""
        comps, fields = [], []
        for c in range(n_comp):
            parts = []
            for _, _, j0 in shares:
                streams = []
                for j in range(j0, j0 + share):
                    f = min(bi * batch + j, n_frames - 1)  # tail: the last
                    k = f * n_comp + c
                    streams.append(read_codestream(input_path,
                                                   int(offsets[k]),
                                                   int(sizes[k])))
                joined, msb, z = pack.join_frames(streams, fp.ncb)
                with first.on():
                    buf = first.host(joined.shape, torch.int16)
                buf.numpy()[:] = joined.view(np.int16)
                parts.append((buf, int(z.sum()) - ncb_s))
                fields.append((msb, z))
            comps.append(parts)
        n_planes = max(bpc.planes_for_streams(m, z) for m, z in fields)
        return comps, n_planes

    reader = _Prefetcher(fetch_batch, n_batches, _QUEUE_DEPTH)
    if os.path.exists(output_path):
        os.remove(output_path)

    def write_batch(bi, planes):
        nreal = min(n_frames - bi * batch, batch)
        for f in range(nreal):
            for p in (planes[f] if cfg.is_rgb else planes[f:f + 1]):
                append_raw_frame(output_path, p[:cfg.height, :cfg.width],
                                 dtype)
        stats.frames += nreal
        if progress:
            print(f"\rframe {stats.frames}/{n_frames}", end="", flush=True)

    def download(bi, decoded):
        """Each share's samples to the host on its copy stream, once its
        decode's event has completed; the shares in frame order."""
        td = time.perf_counter()
        host = []
        for (_, dev, _), (planes, done) in zip(shares, decoded):
            dev.wait(done)
            with dev.on(dev.copy):
                host.append(dev.download(planes))
                dev.wait(dev.event())
        stats.download_s += time.perf_counter() - td
        writer.put(bi, np.concatenate([h.numpy() for h in host]))

    writer = _Writer(write_batch, depth=_QUEUE_DEPTH)
    downloader = _Writer(download, depth=max_inflight)
    try:
        for bi in range(n_batches):
            tr = time.perf_counter()
            _, (comps, n_planes) = reader.get()
            stats.reader_stall_s += time.perf_counter() - tr
            tc = time.perf_counter()
            decoded = []
            for j, (bc, dev, _) in enumerate(shares):
                with dev.on(dev.compute):
                    coded = [pack.unpack_streams(dev.upload(buf), ncb_s,
                                                 payload)
                             for buf, payload in (c[j] for c in comps)]
                    decoded.append((bc.decode_batch(coded, n_planes),
                                    dev.event()))
            stats.compute_s += time.perf_counter() - tc
            stats.batches += 1
            stats.n_planes = max(stats.n_planes, n_planes)
            tw = time.perf_counter()
            downloader.put(bi, decoded)
            stats.writer_stall_s += time.perf_counter() - tw
        downloader.join()
        writer.join()
    finally:
        reader.close()
        downloader.shutdown()
        writer.shutdown()
    stats.writer_busy_s = writer.busy_s
    if progress:
        print()
    stats.wall_s = time.perf_counter() - t0
    return stats
