#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (picsong_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from picsong_tpu_torch/csrc with nvcc (one
compiler per source, in parallel), holds each kernel equal to its plain
PyTorch version on the card, holds the port's codestreams and picked
codeblocks to the NumPy oracle's SHA-256 digests recorded in
picsong_tpu_torch/tools/goldens.py (tests/test_torch_goldens.py
regenerates them from the oracle; the inputs' digests are checked first),
and drives each of the port's paths through the CLI, reading the
kernels' launch counts (by coding mode) around each path. Nothing of JAX
or of the JAX package `picsong_tpu` is imported:
- the transform kernels X2 and X4 (`transform/dwt_cuda.py`, `dwt_phase`)
  against their plain versions, byte-equal (codeblocks, maximum,
  samples) in every case of DWT_CASES: 5/3 and 9/7 at qs 1, 0.5 and 0.7,
  wl 1-5, gray 8/12/16-bit signed and unsigned, RGB RCT and ICT at
  2048x2560, 1920x1088, a (8, 1088, 1920) and a (4, 3, 2048, 4096) batch,
  8192x8192, 1984x1088 at 6 levels (bands 31 and 62 words wide); X2 also
  on a view whose first sample is not 16-byte aligned, X4 on codeblocks
  whose first word is not (DWT_OFFSET: their scalar-load variants); then
  their times and the torch ops' at DWT_TIMED, and X2's and X4's device
  time by level at the first three (`tools/kernel_ab.py` level_split);
- gray lossless 5/3, 2048x2048 at 5 wavelet levels, neutral and trained
  LUTs (the main path; then every layer of it is timed);
- the codestream pack and unpack X3 (`assembly/pack.py`, `pack_phase`,
  `pack_check`): the kernels' codestream (with a header, with the filler,
  with the payload given) and their unpack of it byte-equal to the plain
  version on random and edge batches (N = 0 and 1, all empty, all raw
  copies, mixed sizes, N not a multiple of the kernels' tile, payloads
  starting at every residue of a 16-byte chunk; the unpack also from
  views 1..7 shorts past a 16-byte boundary), on the main path's
  streams, the 1080p video batch's and 8192^2's, timed at those three
  (kernels, their device time in a CUDA graph, plain, bound);
- the two probe kernels against their plain versions on the probes' own
  inputs, seed 1, edge inputs and views one word off 16-byte alignment,
  then the probe entry points;
- gray lossy 9/7, 2048x2048 at 3 levels, qs 1 (BASELINE config 2),
  neutral and trained lossy LUTs, plus a 512x512 byte check against the
  oracle's codestream and decoded samples;
- planar RGB 2048x2560 (the reference's image workload), lossless RCT and
  lossy ICT;
- 16-bit gray lossless, 2048x2048;
- gray lossless 2048x2048 wl=5 with three coding passes (-cp 3) and with
  complexity scalability (-k 5, the JAX bench's cs_k5_2048), neutral and
  trained LUTs, and gray lossy 2048x2048 wl=3 -k 5 with the trained lossy
  LUT, after random batches and a 512x512 wl=1 byte check against the
  oracle in both modes;
- 8192x8192 wl=5 (16384 codeblocks, a size that fills the card) in all
  three modes: an encode -> decode round trip of the kernels equal to
  the input blocks, 64 picked blocks equal to the plain coder, times;
- video through the CLI (-video 1, `video_phase`): 1920x1080 gray, 100
  frames, batch 8, with the neutral and the trained video LUTs, and
  4096x2048 planar RGB, 16 frames, batch 4, all lossless wl=5: round
  trips bit-exact, every frame's codestream equal to TorchCodec.encode
  of the frame, one BPC launch per component and batch, the kernels on
  64 picked blocks of a batch equal to the plain coder, the kernels'
  time at the batch's shape, the engine's stage times and, from
  torch.profiler, the card's busy time over one 1080p encode;
- the distribution layer (`sharded_phase`), every shard on the card:
  `ShardedCodec` at 2048x2048 wl=5 lossless on 2, 3 and 4 shards, lossy
  2048x2048 wl=3 and RGB 2048x2560 lossy on 2, 16-bit lossy on 3,
  1920x1080 on 4 (uneven rows) and two plans that gather the deep levels
  on 4, each codestream equal to the unsharded card codestream and each
  decode to the unsharded decode, one BPC launch per codeblock shard and
  component, one launch of X2's and of X4's shard mode a shard and level
  and no torch-op lifting, every shard-mode call byte-equal to its plain
  version (also from inputs off 16-byte alignment); device encode /
  decode and CLI round trips unsharded and on
  2 and 4 shards; the CLI's -sharded 2 round trip; 1080p video (24
  frames) with devices=2 against devices=1; two multi-host processes in
  a gloo group on the card (this script with --multihost-worker), the
  merged files equal to the single-host ones;
- the quality tools (`quality_phase`): every row of
  `tools/quality_report.py`'s report (QUALITY.md's tables: 512x512
  natural, noisy and edges lossless wl=5 with the neutral and trained
  LUTs, the natural image lossy over qs with the trained lossy LUT, and
  2048x2048 natural lossless and lossy), one BPC encode and one decode
  launch a row, held to the recorded bytes (QUALITY.md's lossless ones,
  the oracle's lossy bytes and PSNR to two decimals) where the image's
  digest matches, else ("input differs") to the port's own CPU row; then
  `tools/lut_eval.py` on luts/trained_lossless at 512x512, its bpp equal
  to the report's rows; the kernels against their plain versions and
  timed at the rows' shapes;
after the main path's timings, its device busy share (`busy_phase`):
`obs.trace.device_trace` over one 2048^2 TorchCodec encode + decode and
over one CLI round trip, the card's kernel and copy spans against the
profiled wall and the unprofiled median, the trace naming the codec's
stages;
on each path after the main one it also holds the BPC kernels equal to
their plain versions on every component's codeblocks, at the path's
n_planes and with the component's LUT; on the lossy ones it holds the
card's quantized codeblocks (X2) and decoded samples (X4) equal to the
plain version's on the host, and the CLI's decoded file equal to those
samples. Then
it times the device halves and CLI round trips of the paths (the two
cli.main calls alone) and each kernel variant against its plain version.
The probes' times stand beside the launch floor: a one-element torch op
timed the same way; their device times (a CUDA graph of 20 launches,
`kernel_ab.graph_ms`) beside the graph floor, that op's in the same
kind of graph. Every comparison is exact except the lossy PSNR
floors, which are stated where they are checked. The main path's layers
include the device pack and unpack of the codestream (assembly/pack.py):
only the packed bytes cross PCIe. Every CLI round trip must launch X2,
X4, X3's pack and unpack and its mode's BPC kernels (counts reset before
it, read after); every video and sharded workload one X3 pack a BPC
encode launch and one unpack a decode launch. The
kernels line's launches are the cp2 kernels', X2/X4's and X3's on the
2048^2 CLI round trips (the main path) and each other mode's on its own
2048^2 round trips; the cp2 entries add, under
"video", each video workload's own launches (one CLI encode or decode,
counts reset just before it) beside the kernels' time and bound at that
workload's batch shape, under "sharded" each sharded workload's
launches (counts reset just before its encode) beside the kernels' time
and bound at the shape of its first shard's launch (X2 / X4: one image's
shard-mode launches and their times beside X2's bound on the image), and
under "quality"
the quality report's rows' launches at 512^2 and at 2048^2 (counts reset
just before each row and read after it, summed by size) and lut_eval's,
beside the kernels' time and bound
at the natural image's lossless launch of that size.

Exits non-zero, printing no result, when there is no CUDA device or any
check fails. Otherwise its last three lines are a JSON object with each
kernel's launches, error, times and bound (the larger of its bytes over
3.35 TB/s and its operations over 16.7 Tops/s int32 or 67 TFLOP/s
float32: bpc_cuda.bound_ms, dwt_cuda.bound_ms, pack.bound_ms,
probe.bound_ms, probe2.bound_ms; X2/X4 also at each DWT_TIMED shape, X3
at its three timed shapes), the card's name
and power limit, then
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

SIZE = 2048
LEVELS = 5
ITERS = 10
PLAIN_ITERS = 1               # the plain BPC coder takes seconds a call
KERNEL_BATCH = 20             # back-to-back launches per kernel timing
LOSSY_LEVELS = 3              # BASELINE config 2
RGB_W, RGB_H = 2048, 2560     # the reference's image workload
PROBE_CALLS = 200
K = 5.0                       # the JAX bench's cs_k5_2048
BIG = 8192                    # 16384 codeblocks at wl=5: fills the card
BIG_PICKS = 64                # blocks of the 8192^2 plane held to plain


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    _require(proc.returncode == 0, f"{' '.join(cmd)} exited {proc.returncode}")
    return proc.stdout.strip()


def psnr(a, b, peak: float = 255.0) -> float:
    import numpy as np
    err = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(10 * np.log10(peak ** 2 / max(float(np.mean(err * err)),
                                                 1e-12)))


def device_ms(fn, iters=ITERS, warm=2, per=1):
    """CUDA-event times of `fn`; with `per` > 1, of `per` back-to-back
    calls divided by `per`, which keeps the wrapper's host time out of a
    kernel's time."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / per)
    return out


def host_ms(fn, iters=ITERS, warm=1):
    """Host-clock times of `fn`, each between two synchronisations."""
    import torch
    for _ in range(warm):
        fn()
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def kernel_ms(fn, iters=5):
    """One kernel launch's time: the median over `iters` of KERNEL_BATCH
    back-to-back launches."""
    return statistics.median(device_ms(fn, iters=iters, warm=1,
                                       per=KERNEL_BATCH))


# the DWT phase's cases: (label, height, width, frames (0: an image), RGB,
# lossy, qs, levels, bits, signed). 16-bit lossy at qs 1 is where a
# one-ulp drift flips a truncation (coefficients reach ~1e5); 512^2 wl=5
# and 2048^2 wl=5 end on planes smaller than a kernel tile; 1920x1088 on
# planes that are not multiples of a tile.
DWT_CASES = (
    *((f"2048^2 5/3 wl={wl}", 2048, 2048, 0, False, False, 1.0, wl, 8,
       False) for wl in (1, 2, 3, 4, 5)),
    *((f"2048^2 9/7 qs {qs} wl={wl}", 2048, 2048, 0, False, True, qs, wl, 8,
       False) for qs, wl in ((1.0, 3), (0.5, 5), (0.7, 4), (1.0, 1))),
    ("512^2 5/3 wl=5", 512, 512, 0, False, False, 1.0, 5, 8, False),
    ("512^2 9/7 qs 1 wl=5", 512, 512, 0, False, True, 1.0, 5, 8, False),
    ("2048^2 12-bit 5/3 wl=5", 2048, 2048, 0, False, False, 1.0, 5, 12,
     False),
    ("2048^2 12-bit signed 9/7 qs 1 wl=3", 2048, 2048, 0, False, True, 1.0,
     3, 12, True),
    ("2048^2 16-bit 9/7 qs 1 wl=5", 2048, 2048, 0, False, True, 1.0, 5, 16,
     False),
    ("2048^2 16-bit 9/7 qs 0.7 wl=2", 2048, 2048, 0, False, True, 0.7, 2,
     16, False),
    ("2048^2 16-bit signed 5/3 wl=5", 2048, 2048, 0, False, False, 1.0, 5,
     16, True),
    ("2048^2 8-bit signed 9/7 qs 0.5 wl=2", 2048, 2048, 0, False, True, 0.5,
     2, 8, True),
    ("RGB 2048x2560 RCT wl=5", 2560, 2048, 0, True, False, 1.0, 5, 8, False),
    ("RGB 2048x2560 ICT qs 1 wl=5", 2560, 2048, 0, True, True, 1.0, 5, 8,
     False),
    ("RGB 2048x2560 ICT qs 0.7 wl=3", 2560, 2048, 0, True, True, 0.7, 3, 8,
     False),
    ("1920x1088 5/3 wl=5", 1088, 1920, 0, False, False, 1.0, 5, 8, False),
    ("1920x1088 9/7 qs 1 wl=5", 1088, 1920, 0, False, True, 1.0, 5, 8,
     False),
    ("(8, 1088, 1920) 5/3 wl=5", 1088, 1920, 8, False, False, 1.0, 5, 8,
     False),
    ("(4, 3, 2048, 4096) RCT wl=5", 2048, 4096, 4, True, False, 1.0, 5, 8,
     False),
    ("(4, 3, 2048, 4096) ICT qs 1 wl=5", 2048, 4096, 4, True, True, 1.0, 5,
     8, False),
    ("8192^2 5/3 wl=5", 8192, 8192, 0, False, False, 1.0, 5, 8, False),
    ("8192^2 9/7 qs 1 wl=5", 8192, 8192, 0, False, True, 1.0, 5, 8, False),
    # bands 31 and 62 wide at levels 5 and 4: X2 stores and X4 loads
    # them a word at a time
    ("1984x1088 9/7 qs 1 wl=6", 1088, 1984, 0, False, True, 1.0, 6, 8,
     False),
)
# X2 on views of a case's samples, X4 on views of its codeblocks, whose
# first sample or word is not 16-byte aligned (their scalar-load
# variants): (case label, values skipped)
DWT_OFFSET = (("2048^2 16-bit 9/7 qs 1 wl=5", 1),)
# the shapes whose X2/X4 times the phase reports (case labels), the first
# the main path's; X2's and X4's per-level split at the first three
DWT_TIMED = ("2048^2 5/3 wl=5", "(8, 1088, 1920) 5/3 wl=5",
             "8192^2 5/3 wl=5", "RGB 2048x2560 ICT qs 1 wl=5")


def offset_views(tensors, skip: int):
    """Contiguous copies of `tensors`, each `skip` values into a buffer of
    its own on its device (off 16-byte alignment for skip 1-3 words)."""
    import torch
    views = []
    for t in tensors:
        buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
        buf[skip:skip + t.numel()] = t.reshape(-1)
        views.append(buf[skip:skip + t.numel()].view(t.shape))
    return views


def bit_diff(a, b) -> int:
    """The largest difference of two tensors' values, float32 by their
    bits (0: byte-equal)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return 1 << 40
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def dwt_phase(dev, tag: str) -> dict:
    """X2 and X4 (`transform/dwt_cuda.py`) against their plain versions on
    the card in every case of DWT_CASES: the kernels' codeblocks, maximum
    and samples byte-equal to the torch ops' on the same inputs (X4 on the
    kernels' codeblocks), lossless samples equal to the input. Then the
    kernels' and the torch ops' times at DWT_TIMED. Returns the max abs
    errors and the times by label."""
    import numpy as np
    import torch

    from picsong_tpu_torch.core.header import CodecConfig
    from picsong_tpu_torch.tools import goldens, kernel_ab
    from picsong_tpu_torch.transform import dwt_cuda

    started = time.perf_counter()
    err = {"forward": 0, "reverse": 0}
    cases, made = {}, {}

    def diff(a, b) -> int:
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    for label, h, w, frames, rgb, lossy, qs, wl, bits, signed in DWT_CASES:
        cfg = CodecConfig(width=w, height=h, wavelet_levels=wl,
                          is_lossy=lossy, qs=qs, is_rgb=rgb,
                          components=3 if rgb else 1, bit_depth=bits,
                          bps=bits, is_signed=signed)
        peak = (1 << bits) - 1
        n = max(frames, 1) * (3 if rgb else 1)
        if (h, w, n, peak) not in made:
            made[(h, w, n, peak)] = np.stack([
                goldens.make_image(h, seed=11 + k, width=w, peak=peak)
                for k in range(n)])
        planes = made[(h, w, n, peak)]
        if signed:
            planes = (planes.astype(np.int32) - (peak + 1) // 2).astype(
                np.int8 if bits <= 8 else np.int16)
        planes = torch.from_numpy(planes).to(dev).reshape(
            *((frames,) if frames else ()), *((3,) if rgb else ()), h, w)
        samples = list(planes.unbind(-3)) if rgb else [planes]
        before = dwt_cuda.FORWARD_LAUNCHES
        blocks, top = dwt_cuda.forward(samples, cfg)
        want, want_top = dwt_cuda.forward_plain(samples, cfg)
        torch.cuda.synchronize()
        _require(dwt_cuda.FORWARD_LAUNCHES == before + 1,
                 f"dwt {label}: X2 launched once")
        e = max([diff(b, p) for b, p in zip(blocks, want)]
                + [diff(top, want_top)])
        err["forward"] = max(err["forward"], e)
        _require(e == 0, f"dwt {label}: X2 kernel == plain (codeblocks, "
                 f"maximum), max abs err {e}")
        back = dwt_cuda.reverse(blocks, cfg)
        back_p = dwt_cuda.reverse_plain(blocks, cfg)
        torch.cuda.synchronize()
        e = max(diff(b, p) for b, p in zip(back, back_p))
        err["reverse"] = max(err["reverse"], e)
        _require(e == 0, f"dwt {label}: X4 kernel == plain (samples), max "
                 f"abs err {e}")
        if not lossy:
            _require(all(torch.equal(b, s) for b, s in zip(back, samples)),
                     f"dwt {label}: lossless X4(X2(samples)) == samples")
        cases[label] = (cfg, samples, blocks)
    for label, skip in DWT_OFFSET:
        cfg, samples, blocks = cases[label]
        views = offset_views(samples, skip)
        _require(not dwt_cuda.vector_loads(views),
                 f"dwt {label} offset by {skip}: a scalar-load view")
        before = dwt_cuda.FORWARD_LAUNCHES
        blocks, top = dwt_cuda.forward(views, cfg)
        want, want_top = dwt_cuda.forward_plain(views, cfg)
        torch.cuda.synchronize()
        _require(dwt_cuda.FORWARD_LAUNCHES == before + 1,
                 f"dwt {label} offset by {skip}: X2 launched once")
        e = max([diff(b, p) for b, p in zip(blocks, want)]
                + [diff(top, want_top)])
        err["forward"] = max(err["forward"], e)
        _require(e == 0, f"dwt {label} offset by {skip}: X2 kernel == plain "
                 f"(codeblocks, maximum), max abs err {e}")
        views = offset_views(blocks, skip)
        _require(not dwt_cuda.vector_block_loads(views),
                 f"dwt {label} codeblocks offset by {skip}: a word-load view")
        before = dwt_cuda.REVERSE_LAUNCHES
        back = dwt_cuda.reverse(views, cfg)
        back_p = dwt_cuda.reverse_plain(views, cfg)
        torch.cuda.synchronize()
        _require(dwt_cuda.REVERSE_LAUNCHES == before + 1,
                 f"dwt {label} codeblocks offset by {skip}: X4 launched once")
        e = max(diff(b, p) for b, p in zip(back, back_p))
        err["reverse"] = max(err["reverse"], e)
        _require(e == 0, f"dwt {label} codeblocks offset by {skip}: X4 "
                 f"kernel == plain (samples), max abs err {e}")
    print(f"{tag} DWT phase: X2 and X4 byte-equal to their plain versions "
          f"in {len(DWT_CASES)} cases and on {len(DWT_OFFSET)} "
          f"16-byte-misaligned view(s) each (max abs err forward "
          f"{err['forward']}, reverse {err['reverse']}), lossless round "
          f"trips exact; {time.perf_counter() - started:.1f} s")
    times = {}
    for label in DWT_TIMED:
        cfg, samples, blocks = cases[label]
        bound, by = dwt_cuda.bound_ms(samples, cfg)
        t = times[label] = {
            "forward_ms": kernel_ms(lambda: dwt_cuda.forward(samples, cfg)),
            "reverse_ms": kernel_ms(lambda: dwt_cuda.reverse(blocks, cfg)),
            "forward_device_ms": kernel_ab.graph_ms(
                lambda: dwt_cuda.forward(samples, cfg)),
            "reverse_device_ms": kernel_ab.graph_ms(
                lambda: dwt_cuda.reverse(blocks, cfg)),
            "forward_plain_ms": statistics.median(device_ms(
                lambda: dwt_cuda.forward_plain(samples, cfg), iters=3,
                warm=1)),
            "reverse_plain_ms": statistics.median(device_ms(
                lambda: dwt_cuda.reverse_plain(blocks, cfg), iters=3,
                warm=1)),
            "bound_ms": bound, "bound_by": by}
        print(f"{tag} dwt {label}: X2 {t['forward_ms']:.4f} ms, X4 "
              f"{t['reverse_ms']:.4f} ms ({KERNEL_BATCH} back-to-back calls); "
              f"the kernels' device time {t['forward_device_ms']:.4f} / "
              f"{t['reverse_device_ms']:.4f} ms a call (CUDA graph); "
              f"plain {t['forward_plain_ms']:.4f} / "
              f"{t['reverse_plain_ms']:.4f} ms; bound {bound:.5f} ms ({by}), "
              f"share {bound / t['forward_ms']:.4f} / "
              f"{bound / t['reverse_ms']:.4f}")
    # X2's and X4's device time by level: wl = 1 .. 5 on the same planes,
    # 5/3 and 9/7 qs 1, the differences (tools/kernel_ab.py level_split)
    split = {"forward": {}, "reverse": {}}
    for label in DWT_TIMED[:3]:
        _, samples, _ = cases[label]
        for d, name in (("forward", "X2"), ("reverse", "X4")):
            for lossy in (False, True):
                wavelet = "9/7 qs 1" if lossy else "5/3"
                levels = split[d][(label, wavelet)] = kernel_ab.level_split(
                    dwt_cuda, samples[0], lossy, reverse=d == "reverse")
                print(f"{tag} dwt {label}: {name} {wavelet} by level (device "
                      f"ms, levels 0..{len(levels) - 1}): "
                      + " / ".join(f"{v:.4f}" for v in levels)
                      + f" = {sum(levels):.4f}")
    print(f"{tag} DWT phase done in {time.perf_counter() - started:.1f} s")
    return {"err": err, "times": times, "split": split}


def pack_results() -> dict:
    """The pack phase's record: max abs errors of the X3 kernels against
    their plain version, and their times by shape label."""
    return {"err": {"pack": 0, "unpack": 0}, "cases": 0, "times": {}}


def pack_check(tag: str, label: str, streams, sizes, header, res: dict,
               timed: bool = False, views: bool = False) -> None:
    """X3 (`assembly/pack.py`) on one batch of streams on the card: the
    kernels' codestream (with `header`, with the filler, with the payload
    given) and their unpack of it (streams and sizes) byte-equal to the
    plain version on the same card tensors; the unpack equal to the
    streams and sizes packed. With `views`, also the unpack of the
    codestream held in views 1..7 shorts past a 16-byte boundary (as
    `join_frames` and the sharded uploads may hand it over). With
    `timed`: the kernels' time over
    KERNEL_BATCH back-to-back calls (payload given, so no read) and their
    device time in a CUDA graph (`kernel_ab.graph_ms`), the plain version's
    (median of 3), the pack with its one read on the host clock, and the
    bound, into res["times"][label]."""
    import torch

    from picsong_tpu_torch.assembly import pack
    from picsong_tpu_torch.tools import kernel_ab

    def diff(a, b) -> int:
        _require(a.shape == b.shape, f"X3 {label}: shapes {tuple(a.shape)} "
                 f"and {tuple(b.shape)}")
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    n = streams.shape[0]
    payload = int(sizes.long().sum()) - n
    for h, p in ((header, None), (None, None), (header, payload)):
        got = pack.pack_streams(streams, sizes, h, payload=p)
        e = diff(got, pack.pack_streams_plain(streams, sizes, h, p))
        res["err"]["pack"] = max(res["err"]["pack"], e)
        _require(e == 0, f"X3 {label}: pack kernel == plain (header "
                 f"{h is not None}, payload given {p is not None}), max abs "
                 f"err {e}")
    back = pack.unpack_streams(got, n, payload)
    want = pack.unpack_streams_plain(got, n, payload)
    torch.cuda.synchronize()
    e = max(diff(a, b) for a, b in zip(back, want))
    res["err"]["unpack"] = max(res["err"]["unpack"], e)
    _require(e == 0, f"X3 {label}: unpack kernel == plain, max abs err {e}")
    _require(torch.equal(back[0], streams) and torch.equal(back[1], sizes),
             f"X3 {label}: unpack(pack(streams)) == streams, sizes")
    for k in range(1, 8) if views else ():
        held = torch.empty(got.numel() + 8, dtype=torch.int16,
                           device=got.device)[k:k + got.numel()]
        held.copy_(got)
        _require(held.data_ptr() % 16 == 2 * k, f"X3 {label}: a view {k} "
                 "shorts past a 16-byte boundary")
        back = pack.unpack_streams(held, n, payload)
        want = pack.unpack_streams_plain(held, n, payload)
        torch.cuda.synchronize()
        e = max(diff(a, b) for a, b in zip(back, want))
        res["err"]["unpack"] = max(res["err"]["unpack"], e)
        _require(e == 0 and torch.equal(back[0], streams),
                 f"X3 {label}: unpack of a view {k} shorts past a 16-byte "
                 f"boundary == plain, max abs err {e}")
    res["cases"] += 1
    if not timed:
        return

    def do_pack():
        return pack.pack_streams(streams, sizes, header, payload=payload)

    def do_unpack():
        return pack.unpack_streams(got, n, payload)

    bound = pack.bound_ms(n, payload)
    t = res["times"][label] = {"codeblocks": n, "payload": payload}
    for d, fn, plain in (
            ("pack", do_pack, lambda: pack.pack_streams_plain(
                streams, sizes, header, payload)),
            ("unpack", do_unpack, lambda: pack.unpack_streams_plain(
                got, n, payload))):
        t[d] = {"ms": kernel_ms(fn), "device_ms": kernel_ab.graph_ms(fn),
                "plain_ms": statistics.median(device_ms(plain, iters=3,
                                                        warm=1)),
                "bound_ms": bound[d][0], "bound_by": bound[d][1]}
    t["pack"]["one_read_host_ms"] = statistics.median(host_ms(
        lambda: pack.pack_streams(streams, sizes, header)))
    print(f"{tag} X3 {label}: {n} codeblocks, {payload} payload words; "
          + "; ".join(f"{d} kernels {v['ms']:.4f} ms a call "
                      f"({KERNEL_BATCH} back to back), device "
                      f"{v['device_ms']:.4f} ms (CUDA graph), plain "
                      f"{v['plain_ms']:.4f} "
                      f"ms, bound {v['bound_ms']:.5f} ms ({v['bound_by']}), "
                      f"share {v['bound_ms'] / v['ms']:.4f}"
                      for d, v in t.items() if d in ("pack", "unpack"))
          + f"; pack with its one read {t['pack']['one_read_host_ms']:.4f} "
          "ms (host clock)")


def pack_phase(dev, tag: str, res: dict) -> None:
    """X3 against its plain version on random and edge batches: N = 0 and
    1, all empty blocks, all raw copies (16-bit words up to 0xFFFF), mixed
    sizes with both ends, a batch that is not a multiple of the tile of 8
    codeblocks, the alignments batch (`goldens.aligned_counts`); the mixed
    and alignments batches also unpacked from views at every 2-byte offset
    mod 16; the main path, the video batch and 8192^2 are checked where
    their streams are made (phases 5, 14, 13)."""
    import numpy as np
    import torch

    from picsong_tpu_torch.core.header import CodecConfig, pack_header
    from picsong_tpu_torch.tools import goldens

    started = time.perf_counter()
    header = pack_header(CodecConfig(width=64, height=64))
    for seed, (kind, n) in enumerate((("empty", 0), ("mixed", 1),
                                      ("empty", 9), ("raw", 5),
                                      ("mixed", 1500), ("mixed", 4097),
                                      ("alignments", 304))):
        rng = np.random.default_rng(40 + seed)
        sizes = {"empty": np.ones(n), "raw": np.full(n, 4096),
                 "mixed": rng.integers(1, 4097, size=n),
                 "alignments": np.asarray(goldens.aligned_counts()) + 1,
                 }[kind].astype(np.int32)
        if kind == "mixed":
            sizes[:3] = (1, 4096, 2)[:n]
        streams = np.full((n, 4096), -1, dtype=np.int32)
        keep = np.arange(4096)[None, :] < sizes[:, None]
        streams[keep] = rng.integers(0, 1 << 16, size=int(sizes.sum()),
                                     dtype=np.int32)
        streams[:, 0] = np.where(sizes == 1, 32,
                                 rng.integers(0, 16, size=n))
        pack_check(tag, f"{kind} N={n}", torch.from_numpy(streams).to(dev),
                   torch.from_numpy(sizes).to(dev), header, res,
                   views=kind in ("mixed", "alignments"))
    print(f"{tag} X3 pack phase: {res['cases']} random and edge batches "
          f"byte-equal to the plain version both ways (max abs err pack "
          f"{res['err']['pack']}, unpack {res['err']['unpack']}); "
          f"{time.perf_counter() - started:.1f} s")


# the video workloads: (name, width, height, frames, batch, RGB, LUT
# folders); the first folder's run is also timed through the engine's API
VIDEO = (
    # the README's video example and BASELINE config 4
    ("1080p gray", 1920, 1080, 100, 8, False,
     ("neutral", "trained_video_lossless")),
    # the reference's video workload (4096x2048 RGB), at 16 of its frames
    ("4096x2048 RGB", 4096, 2048, 16, 4, True, ("trained_video_lossless",)),
)


def video_phase(dev, tag: str, err: dict, x3: dict) -> dict:
    """Each VIDEO workload, lossless wl=LEVELS, through `cli.main -video 1`:
    inputs from `goldens.make_frame` (a seed, integer arithmetic); for
    each LUT folder, one BPC encode and one decode launch per component
    and batch (counts reset before each CLI call and read after it; the
    first folder's counts are the workload's launches); the decoded file
    equal to the input; every
    frame's codestream equal to `TorchCodec.encode` of that frame; one X3
    pack a BPC encode launch and one unpack a decode launch. With
    the first folder: the kernels on the first batch's codeblocks
    (component 0, B * ncb blocks) held to their plain versions on
    BIG_PICKS blocks spread over the batch (max errors into `err`), their
    time per launch over KERNEL_BATCH back-to-back launches and their
    bound; two encode -> decode runs through the engine's API with its
    stage times; on the first workload, one encode under torch.profiler
    for the card's busy time, and X3 (`pack_check`) on the first batch's
    streams, timed into `x3`. Returns the numbers by workload."""
    import numpy as np
    import torch

    from picsong_tpu_torch.core.header import unpack_header
    from picsong_tpu_torch.core.image_io import (mirror_pad, read_codestream,
                                                 read_header_shorts,
                                                 read_raw_frame, read_sizes)
    from picsong_tpu_torch.assembly import pack
    from picsong_tpu_torch.engine import cli, video
    from picsong_tpu_torch.engine.batch import BatchCodec
    from picsong_tpu_torch.engine.pipeline import TorchCodec
    from picsong_tpu_torch.entropy import bpc, bpc_cuda
    from picsong_tpu_torch.obs.trace import busy_ms
    from picsong_tpu_torch.tools import goldens

    repo = os.path.dirname(os.path.abspath(__file__))

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    def stats_line(what, st, n):
        print(f"{tag} {what}: {st.frames} frames in {st.wall_s:.4f} s = "
              f"{n / st.wall_s:.2f} frames/s (compute {st.compute_s:.4f} s = "
              f"{n / st.compute_s:.2f} frames/s; download {st.download_s:.4f}"
              f" s, reader stall {st.reader_stall_s:.4f} s, writer stall "
              f"{st.writer_stall_s:.4f} s, writer busy {st.writer_busy_s:.4f}"
              f" s; {st.batches} batches of {st.batch}, n_planes "
              f"{st.n_planes})")

    out = {}
    for name, w, h, n, batch, rgb, folders in VIDEO:
        n_comp = 3 if rgb else 1
        n_batches = -(-n // batch)
        res = out[name] = {"frames": n, "batch": batch,
                           "batches": n_batches}
        tmp = tempfile.TemporaryDirectory()
        raw = os.path.join(tmp.name, "in.raw")
        with open(raw, "wb") as f:
            for i in range(n):
                for c in range(n_comp):
                    f.write(goldens.make_frame(h, w, i, 5 + 7 * c).tobytes())
        geo = ["-xSize", str(w), "-ySize", str(h), "-isRGB", str(int(rgb))]
        for folder in folders:
            lut = (folder if folder == "neutral"
                   else os.path.join(repo, "luts", folder))
            label = f"video {name} {folder}"
            enc = os.path.join(tmp.name, f"{folder}.enc")
            dec = os.path.join(tmp.name, f"{folder}.raw")
            run = {}
            for d, argv in (("encode", ["-i", raw, "-o", enc, *geo, "-wl",
                                        str(LEVELS), "-frames", str(n)]),
                            ("decode", ["-i", enc, "-o", dec])):
                bpc_cuda.reset_launches()
                pack.reset_launches()
                t = time.perf_counter()
                _require(cli.main(["-cd", "0" if d == "encode" else "1",
                                   *argv, "-video", "1", "-numberOfStreams",
                                   str(batch), "-LUTFolder", lut,
                                   "--device", str(dev)]) == 0,
                         f"{label}: CLI {d}")
                run[d] = (time.perf_counter() - t) * 1e3
                counts = (bpc_cuda.ENCODE_LAUNCHES if d == "encode"
                          else bpc_cuda.DECODE_LAUNCHES)
                want = dict.fromkeys(counts, 0)
                want["cp2"] = n_batches * n_comp
                _require(counts == want, f"{label}: {d} launches {counts}, "
                         "one per component and batch")
                x3_d = (pack.PACK_LAUNCHES if d == "encode"
                        else pack.UNPACK_LAUNCHES)
                _require(x3_d == n_batches * n_comp,
                         f"{label}: X3 {'un' if d == 'decode' else ''}pack "
                         f"launches {x3_d}, one per component and batch")
                res.setdefault("launches", {}).setdefault(d, counts["cp2"])
                res.setdefault("x3_launches", {}).setdefault(
                    "pack" if d == "encode" else "unpack", x3_d)
            _require(read(dec) == read(raw),
                     f"{label}: CLI round trip bit-exact")
            cfg = unpack_header(read_header_shorts(enc))
            luts, params = cli._load_luts(lut, LEVELS, 2, 0.0)
            codec = TorchCodec(cfg, luts, params, dev)
            sizes = read_sizes(enc)
            offsets = np.concatenate([[0], np.cumsum(sizes)])
            for i in range(n):
                planes = [read_raw_frame(raw, w, h, i * n_comp + c)
                          for c in range(n_comp)]
                want = codec.encode(planes if rgb else planes[0])
                for c in range(n_comp):
                    k = i * n_comp + c
                    _require(np.array_equal(read_codestream(
                        enc, int(offsets[k]), int(sizes[k])), want[c]),
                        f"{label}: frame {i} component {c} codestream == "
                        "TorchCodec.encode of the frame")
            print(f"{tag} {label}: {n} frames, batch {batch}, CLI encode "
                  f"{run['encode']:.4f} ms, decode {run['decode']:.4f} ms "
                  f"({os.path.getsize(enc)} B); round trip bit-exact; every "
                  "frame's codestream == TorchCodec.encode of the frame; "
                  f"BPC launches {n_batches * n_comp} per direction "
                  f"({n_comp} per batch)")
            res[folder] = {"cli_encode_ms": run["encode"],
                           "cli_decode_ms": run["decode"],
                           "bytes": os.path.getsize(enc)}
            if folder != folders[0]:
                continue
            # the kernels at the video batch's shape: component 0 of the
            # first batch, B * ncb codeblocks
            bc = BatchCodec(cfg, luts, params, batch, dev)
            first = np.stack([np.stack([mirror_pad(read_raw_frame(
                raw, w, h, j * n_comp + c), bc.aw, bc.ah)
                for c in range(n_comp)]) for j in range(batch)])
            blocks, mx = bc.prep_batch(torch.from_numpy(
                first if rgb else first[:, 0]).to(dev))
            blocks = blocks[0]
            n_pl = bpc.planes_for_magnitude(int(mx))
            a, kw = bc._bpc_args(0), dict(bc.codec._bpc_kw, n_planes=n_pl)
            s_k, z_k = bpc_cuda.encode_blocks(blocks, *a, **kw)
            _require(torch.equal(bpc_cuda.decode_blocks(s_k, z_k, *a, **kw),
                                 blocks), f"{label}: kernels' round trip")
            idx = torch.linspace(0, blocks.shape[0] - 1, BIG_PICKS,
                                 device=dev).long()
            sub = (a[0], *(m[idx] for m in a[1:]))
            s_p, z_p = bpc.encode_blocks_plain(blocks[idx], *sub, **kw)
            e = max(int((s_p.long() - s_k[idx].long()).abs().max()),
                    int((z_p.long() - z_k[idx].long()).abs().max()))
            err["cp2"]["encode"] = max(err["cp2"]["encode"], e)
            _require(e == 0, f"{label}: {BIG_PICKS} picked blocks of a batch, "
                     f"encode kernel == plain, max err {e}")
            o_p = bpc.decode_blocks_plain(s_k[idx], z_k[idx], *sub, **kw)
            e = int((o_p.long() - blocks[idx].long()).abs().max())
            err["cp2"]["decode"] = max(err["cp2"]["decode"], e)
            _require(e == 0, f"{label}: {BIG_PICKS} picked blocks, plain "
                     "decode of the kernel's streams == input")
            if name == VIDEO[0][0]:
                pack_check(tag, f"video {name} batch of {batch}", s_k, z_k,
                           None, x3, timed=True)
            bound, by = bpc_cuda.bound_ms(blocks)
            k_enc = kernel_ms(lambda: bpc_cuda.encode_blocks(blocks, *a, **kw))
            k_dec = kernel_ms(lambda: bpc_cuda.decode_blocks(s_k, z_k, *a,
                                                             **kw))
            res["kernel"] = {"codeblocks": blocks.shape[0], "encode_ms": k_enc,
                             "decode_ms": k_dec, "bound_ms": bound,
                             "bound_by": by}
            print(f"{tag} {label}: {blocks.shape[0]} codeblocks a launch, "
                  f"n_planes {n_pl}; kernels' round trip == input, "
                  f"{BIG_PICKS} picked blocks byte-equal to plain; BPC encode "
                  f"kernel {k_enc:.4f} ms, decode {k_dec:.4f} ms a launch "
                  f"({KERNEL_BATCH} back to back, median of 5); bound "
                  f"{bound:.5f} ms ({by}), share {bound / k_enc:.4f} / "
                  f"{bound / k_dec:.4f}")
            del blocks, s_k, z_k, bc
            # the engine's API, twice: its stage times
            enc2 = os.path.join(tmp.name, "api.enc")
            dec2 = os.path.join(tmp.name, "api.raw")
            for r in range(2):
                st = video.encode_video(raw, enc2, cfg, luts, params, n,
                                        batch=batch, device=dev)
                stats_line(f"{label} encode_video run {r + 1}", st, n)
                _require(read(enc2) == read(enc), f"{label}: API == CLI bytes")
                res[f"encode run {r + 1}"] = st.as_dict()
                st = video.decode_video(enc2, dec2, cfg, luts, params,
                                        batch=batch, device=dev)
                stats_line(f"{label} decode_video run {r + 1}", st, n)
                _require(read(dec2) == read(raw), f"{label}: API decode")
                res[f"decode run {r + 1}"] = st.as_dict()
            if name == VIDEO[0][0]:
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    st = video.encode_video(raw, enc2, cfg, luts, params, n,
                                            batch=batch, device=dev)
                busy, n_spans = busy_ms(prof)
                wall = res["encode run 2"]["wall_s"] * 1e3
                _require(n_spans > 0, f"{label}: torch.profiler recorded "
                         "device activity")
                res["busy_ms"] = busy
                print(f"{tag} {label}: torch.profiler over one "
                      f"encode_video: device busy {busy:.4f} ms "
                      f"({n_spans} kernel and copy spans) in a profiled "
                      f"wall of {st.wall_s * 1e3:.4f} ms; busy share "
                      f"{busy / (st.wall_s * 1e3):.4f} of the profiled "
                      f"wall, {busy / wall:.4f} of run 2's unprofiled "
                      f"wall ({wall:.4f} ms)")
        tmp.cleanup()
    return out


# the sharded workloads (`sharded_phase`): shard counts of the 2048^2
# lossless main path on one card, and the frame-parallel and multi-host
# video at 1080p
SHARDS = (2, 3, 4)
UNEVEN = (1920, 1080, 4)                 # width, height, shards
SHARDED_VIDEO = (1920, 1080, 24, 8)      # width, height, frames, batch
HOSTS = 2
# the torch-op lifting of transform/dwt.py and X2/X4's plain versions
# (transform/dwt_cuda.py): none may run on a card's sharded path
PLAIN_DWT = ("lift_vertical", "lift_horizontal", "quantize_level",
             "unlift_horizontal", "unlift_vertical", "dequantize",
             "dwt_forward", "dwt_reverse")
PLAIN_DWT_CUDA = ("prep", "finish", "forward_plain", "reverse_plain",
                  "forward_shard_plain", "reverse_shard_plain")


@contextlib.contextmanager
def recording(module, names, calls: list):
    """Inside the block, each function `names` of `module` appends (name,
    args, kwargs) to `calls` before it runs."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def recorded(*args, **kwargs):
            calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
        return recorded
    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def multihost_worker(argv: list[str]) -> int:
    """One host of the multi-host run (`chip_smoke.py --multihost-worker
    RANK HOSTS PORT DIR DEVICE WIDTH HEIGHT FRAMES BATCH LEVELS`): joins
    the gloo group at 127.0.0.1:PORT, encodes and decodes its slab of
    DIR/in.raw (lossless, neutral LUT) on DEVICE, after one untimed
    round, and prints its stats as one JSON line after "MULTIHOST "."""
    rank, hosts, port, d, device = (int(argv[0]), int(argv[1]), argv[2],
                                    argv[3], argv[4])
    w, h, n, batch, levels = (int(x) for x in argv[5:10])
    sys.modules["jax"] = None
    sys.modules["picsong_tpu"] = None
    import torch.distributed as dist

    from picsong_tpu_torch.assembly import pack
    from picsong_tpu_torch.core.header import CodecConfig
    from picsong_tpu_torch.dist import multihost as mh
    from picsong_tpu_torch.engine import cli
    from picsong_tpu_torch.entropy import bpc_cuda

    cfg = CodecConfig(width=w, height=h, wavelet_levels=levels, frames=n)
    luts, params = cli._load_luts("neutral", levels, 2, 0.0)
    _require(mh.init_distributed(f"127.0.0.1:{port}", hosts, rank)
             == (rank, hosts), "process group")
    try:
        # a first, untimed round: a process's first CUDA work loads its
        # context and modules, which the single-host walls do not include
        mh.encode_video_multihost(f"{d}/in.raw", f"{d}/warm.enc", cfg, luts,
                                  params, n, batch=batch, device=device)
        mh.decode_video_multihost(f"{d}/warm.enc", f"{d}/warm.raw", cfg,
                                  luts, params, batch=batch, device=device)
        bpc_cuda.reset_launches()
        pack.reset_launches()
        enc = mh.encode_video_multihost(f"{d}/in.raw", f"{d}/mh.enc", cfg,
                                        luts, params, n, batch=batch,
                                        device=device)
        enc_launches = bpc_cuda.ENCODE_LAUNCHES["cp2"]
        dec = mh.decode_video_multihost(f"{d}/mh.enc", f"{d}/mh.raw", cfg,
                                        luts, params, batch=batch,
                                        device=device)
        print("MULTIHOST " + json.dumps({
            "rank": rank, "frames": enc.frames,
            "encode_wall_s": enc.wall_s, "decode_wall_s": dec.wall_s,
            "launches": {"encode": enc_launches,
                         "decode": bpc_cuda.DECODE_LAUNCHES["cp2"]},
            "x3_launches": {"pack": pack.PACK_LAUNCHES,
                            "unpack": pack.UNPACK_LAUNCHES}}))
    finally:
        dist.destroy_process_group()
    return 0


def shard_checks(label: str, calls) -> dict:
    """Each shard-mode call in `calls` (`recording`'s of X2's and X4's
    `forward_shard` / `reverse_shard`) again on its inputs, and on copies
    of them one value past a 16-byte boundary, == its plain version on
    the same inputs -> the max abs errors (X2, X4)."""
    import torch

    from picsong_tpu_torch.transform import dwt_cuda
    e = {"forward": 0, "reverse": 0}
    for name, args, _ in calls:
        d = "forward" if name == "forward_shard" else "reverse"
        ins, rest = args[0], args[1:6 if d == "forward" else 7]
        if d == "forward":
            want = dwt_cuda.forward_shard_plain(ins, *rest)
            views = offset_views(ins, 1)
            _require(not dwt_cuda.vector_loads(views),
                     f"{label}: X2 shard input off 16 bytes")
        else:
            want = dwt_cuda.reverse_shard_plain(ins, *rest)
            views = offset_views(ins, 1)
            _require(not dwt_cuda.vector_block_loads(views),
                     f"{label}: X4 shard bands off 16 bytes")
        for x in (ins, views):
            if d == "forward":
                (bands, top), (want_bands, want_top) = (
                    dwt_cuda.forward_shard(x, *rest), want)
                got = max([bit_diff(top, want_top)] + [
                    bit_diff(g, w) for g, w in zip(bands, want_bands)])
            else:
                got = bit_diff(dwt_cuda.reverse_shard(x, *rest), want)
            e[d] = max(e[d], got)
    torch.cuda.synchronize()
    _require(e == {"forward": 0, "reverse": 0},
             f"{label}: X2/X4 shard modes == plain at every shard and "
             f"level, aligned and not; max abs err {e}")
    return e


def shard_times(calls, planes) -> dict:
    """The shard-mode calls of one image (`recording`'s): CUDA events
    around them (medians of 5), their device time (a CUDA graph), their
    plain versions' time (median of 3), and X2's bound on the image's
    sample `planes`."""
    from picsong_tpu_torch.tools import kernel_ab
    from picsong_tpu_torch.transform import dwt_cuda
    bound, by = dwt_cuda.bound_ms(planes, calls[0][1][1])
    t = {"bound_ms": bound, "bound_by": by}
    for d, fn, plain, k in (
            ("forward", dwt_cuda.forward_shard,
             dwt_cuda.forward_shard_plain, 6),
            ("reverse", dwt_cuda.reverse_shard,
             dwt_cuda.reverse_shard_plain, 7)):
        mine = [a[:k] for n, a, _ in calls if n == f"{d}_shard"]

        def run(f, mine=mine):
            return lambda: [f(*a) for a in mine]
        t[f"{d}_ms"] = statistics.median(device_ms(run(fn), iters=5,
                                                   warm=1))
        t[f"{d}_device_ms"] = kernel_ab.graph_ms(run(fn))
        t[f"{d}_plain_ms"] = statistics.median(device_ms(
            run(plain), iters=3, warm=1))
    return t


def sharded_phase(dev, tag: str, err: dict, card: str) -> dict:
    """The distribution layer on the card (`dist/`), every shard on `dev`:
    - `ShardedCodec` at 2048^2 wl=5 lossless on 2, 3 and 4 shards, 2048^2
      wl=3 lossy and RGB 2048x2560 lossy (trained lossy LUT) on 2, 16-bit
      2048^2 wl=5 9/7 qs 1 on 3, 1920x1080 wl=5 lossless on 4 (17
      codeblock rows: 5/4/4/4), and two plans that gather the deep levels
      on 4 (256^2 wl=5 9/7 qs 0.5 from level 4, 512x256 wl=6 5/3 from
      level 5): each codestream equal to the unsharded card codestream,
      each decode to the unsharded decode (lossless: to the input), the
      BPC launches (counts reset just before the encode, read after it
      and after the decode) one per codeblock shard and component, none
      of another mode, and as many X3 packs and unpacks; X2's and X4's
      shard modes launched once a shard and level each way (all the
      components in one launch), and no torch-op lifting
      (`transform/dwt.py`) and no plain version of X2/X4 run; every
      shard-mode call of the round trip again on its inputs, and on
      copies of them off 16-byte alignment (the scalar- and word-load
      variants), byte-equal to its plain version (bands and maximum,
      rows or samples); the shard-mode calls of one image timed against
      their plain versions, with X2's bound; the BPC kernels on shard
      0's codeblocks timed, with their bound; on 2 shards, BIG_PICKS of
      them held to the plain coder;
    - device encode / decode and the CLI round trip at 2048^2 wl=5,
      unsharded and on 2 and 4 shards, in one call, beside the card's
      name and power limit;
    - the CLI's -sharded 2 round trip at 2048^2 wl=5: the unsharded CLI's
      file, a bit-exact decode, 2 BPC launches and 10 of X2's and X4's
      shard modes a direction;
    - 1080p video, SHARDED_VIDEO frames, devices=2 against devices=1
      (two turns): equal files and `_SIZE`, bit-exact decodes, one launch
      per share and batch;
    - multi-host: HOSTS processes in a gloo group on the card
      (`multihost_worker`): the merged file equal to the single-host one,
      the merged decode to the input, the `ScalingReport` efficiency
      against the single-host walls.
    Returns the kernels' sharded entries, the shard modes' entries and
    errors, and the times."""
    import numpy as np
    import torch

    from picsong_tpu_torch.assembly import pack
    from picsong_tpu_torch.core.header import CodecConfig
    from picsong_tpu_torch.core.image_io import (mirror_pad, read_pgm,
                                                 write_pgm)
    from picsong_tpu_torch.dist.multihost import ScalingReport
    from picsong_tpu_torch.dist.sharded import (ShardedCodec, placement,
                                                shares)
    from picsong_tpu_torch.engine import cli, video
    from picsong_tpu_torch.engine.batch import BatchCodec
    from picsong_tpu_torch.engine.pipeline import TorchCodec
    from picsong_tpu_torch.entropy import bpc, bpc_cuda
    from picsong_tpu_torch.tools import goldens, kernel_ab
    from picsong_tpu_torch.transform import dwt, dwt_cuda

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    def stat(samples):
        return {"median_ms": statistics.median(samples),
                "min_ms": min(samples), "max_ms": max(samples)}

    def kernels_at(label, blocks, args, kw, picks=False):
        """The cp2 kernels on these blocks: round trip (a raw copy, size
        4096, keeps 16-bit words, as in the reference: those blocks are
        held to the plain decoder of the same streams, as
        tests/test_torch_cuda.py does), optionally BIG_PICKS blocks
        against the plain coder, times and bound."""
        s_k, z_k = bpc_cuda.encode_blocks(blocks, *args, **kw)
        back = bpc_cuda.decode_blocks(s_k, z_k, *args, **kw)
        raw = z_k == 4096
        _require(torch.equal(back[~raw], blocks[~raw]),
                 f"{label}: kernels' round trip")
        if bool(raw.any()):
            idx = raw.nonzero()[:, 0]
            sub = (args[0], *(m[idx] for m in args[1:]))
            _require(torch.equal(back[idx], bpc.decode_blocks_plain(
                s_k[idx], z_k[idx], *sub, **kw)),
                f"{label}: {idx.numel()} raw copies decode as the plain "
                "decoder's")
        if picks:
            idx = torch.linspace(0, blocks.shape[0] - 1, BIG_PICKS,
                                 device=dev).long()
            sub = (args[0], *(m[idx] for m in args[1:]))
            s_p, z_p = bpc.encode_blocks_plain(blocks[idx], *sub, **kw)
            e = max(int((s_p.long() - s_k[idx].long()).abs().max()),
                    int((z_p.long() - z_k[idx].long()).abs().max()))
            err["cp2"]["encode"] = max(err["cp2"]["encode"], e)
            _require(e == 0, f"{label}: picked blocks, encode == plain")
            o_p = bpc.decode_blocks_plain(s_k[idx], z_k[idx], *sub, **kw)
            e = int((o_p.long() - blocks[idx].long()).abs().max())
            err["cp2"]["decode"] = max(err["cp2"]["decode"], e)
            _require(e == 0, f"{label}: picked blocks, plain decode == input")
        bound, by = bpc_cuda.bound_ms(blocks)
        return {"codeblocks": blocks.shape[0],
                "encode_ms": kernel_ms(
                    lambda: bpc_cuda.encode_blocks(blocks, *args, **kw)),
                "decode_ms": kernel_ms(
                    lambda: bpc_cuda.decode_blocks(s_k, z_k, *args, **kw)),
                "bound_ms": bound, "bound_by": by}

    def only_cp2(counts, want, what):
        _require(counts == dict(dict.fromkeys(counts, 0), cp2=want),
                 f"{what}: launches {counts}, want {want} of cp2 only")

    def x3_as_bpc(what):
        """One X3 pack a BPC encode launch and one unpack a decode launch
        since the counts were reset."""
        got = (pack.PACK_LAUNCHES, pack.UNPACK_LAUNCHES)
        want = (bpc_cuda.ENCODE_LAUNCHES["cp2"],
                bpc_cuda.DECODE_LAUNCHES["cp2"])
        _require(got == want, f"{what}: X3 launches {got}, want {want}")

    out = {"workloads": [], "times": {}, "dwt": [],
           "dwt_err": {"forward": 0, "reverse": 0}}
    img = goldens.make_image(SIZE)
    rgb = [goldens.make_image(RGB_H, seed=s, width=RGB_W) for s in (5, 6, 7)]
    uw, uh, un = UNEVEN
    uneven = goldens.make_frame(uh, uw, 0)
    neutral = cli._load_luts("neutral", LEVELS, 2, 0.0)
    lossy_luts = cli._load_luts("neutral", LOSSY_LEVELS, 2, 0.0)
    rgb_luts = cli._load_luts("trained", LEVELS, 2, 0.0, lossy=True)
    cfg = CodecConfig(width=SIZE, height=SIZE, wavelet_levels=LEVELS)
    jobs = [(f"{SIZE}^2 wl={LEVELS} lossless", cfg, neutral, img, n)
            for n in SHARDS]
    jobs += [
        (f"{SIZE}^2 wl={LOSSY_LEVELS} lossy", CodecConfig(
            width=SIZE, height=SIZE, wavelet_levels=LOSSY_LEVELS,
            is_lossy=True, qs=1.0), lossy_luts, img, 2),
        (f"RGB {RGB_W}x{RGB_H} wl={LEVELS} lossy trained", CodecConfig(
            width=RGB_W, height=RGB_H, wavelet_levels=LEVELS, is_rgb=True,
            components=3, is_lossy=True, qs=1.0), rgb_luts, rgb, 2),
        (f"{SIZE}^2 16-bit wl={LEVELS} lossy qs 1", CodecConfig(
            width=SIZE, height=SIZE, wavelet_levels=LEVELS, is_lossy=True,
            qs=1.0, bit_depth=16, bps=16), cli._load_luts(
                "neutral", LEVELS, 2, 0.0), goldens.make_image(
                    SIZE, peak=65535), 3),
        (f"{uw}x{uh} wl={LEVELS} lossless", CodecConfig(
            width=uw, height=uh, wavelet_levels=LEVELS), neutral, uneven,
         un),
        ("256^2 wl=5 lossy qs 0.5 (gathered from level 4)", CodecConfig(
            width=256, height=256, wavelet_levels=5, is_lossy=True, qs=0.5),
         neutral, goldens.make_image(256), 4),
        ("512x256 wl=6 lossless (gathered from level 5)", CodecConfig(
            width=512, height=256, wavelet_levels=6),
         cli._load_luts("neutral", 6, 2, 0.0),
         goldens.make_image(256, width=512), 4)]
    singles = {}
    for name, c, (luts, params), pixels, n in jobs:
        if name not in singles:
            single = TorchCodec(c, luts, params, dev)
            want = single.encode(pixels)
            singles[name] = (want, single.decode(want))
        want, back = singles[name]
        codec = ShardedCodec(c, luts, params, [dev] * n)
        n_comp = codec.n_components
        label = f"sharded {name} x{n}"
        # one shard-mode launch a shard and level, the deep-level gather's
        # levels once
        level_launches = sum(len(spans) for spans in codec._plan)
        calls, plain = [], []
        bpc_cuda.reset_launches()
        pack.reset_launches()
        dwt_cuda.reset_launches()
        with recording(dwt_cuda, ("forward_shard", "reverse_shard"), calls), \
                recording(dwt, PLAIN_DWT, plain), \
                recording(dwt_cuda, PLAIN_DWT_CUDA, plain):
            got = codec.encode(pixels)
            x2 = (dwt_cuda.FORWARD_LAUNCHES, dwt_cuda.REVERSE_LAUNCHES)
            enc = dict(bpc_cuda.ENCODE_LAUNCHES)
            got_back = codec.decode(got)
            x4 = dwt_cuda.REVERSE_LAUNCHES
            dec = dict(bpc_cuda.DECODE_LAUNCHES)
        _require(x2 == (level_launches, 0) and x4 == level_launches,
                 f"{label}: X2 / X4 launches {x2[0]} / {x4}, want "
                 f"{level_launches} each (a shard and level)")
        _require(not plain, f"{label}: torch-op lifting or a plain X2/X4 "
                 f"ran on the card: {sorted({k for k, _, _ in plain})}")
        only_cp2(enc, len(codec.blocks) * n_comp, f"{label} encode")
        only_cp2(dec, len(codec.blocks) * n_comp, f"{label} decode")
        x3_as_bpc(label)
        _require(len(got) == len(want) and all(
            np.array_equal(g, w) for g, w in zip(got, want)),
            f"{label}: codestream == the unsharded card codestream")
        planes = got_back if c.is_rgb else [got_back]
        _require(all(np.array_equal(p, q) for p, q in zip(
            planes, back if c.is_rgb else [back])),
            f"{label}: decode == the unsharded decode")
        if not c.is_lossy:
            _require(all(np.array_equal(p, q) for p, q in zip(
                planes, pixels if c.is_rgb else [pixels])),
                f"{label}: decode bit-exact")
        e = shard_checks(label, calls)
        for d in e:
            out["dwt_err"][d] = max(out["dwt_err"][d], e[d])
        up = codec.upload(pixels)
        whole = [torch.empty((codec.ah, codec.aw), dtype=up[0][0].dtype,
                             device="meta")] * n_comp
        xt = shard_times(calls, whole)
        out["dwt"].append({"workload": f"{name}, {n} shards", "shards": n,
                           "launches": level_launches, **xt})
        del calls
        blocks, tops = codec.tile_planes(up)
        s0 = codec.blocks[0][0]
        kw = dict(codec._kw, n_planes=codec._n_planes(tops))
        k = kernels_at(label, blocks[0][0], codec._bpc_args(s0, 0), kw,
                       picks=(n == 2 and not c.is_lossy))
        out["workloads"].append({
            "workload": f"{name}, {n} shards", "shards": n,
            "launches": {"encode": enc["cp2"], "decode": dec["cp2"]}, **k})
        print(f"{tag} {label} ({placement(codec.devices)}, rows "
              f"{[r1 - r0 for r0, r1 in codec.rows]}, levels by shards "
              f"{[len(sp) for sp in codec._plan]}): "
              f"{sum(g.size for g in got)} shorts == the unsharded card "
              f"codestream; decode == unsharded"
              + ("" if c.is_lossy else " == input")
              + f"; launches {enc['cp2']} / {dec['cp2']} (shards x "
              f"components); shard 0: {k['codeblocks']} codeblocks, "
              f"kernels {k['encode_ms']:.4f} / {k['decode_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.5f} ms ({k['bound_by']}); X2 / X4 "
              f"shard modes: {level_launches} launches each way, byte-"
              f"equal to plain (and off 16 bytes), one image's calls "
              f"{xt['forward_ms']:.4f} / {xt['reverse_ms']:.4f} ms, device "
              f"{xt['forward_device_ms']:.4f} / "
              f"{xt['reverse_device_ms']:.4f} ms, plain "
              f"{xt['forward_plain_ms']:.4f} / {xt['reverse_plain_ms']:.4f}"
              f" ms, bound {xt['bound_ms']:.5f} ms ({xt['bound_by']}); no "
              "torch-op lifting")

    # times at 2048^2 wl=5: unsharded, then 2 and 4 shards, in one call
    tmp = tempfile.TemporaryDirectory()
    src = os.path.join(tmp.name, "in.pgm")
    write_pgm(src, img)
    luts, params = neutral

    def cli_pair(n):
        enc = os.path.join(tmp.name, f"s{n}.enc")
        dec = os.path.join(tmp.name, f"s{n}.pgm")
        shard = ["-sharded", str(n)] if n > 1 else []
        shard += ["--device", str(dev)]
        _require(cli.main(["-cd", "0", "-i", src, "-o", enc, "-wl",
                           str(LEVELS), "-LUTFolder", "neutral", *shard])
                 == 0, f"CLI encode -sharded {n}")
        _require(cli.main(["-cd", "1", "-i", enc, "-o", dec, "-LUTFolder",
                           "neutral", *shard]) == 0,
                 f"CLI decode -sharded {n}")
        return enc, dec

    bpc_cuda.reset_launches()
    pack.reset_launches()
    dwt_cuda.reset_launches()
    enc2, dec2 = cli_pair(2)
    only_cp2(dict(bpc_cuda.ENCODE_LAUNCHES), 2, "CLI -sharded 2 encode")
    only_cp2(dict(bpc_cuda.DECODE_LAUNCHES), 2, "CLI -sharded 2 decode")
    x3_as_bpc("CLI -sharded 2")
    x24 = (dwt_cuda.FORWARD_LAUNCHES, dwt_cuda.REVERSE_LAUNCHES)
    _require(x24 == (2 * LEVELS, 2 * LEVELS),
             f"CLI -sharded 2: X2 / X4 launches {x24}, want {2 * LEVELS} each")
    enc1, _ = cli_pair(1)
    _require(read(enc2) == read(enc1) and read(enc2 + "_SIZE")
             == read(enc1 + "_SIZE"), "CLI -sharded 2 file == unsharded")
    _require(np.array_equal(read_pgm(dec2), img),
             "CLI -sharded 2 round trip bit-exact")
    out["cli_launches"] = 2
    print(f"{tag} CLI -sharded 2 {SIZE}^2 wl={LEVELS}: file == the "
          "unsharded CLI file, round trip bit-exact, BPC launches 2 / 2, "
          f"X2 / X4 shard modes {x24[0]} / {x24[1]}")
    single = TorchCodec(cfg, luts, params, dev)
    samples = [torch.from_numpy(img).to(dev)]
    coded1, n_pl = single.encode_planes(samples)
    dcoded1 = [(s_, z_, n_pl) for s_, z_ in coded1]
    t = {"unsharded": {
        "device_encode": host_ms(lambda: single.encode_planes(samples)),
        "device_decode": host_ms(lambda: single.decode_planes(dcoded1)),
        "cli_round_trip": host_ms(lambda: cli_pair(1))}}
    for n in (2, 4):
        codec = ShardedCodec(cfg, luts, params, [dev] * n)
        up = codec.upload(img)
        coded, n_pl = codec.encode_planes(up)
        dcoded = [(shards, n_pl) for shards in coded]
        t[f"{n} shards"] = {
            "device_encode": host_ms(lambda: codec.encode_planes(up)),
            "device_decode": host_ms(lambda: codec.decode_planes(dcoded)),
            "cli_round_trip": host_ms(lambda: cli_pair(n))}
    mp = SIZE * SIZE / 1e3
    for k, v in t.items():
        out["times"][k] = {m: stat(x) for m, x in v.items()}
        print(f"{tag} {SIZE}^2 wl={LEVELS} {k}: " + ", ".join(
            f"{m} median {statistics.median(x):.4f} ms (min {min(x):.4f}, "
            f"max {max(x):.4f}; {mp / statistics.median(x):.1f} MPix/s)"
            for m, x in v.items()) + f" over {ITERS} ({card})")
    tmp.cleanup()

    # 1080p video: devices=2 against devices=1, two turns
    w, h, n, batch = SHARDED_VIDEO
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    raw = os.path.join(d, "in.raw")
    with open(raw, "wb") as f:
        for i in range(n):
            f.write(goldens.make_frame(h, w, i).tobytes())
    vcfg = CodecConfig(width=w, height=h, wavelet_levels=LEVELS, frames=n)
    walls = {1: {"encode": [], "decode": []}, 2: {"encode": [], "decode": []}}
    n_batches = -(-n // batch)
    for turn in range(2):
        for devices in ((1, 2) if turn == 0 else (2, 1)):
            enc = os.path.join(d, f"v{devices}.enc")
            dec = os.path.join(d, f"v{devices}.raw")
            bpc_cuda.reset_launches()
            pack.reset_launches()
            st = video.encode_video(raw, enc, vcfg, luts, params, n,
                                    batch=batch, devices=[dev] * devices)
            only_cp2(dict(bpc_cuda.ENCODE_LAUNCHES), n_batches * devices,
                     f"video devices={devices} encode")
            sd = video.decode_video(enc, dec, vcfg, luts, params,
                                    batch=batch, devices=[dev] * devices)
            only_cp2(dict(bpc_cuda.DECODE_LAUNCHES), n_batches * devices,
                     f"video devices={devices} decode")
            x3_as_bpc(f"video devices={devices}")
            _require(read(dec) == read(raw),
                     f"video devices={devices}: decode bit-exact")
            walls[devices]["encode"].append(st.wall_s)
            walls[devices]["decode"].append(sd.wall_s)
            print(f"{tag} video {w}x{h} {n} frames batch {batch} devices="
                  f"{devices} turn {turn + 1}: encode {st.wall_s:.4f} s = "
                  f"{n / st.wall_s:.2f} frames/s (compute "
                  f"{st.compute_s:.4f} s), decode {sd.wall_s:.4f} s = "
                  f"{n / sd.wall_s:.2f} frames/s; launches "
                  f"{n_batches * devices} a direction")
    v1, v2 = (os.path.join(d, f"v{k}.enc") for k in (1, 2))
    _require(read(v1) == read(v2) and read(v1 + "_SIZE")
             == read(v2 + "_SIZE"), "video devices=2 file == devices=1")
    out["video"] = {str(k): v for k, v in walls.items()}
    def frames(count):
        """The first `count` frames, padded, on the card."""
        return torch.from_numpy(np.stack([mirror_pad(
            goldens.make_frame(h, w, i), bc.aw, bc.ah)
            for i in range(count)])).to(dev)

    share = batch // 2
    bc = BatchCodec(vcfg, luts, params, share, dev)
    (vblocks,), mx = bc.prep_batch(frames(share))
    k = kernels_at("video share", vblocks, bc._bpc_args(0),
                   dict(bc.codec._bpc_kw,
                        n_planes=bpc.planes_for_magnitude(int(mx))))
    out["workloads"].append({
        "workload": f"video {w}x{h}, {n} frames, batch {batch}, 2 devices",
        "shards": 2, "launches": {"encode": n_batches * 2,
                                  "decode": n_batches * 2}, **k})

    # multi-host: HOSTS processes on the card
    port = _free_port()
    script = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, script, "--multihost-worker", str(r), str(HOSTS),
         str(port), d, str(dev), str(w), str(h), str(n), str(batch),
         str(LEVELS)], cwd=os.path.dirname(script),
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(HOSTS)]
    reports = []
    try:
        for r, p in enumerate(procs):
            text, _ = p.communicate(timeout=300)
            _require(p.returncode == 0, f"multi-host rank {r} exited "
                     f"{p.returncode}:\n{text[-3000:]}")
            line = [x for x in text.splitlines()
                    if x.startswith("MULTIHOST ")]
            _require(len(line) == 1, f"multi-host rank {r} report")
            reports.append(json.loads(line[0][len("MULTIHOST "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    mh_enc, mh_dec = os.path.join(d, "mh.enc"), os.path.join(d, "mh.raw")
    _require(read(mh_enc) == read(v1) and read(mh_enc + "_SIZE")
             == read(v1 + "_SIZE"), "multi-host merged file == single-host")
    _require(read(mh_dec) == read(raw), "multi-host merged decode == input")
    rep = {}
    for direction in ("encode", "decode"):
        sr = ScalingReport(
            frames=n, num_hosts=HOSTS,
            host_wall_s=[r[f"{direction}_wall_s"] for r in reports],
            single_host_wall_s=min(walls[1][direction]))
        rep[direction] = sr.as_dict()
        print(f"{tag} multi-host {HOSTS} processes on one card, {direction}:"
              f" host walls {sr.host_wall_s} s, single host "
              f"{sr.single_host_wall_s:.4f} s, aggregate "
              f"{sr.aggregate_fps:.2f} frames/s, efficiency "
              f"{sr.efficiency:.4f}")
    launches = {dr: sum(r["launches"][dr] for r in reports)
                for dr in ("encode", "decode")}
    x3_mh = {dr: sum(r["x3_launches"][dr] for r in reports)
             for dr in ("pack", "unpack")}
    _require((x3_mh["pack"], x3_mh["unpack"]) == (launches["encode"],
                                                  launches["decode"]),
             f"multi-host X3 launches {x3_mh}, one a BPC launch {launches}")
    if dev.type == "cuda":
        # each host codes its slab in batches of min(batch, slab frames)
        want = sum(-(-(b - a) // min(batch, b - a))
                   for a, b in shares(n, HOSTS) if b > a)
        _require(launches == {"encode": want, "decode": want},
                 f"multi-host launches {launches}, want {want} a direction")
    rep["launches"] = launches
    out["multihost"] = rep
    tmp.cleanup()
    # the workers' launches code a batch of `batch` frames
    bc = BatchCodec(vcfg, luts, params, batch, dev)
    (vblocks,), mx = bc.prep_batch(frames(batch))
    k = kernels_at("multi-host batch", vblocks, bc._bpc_args(0),
                   dict(bc.codec._bpc_kw,
                        n_planes=bpc.planes_for_magnitude(int(mx))))
    out["workloads"].append({
        "workload": f"multi-host video {w}x{h}, {n} frames, {HOSTS} "
                    "processes", "shards": HOSTS, "launches": launches, **k})
    print(f"{tag} multi-host: merged file == single-host, merged decode == "
          f"input; launches {launches} over {HOSTS} processes")
    return out


def quality_phase(dev, tag: str, err: dict) -> dict:
    """The quality tools on the card: the held-out images' digests first
    (an image that differs prints "input differs: <image>"); then each
    row of `quality_report`'s report (QUALITY.md's tables: 512^2 natural,
    noisy and edges lossless with the neutral and trained tables, natural
    lossy over qs with the trained lossy table, the same at 2048^2)
    through its row function on the card, exactly one cp2 encode and one
    cp2 decode launch a row (counts reset before the row and read after
    it), the row equal as a string to the row of the recorded numbers
    (`goldens.QUALITY_LOSSLESS`: QUALITY.md's bytes, which are the
    oracle's; `goldens.QUALITY_LOSSY`: the oracle's bytes and PSNR to two
    decimals) where its image matched, else to the port's own row on the
    CPU; the `reference` rows are absent (no reference LUT folder). Then
    `quality_report.main --out FILE --device cuda`, every row of the file
    equal to those rows, one launch pair a row; then `lut_eval.main
    luts/trained_lossless --size 512`, its bpp equal to those rows'. The
    kernels are held to their plain versions at the rows' shapes (512^2:
    every codeblock; 2048^2: BIG_PICKS of them), lossless trained and
    lossy qs 1, and timed there.
    Returns the kernels' quality entries."""
    import contextlib
    import io

    import numpy as np
    import torch

    from picsong_tpu_torch.core.header import CodecConfig
    from picsong_tpu_torch.engine.pipeline import TorchCodec
    from picsong_tpu_torch.entropy import bpc, bpc_cuda
    from picsong_tpu_torch.tools import goldens, lut_eval
    from picsong_tpu_torch.tools import quality_report as qr
    from picsong_tpu_torch.transform import dwt_cuda

    same = {}
    for (name, size), want in goldens.QUALITY_IMAGES.items():
        same[(name, size)] = goldens.digest(qr.image(name, size)) == want
        if not same[(name, size)]:
            print(f"{tag} input differs: {name} {size}^2 (its rows are "
                  "held to the port's rows on this machine's CPU)")
    print(f"{tag} quality images: {sum(same.values())} of {len(same)} equal "
          "to the recorded digests")

    def counts():
        return [bpc_cuda.ENCODE_LAUNCHES["cp2"],
                bpc_cuda.DECODE_LAUNCHES["cp2"]]

    # the rows whose table exists (no `reference` row: no reference folder)
    present = [s for s in qr.SPECS
               if qr.table(s.lut, s.qs is not None) is not None]

    def expected(spec):
        """(the spec's recorded row, or its CPU row where its image
        differs; what holds it)"""
        if not same[(spec.image, spec.size)]:
            return qr.run(spec, "cpu"), "the CPU row (input differs)"
        n = spec.size * spec.size
        if spec.qs is None:
            nb = goldens.QUALITY_LOSSLESS[(spec.image, spec.size, spec.lut)]
            return qr.Row(nb, nb * 8 / n, n / nb), "QUALITY.md"
        nb, db = goldens.QUALITY_LOSSY[(spec.size, spec.qs)]
        return qr.Row(nb, nb * 8 / n, n / nb, float(db)), "the oracle's"

    # each row through the report's row function, its launches read
    # around it
    rows, launches = {}, {512: [0, 0], 2048: [0, 0]}
    for spec in present:
        bpc_cuda.reset_launches()
        rows[spec] = qr.run(spec, dev)
        got = counts()
        _require(got == [1, 1], f"quality {spec}: one encode and one "
                 f"decode launch, {got}")
        launches[spec.size] = [a + b for a, b in zip(launches[spec.size],
                                                     got)]
        want, held = expected(spec)
        line = qr.line(spec, rows[spec])
        _require(line == qr.line(spec, want), f"quality {spec}: {line} == "
                 f"{qr.line(spec, want)} ({held})")
        print(f"{tag} quality {spec.size}^2 {line} == {held}; launches "
              f"{got}")
    # then the whole report through its entry point
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "quality.md")
    bpc_cuda.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        _require(qr.main(["--out", path, "--device", str(dev)]) == 0,
                 "quality_report entry point")
    report_launches = counts()
    with open(path) as f:
        lines = f.read().splitlines()
    got = [x for x in lines if x.startswith("| ") and not x.startswith(
        ("| image", "| qs", "| LUT"))]
    _require(len(got) == len(qr.SPECS), f"quality report: {len(got)} rows")
    for spec, line in zip(qr.SPECS, got):
        _require(line == qr.line(spec, rows.get(spec)),
                 f"quality report {spec}: {line} == the row's")
    _require(report_launches == [len(present)] * 2, "quality report: "
             f"launches {report_launches} for {len(present)} rows")
    print(f"{tag} quality report entry point: {len(qr.SPECS)} rows equal "
          f"to the rows above ({len(present)} on the card, the reference "
          f"rows absent), launches {report_launches}; the rows' own: "
          f"512^2 {launches[512]}, 2048^2 {launches[2048]}")

    bpc_cuda.reset_launches()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        _require(lut_eval.main([os.path.join(qr.REPO, "luts",
                                             "trained_lossless"), "--size",
                                "512", "--device", str(dev)]) == 0,
                 "lut_eval entry point")
    ev = counts()
    table = [x.split("\t") for x in text.getvalue().splitlines()]
    names = table[0][1:]
    for cells in table[1:]:
        for name, bpp in zip(names, cells[1:]):
            lut = {"trained_lossless": "trained"}.get(name, name)
            row = rows.get(qr.Spec(cells[0], 512, lut))
            _require((row is None and bpp == "absent")
                     or (row is not None and bpp == f"{row.bpp:.4f}"),
                     f"lut_eval {cells[0]} {name}: {bpp} == the report's")
        print(f"{tag} lut_eval 512^2: " + "\t".join(cells))
    n_runs = sum(c != "absent" for cells in table[1:] for c in cells[1:])
    _require(ev == [n_runs, n_runs], f"lut_eval launches {ev}, one encode "
             f"and one decode for each of its {n_runs} round trips")
    print(f"{tag} lut_eval 512^2 (" + ", ".join(names) + "): bpp == the "
          f"report's rows; launches {ev}")
    tmp.cleanup()

    # the kernels at the rows' shapes, against their plain versions
    out = []
    for size, picks in ((512, None), (2048, BIG_PICKS)):
        img = torch.from_numpy(np.array(qr.image("natural", size))).to(dev)
        for qs in (None, 1.0):
            spec = qr.Spec("natural", size, qs=qs)
            luts, params = qr.table("trained", qs is not None)
            cfg = (CodecConfig(width=size, height=size,
                               wavelet_levels=qr.LEVELS) if qs is None else
                   CodecConfig(width=size, height=size,
                               wavelet_levels=qr.LEVELS, is_lossy=True,
                               qs=qs))
            c = TorchCodec(cfg, list(luts), params, dev)
            (blocks,), mx = dwt_cuda.forward([img], cfg)
            kw = dict(c._bpc_kw, n_planes=bpc.planes_for_magnitude(int(mx)))
            a = c._bpc_args()
            s_k, z_k = bpc_cuda.encode_blocks(blocks, *a, **kw)
            _require(torch.equal(bpc_cuda.decode_blocks(s_k, z_k, *a, **kw),
                                 blocks), f"quality {spec}: kernels' round "
                     "trip")
            idx = torch.arange(blocks.shape[0], device=dev) if picks is None \
                else torch.linspace(0, blocks.shape[0] - 1, picks,
                                    device=dev).long()
            sub = (a[0], *(m[idx] for m in a[1:]))
            s_p, z_p = bpc.encode_blocks_plain(blocks[idx], *sub, **kw)
            e = max(int((s_p.long() - s_k[idx].long()).abs().max()),
                    int((z_p.long() - z_k[idx].long()).abs().max()))
            err["cp2"]["encode"] = max(err["cp2"]["encode"], e)
            _require(e == 0, f"quality {spec}: encode kernel == plain on "
                     f"{idx.numel()} codeblocks, max err {e}")
            o_p = bpc.decode_blocks_plain(s_k[idx], z_k[idx], *sub, **kw)
            e = int((o_p.long() - blocks[idx].long()).abs().max())
            err["cp2"]["decode"] = max(err["cp2"]["decode"], e)
            _require(e == 0, f"quality {spec}: plain decode of the kernel's "
                     f"streams == input on {idx.numel()} codeblocks")
            if qs is not None:
                continue
            bound, by = bpc_cuda.bound_ms(blocks)
            k = {"codeblocks": blocks.shape[0],
                 "encode_ms": kernel_ms(
                     lambda: bpc_cuda.encode_blocks(blocks, *a, **kw)),
                 "decode_ms": kernel_ms(
                     lambda: bpc_cuda.decode_blocks(s_k, z_k, *a, **kw)),
                 "bound_ms": bound, "bound_by": by}
            out.append({"workload": f"quality report {size}^2 rows",
                        "launches": dict(zip(("encode", "decode"),
                                             launches[size])), **k})
            if size == 512:
                out.append({"workload": "lut_eval 512^2", "launches": dict(
                    zip(("encode", "decode"), ev)), **k})
            print(f"{tag} quality {size}^2 natural: kernels == plain on "
                  f"{idx.numel()} codeblocks (lossless trained and lossy qs "
                  f"1); {k['codeblocks']} codeblocks a launch, K1 "
                  f"{k['encode_ms']:.4f} ms, K2 {k['decode_ms']:.4f} ms, "
                  f"bound {bound:.5f} ms ({by})")
    return out


def busy_phase(dev, tag: str, codec, img, cli_round_trip,
               cli_median_ms: float) -> None:
    """The main path's device busy share: `device_trace` over one
    TorchCodec encode + decode of `img` and over one CLI round trip
    (`cli_round_trip()`), each after an untraced and a traced warm-up
    (CUPTI's first use costs seconds). Prints the busy ms (the union of
    the card's kernel and copy spans) and span count, the share of the
    profiled wall and of the unprofiled median (the API round trip's
    here, ITERS times; the CLI's from phase 6); a trace without device
    spans, or without the codec's stage names, fails."""
    import torch

    from picsong_tpu_torch.obs.trace import busy_ms, device_trace

    def api_round_trip():
        codec.decode(codec.encode(img))

    api_ms = statistics.median(host_ms(api_round_trip))
    tmp = tempfile.TemporaryDirectory()
    for label, fn, unprofiled in (
            ("TorchCodec encode + decode", api_round_trip, api_ms),
            ("CLI round trip", cli_round_trip, cli_median_ms)):
        fn()
        with device_trace(os.path.join(tmp.name, "warm"), dev):
            fn()
        log_dir = os.path.join(tmp.name, label.split()[0])
        with device_trace(log_dir, dev) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        busy, n_spans = busy_ms(prof)
        _require(n_spans > 0, f"{label}: the trace holds device spans")
        (trace,) = os.listdir(log_dir)
        with open(os.path.join(log_dir, trace)) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        _require({"encode/dwt+bpc", "decode/bpc+idwt"} <= names,
                 f"{label}: the trace names the codec's stages")
        print(f"{tag} busy share, {label} {SIZE}^2 wl={LEVELS} lossless: "
              f"device busy {busy:.4f} ms ({n_spans} kernel and copy spans) "
              f"in a profiled wall of {wall:.4f} ms: {busy / wall:.4f} of "
              f"it, {busy / unprofiled:.4f} of the unprofiled median "
              f"{unprofiled:.4f} ms; the trace names the codec's stages")
    tmp.cleanup()


def main() -> int:
    if sys.argv[1:2] == ["--multihost-worker"]:
        return multihost_worker(sys.argv[2:])
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    # the port runs without JAX and without the JAX package
    sys.modules["jax"] = None
    sys.modules["picsong_tpu"] = None

    import numpy as np

    from picsong_tpu_torch import kernels
    from picsong_tpu_torch.assembly import pack
    from picsong_tpu_torch.core.geometry import codeblock_bands
    from picsong_tpu_torch.core.header import CodecConfig, pack_header
    from picsong_tpu_torch.core.image_io import (append_raw_frame, read_pgm,
                                                 read_raw_frame, sample_dtype,
                                                 write_pgm)
    from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
    from picsong_tpu_torch.engine import cli
    from picsong_tpu_torch.engine.pipeline import TorchCodec
    from picsong_tpu_torch.entropy import bpc, bpc_cuda
    from picsong_tpu_torch.tools import goldens, kernel_ab, probe, probe2
    from picsong_tpu_torch.transform import dwt_cuda

    make_image = goldens.make_image

    dev = torch.device("cuda")
    modes = list(bpc_cuda.MODES)
    # ---- 1. device -------------------------------------------------------
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(_run([kernels.find_nvcc(), "--version"]).splitlines()[-1])
    tag = f"[{card}]"

    def stamp(phase: str) -> None:
        """The phase's start, in seconds since the script's: the script's
        time by phase."""
        print(f"{tag} phase {phase} starts at "
              f"{time.perf_counter() - started:.1f} s", flush=True)

    # ---- 2. build --------------------------------------------------------
    stamp("2")
    t0 = time.perf_counter()
    _, log = kernels.build()
    kernels.library()
    print(f"{tag} kernel build {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            # bpc kernels by their template arguments <CP, BULK>
            t = re.search(r"(bpc_\w+_kernel)ILi(\d)ELb(\d)E", entry.group(1))
            print("  ptxas:", f"{t.group(1)}<{t.group(2)}, "
                  f"{'true' if t.group(3) == '1' else 'false'}>" if t
                  else entry.group(1))
        elif "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # the inputs of every digest gate, before any codestream is compared
    for key, want in goldens.IMAGES.items():
        _require(goldens.digest(make_image(*key)) == want,
                 f"input differs: make_image{key} is not the image the "
                 "golden digests were made from")
    print(f"{tag} inputs: {len(goldens.IMAGES)} images equal to the golden "
          "digests' inputs")

    # max abs error of each kernel variant against its plain version
    err = {m: {"encode": 0, "decode": 0} for m in modes}

    def gpu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def mode_kw(lut_params, wl, cp=2, k=0.0):
        return dict(params=lut_params, wavelet_levels=wl, coding_passes=cp,
                    has_k=k > 0)

    def compare_encode(blocks, args, kw, n_planes, what):
        mode = bpc_cuda.mode_of(kw["coding_passes"], kw["has_k"])
        s_k, n_k = bpc_cuda.encode_blocks(blocks, *args, **kw,
                                          n_planes=n_planes)
        s_p, n_p = bpc.encode_blocks_plain(blocks, *args, **kw,
                                           n_planes=n_planes)
        torch.cuda.synchronize()
        e = max(int((s_k.long() - s_p.long()).abs().max()),
                int((n_k.long() - n_p.long()).abs().max()))
        err[mode]["encode"] = max(err[mode]["encode"], e)
        _require(e == 0, f"{mode} encode kernel == plain ({what}), max err {e}")
        return s_k, n_k

    def compare_decode(streams, sizes, args, kw, n_planes, want, what):
        mode = bpc_cuda.mode_of(kw["coding_passes"], kw["has_k"])
        o_k = bpc_cuda.decode_blocks(streams, sizes, *args, **kw,
                                     n_planes=n_planes)
        o_p = bpc.decode_blocks_plain(streams, sizes, *args, **kw,
                                      n_planes=n_planes)
        torch.cuda.synchronize()
        e = int((o_k.long() - o_p.long()).abs().max())
        err[mode]["decode"] = max(err[mode]["decode"], e)
        _require(e == 0, f"{mode} decode kernel == plain ({what}), max err {e}")
        _require(torch.equal(o_k, want), f"{mode} decode == input ({what})")

    # ---- 3. kernel vs plain on random batches ----------------------------
    stamp("3")
    params = LUTParams()
    wl = 2
    n = 256
    levels = (np.arange(n) % (wl + 1)).astype(np.int32)
    subbands = np.where(levels == wl, 0, np.arange(n) % 3).astype(np.int32)

    def batch_args(lut, cp, k):
        meta = bpc._meta_args(levels, subbands, params, wl, cp, k)
        return [gpu(a) for a in (lut, *meta)], mode_kw(params, wl, cp, k)

    lut = neutral_lut(params, wl, 2)
    lut = lut + (np.arange(lut.size, dtype=np.int32) % 41)
    args, kw = batch_args(lut, 2, 0.0)
    for seed in (0, 1, 2):
        for maxmag in (7, 200, 30000):
            rng = np.random.default_rng(seed)
            blocks = rng.integers(-maxmag, maxmag + 1, size=(n, 64, 64),
                                  dtype=np.int32)
            blocks[rng.random(blocks.shape) < 0.7] = 0
            blocks[3] = 0                                   # empty block
            blocks[5] = rng.integers(-30000, 30001, size=(64, 64),
                                     dtype=np.int32)        # raw fallback
            n_planes = bpc.planes_for_magnitude(int(np.abs(blocks).max()))
            b = gpu(blocks)
            what = f"seed {seed} maxmag {maxmag}"
            s, z = compare_encode(b, args, kw, n_planes, what)
            _require(int(z[5]) == 4096 and int(z[3]) == 1,
                     f"raw fallback and empty block exercised ({what})")
            compare_decode(s, z, args, kw, n_planes, b, what)
    print(f"{tag} random batches cp=2: 9 x {n} codeblocks, kernels "
          f"byte-equal to plain (max abs err encode {err['cp2']['encode']}, "
          f"decode {err['cp2']['decode']}), decode == input")

    # cp=3 and k > 0: a random LUT favouring zeros (every group table with
    # k), an empty block (3), a raw-fallback block (5), a block with MSB 0
    # (6), and with k a sparse block with MSB 15 (9) whose split plane
    # puts its group past the 15 group tables
    for cp, k, maxmag in ((3, 0.0, 200), (2, 1.0, 900), (2, 5.0, 200),
                          (2, 8.0, 2000)):
        rng = np.random.default_rng(10 + cp + int(k))
        blocks = rng.integers(-maxmag, maxmag + 1, size=(n, 64, 64),
                              dtype=np.int32)
        blocks[rng.random(blocks.shape) < 0.7] = 0
        blocks[3] = 0
        blocks[5] = rng.integers(-30000, 30001, size=(64, 64), dtype=np.int32)
        blocks[6] = rng.integers(-1, 2, size=(64, 64), dtype=np.int32)
        if k > 0:
            blocks[9] = np.where(rng.random((64, 64)) < 0.02, 32768, 0)
            blocks[9, 0, 0] = -65535
        groups = params.n_bitplane_files if k > 0 else 1
        lut_r = rng.integers(64, 120, size=params.size_per_group(wl, cp)
                             * groups).astype(np.int32)
        args_r, kw_r = batch_args(lut_r, cp, k)
        n_planes = bpc.planes_for_magnitude(int(np.abs(blocks).max()))
        b = gpu(blocks)
        what = f"cp={cp} k={k} maxmag {maxmag}"
        s, z = compare_encode(b, args_r, kw_r, n_planes, what)
        msb = s[:, 0].cpu().numpy()
        _require(int(z[3]) == 1 and int(z[5]) == 4096
                 and msb[6] == 0 and int(z[6]) < 4096,
                 f"empty, raw-fallback and MSB-0 blocks exercised ({what})")
        if k > 0:
            consec = np.floor(np.float32(msb[9])
                              * args_r[6][9].cpu().numpy())
            _require(msb[9] == 15 and int(z[9]) < 4096
                     and (k < 5 or consec >= 15),
                     f"MSB-15 block exercised, split plane {consec} ({what})")
        compare_decode(s, z, args_r, kw_r, n_planes, b, what)
    print(f"{tag} random batches cp=3, k=1, 5, 8: 4 x {n} codeblocks, random "
          f"LUTs; kernels byte-equal to plain (max abs err cp3 "
          f"{err['cp3']}, bulk {err['bulk']}), decode == input")

    # ---- 3b. X2/X4 vs plain: the DWT phase --------------------------------
    stamp("3b")
    dwt = dwt_phase(dev, tag)

    # ---- 4. oracle check at BASELINE config 1 (512^2, wl=1) ---------------
    stamp("4")
    img512 = make_image(512)
    for cp, k in ((2, 0.0), (3, 0.0), (2, K)):
        cfg1 = CodecConfig(width=512, height=512, wavelet_levels=1,
                           coding_passes=cp, k_factor=k)
        luts1, params1 = cli._load_luts("neutral", 1, cp, k)
        codec1 = TorchCodec(cfg1, luts1, params1, dev)
        got = codec1.encode(img512)[0]
        _require(goldens.digest(got) == goldens.CODESTREAMS_512[(cp, k)],
                 f"512^2 wl=1 cp={cp} k={k} codestream == the oracle's "
                 "(digest)")
        _require(np.array_equal(codec1.decode([got]), img512),
                 f"512^2 wl=1 cp={cp} k={k} decode bit-exact")
        print(f"{tag} 512^2 wl=1 -cp {cp} -k {k:g}: codestream byte-equal to "
              f"the NumPy oracle's ({got.size} shorts, SHA-256), decode "
              "bit-exact")

    # ---- 5. the slice at 2048^2 wl=5 through the CLI ----------------------
    stamp("5")
    img = make_image(SIZE)
    tmp = tempfile.TemporaryDirectory()
    src = os.path.join(tmp.name, "in.pgm")
    write_pgm(src, img)

    def cli_pair(job):
        """One CLI encode and decode (the timed round trip: no read-back, no
        check). Sets every BPC, DWT and X3 launch count to 0 first, reads
        them after, and returns the launches of the job's BPC mode, of X2
        ("forward"), X4 ("reverse") and X3 ("pack", "unpack"); no other
        BPC mode may have launched."""
        enc_args, dec_args, what, mode = job
        bpc_cuda.reset_launches()
        dwt_cuda.reset_launches()
        pack.reset_launches()
        _require(cli.main(["-cd", "0", *enc_args]) == 0, f"CLI encode {what}")
        _require(cli.main(["-cd", "1", *dec_args]) == 0, f"CLI decode {what}")
        got = {"encode": bpc_cuda.ENCODE_LAUNCHES[mode],
               "decode": bpc_cuda.DECODE_LAUNCHES[mode],
               "forward": dwt_cuda.FORWARD_LAUNCHES,
               "reverse": dwt_cuda.REVERSE_LAUNCHES,
               "pack": pack.PACK_LAUNCHES, "unpack": pack.UNPACK_LAUNCHES}
        _require(min(got.values()) > 0,
                 f"{what} path launched both {mode} BPC kernels, X2, X4 and "
                 f"the X3 pack and unpack {got}")
        others = sum(bpc_cuda.ENCODE_LAUNCHES[m] + bpc_cuda.DECODE_LAUNCHES[m]
                     for m in modes if m != mode)
        _require(others == 0, f"{what} path launched only its {mode} kernels")
        return got

    def gray_job(lut_folder, lossy=False, cp=2, k=0.0):
        """(codestream path, decoded path, cli_pair job) of a gray round
        trip of `src`: lossless wl=5, or lossy wl=3 qs=1."""
        name = (f"{'lossy_' if lossy else ''}{lut_folder}_cp{cp}_k{k:g}")
        enc = os.path.join(tmp.name, f"{name}.enc")
        dec = os.path.join(tmp.name, f"{name}.pgm")
        kind = ["-wl", str(LOSSY_LEVELS), "-cp", str(cp), "-type", "1", "-qs",
                "1"] if lossy else ["-wl", str(LEVELS), "-cp", str(cp),
                                    "-type", "0"]
        return enc, dec, (["-i", src, "-o", enc, *kind, "-video", "0", "-k",
                           f"{k:g}", "-LUTFolder", lut_folder],
                          ["-i", enc, "-o", dec, "-video", "0", "-LUTFolder",
                           lut_folder],
                          f"{'lossy' if lossy else 'lossless'} {lut_folder} "
                          f"-cp {cp} -k {k:g}", bpc_cuda.mode_of(cp, k > 0))

    def add(total, got):
        return {d: total[d] + got[d] for d in total}

    # launches of each kernel variant on the paths that carry it
    launches = {m: {"encode": 0, "decode": 0} for m in modes}
    dwt_launches = {"forward": 0, "reverse": 0}
    pack_launches = {"pack": 0, "unpack": 0}
    exact, enc_bytes = {}, {}
    for lut_folder in ("neutral", "trained"):
        enc, dec, job = gray_job(lut_folder)
        got = cli_pair(job)
        launches["cp2"] = add(launches["cp2"], got)
        dwt_launches = add(dwt_launches, got)
        pack_launches = add(pack_launches, got)
        exact[lut_folder] = np.array_equal(read_pgm(dec), img)
        enc_bytes[lut_folder] = os.path.getsize(enc)
    _require(all(exact.values()), f"2048^2 CLI round trips bit-exact {exact}")
    print(f"{tag} {SIZE}^2 wl={LEVELS} CLI round trips bit-exact: neutral "
          f"{enc_bytes['neutral']} B, trained {enc_bytes['trained']} B; "
          f"kernel launches on the main path: BPC {launches['cp2']}, X2/X4 "
          f"{dwt_launches}, X3 {pack_launches}")

    def oracle_picks(label, c, blocks, streams, sizes, key):
        """The first codeblock of every level and subband of the 2048^2
        wl=5 gray plane (LL included): its coefficients equal to the
        oracle's DWT, its stream and size to the oracle's encode_codeblock
        under `key` = (coding passes, k, LUT folder), by digest."""
        lv, sb = codeblock_bands(c.aw, c.ah, c.cfg.wavelet_levels)
        picks = {}
        for i, band in enumerate(zip(lv.tolist(), sb.tolist())):
            picks.setdefault(band, i)
        _require(sorted(picks.values()) == sorted(goldens.PICKS_2048[key]),
                 f"{label}: every level and subband picked")
        blocks_np, streams_np = blocks.cpu().numpy(), streams.cpu().numpy()
        sizes_np = sizes.cpu().numpy()
        for (level, subband), i in sorted(picks.items()):
            where = f"{label}: codeblock {i} (level {level}, subband {subband})"
            _require(goldens.digest(blocks_np[i]) == goldens.BLOCKS_2048[i],
                     f"{where}: input differs from the oracle's DWT")
            _require(goldens.digest(streams_np[i].astype(np.int32),
                                    np.int32(sizes_np[i]))
                     == goldens.PICKS_2048[key][i], f"{where} == oracle")
        return len(picks)

    cfg = CodecConfig(width=SIZE, height=SIZE, wavelet_levels=LEVELS)
    luts = [neutral_lut(params, LEVELS, 2)]
    codec = TorchCodec(cfg, luts, params, dev)
    samples = gpu(img)
    (blocks,), max_mag = dwt_cuda.forward([samples], cfg)
    n_planes = bpc.planes_for_magnitude(int(max_mag))
    pargs, pkw = codec._bpc_args(), codec._bpc_kw
    streams, sizes = compare_encode(blocks, pargs, pkw, n_planes,
                                    f"{SIZE}^2 plane")
    compare_decode(streams, sizes, pargs, pkw, n_planes, blocks,
                   f"{SIZE}^2 plane")
    n_picks = oracle_picks(f"{SIZE}^2 plane", codec, blocks, streams, sizes,
                           (2, 0.0, "neutral"))
    print(f"{tag} {SIZE}^2 plane: {blocks.shape[0]} codeblocks, n_planes "
          f"{n_planes}, kernels byte-equal to plain; {n_picks} codeblocks "
          "(LL and every level/subband) byte-equal to the oracle")

    # ---- 5b. X3, the pack and unpack kernels, vs plain --------------------
    stamp("5b")
    x3 = pack_results()
    pack_phase(dev, tag, x3)
    pack_check(tag, f"{SIZE}^2 wl={LEVELS} main path", streams, sizes,
               pack_header(cfg), x3, timed=True)

    # ---- 6. times ----------------------------------------------------------
    stamp("6")
    mpix = SIZE * SIZE / 1e6

    def report(name, samples, rate=True, mp=mpix):
        ms = statistics.median(samples)
        per = f" ({mp / (ms / 1e3):.1f} MPix/s)" if rate else ""
        print(f"{tag} {name}: median {ms:.4f} ms, min {min(samples):.4f}, "
              f"max {max(samples):.4f} over {len(samples)}{per}")
        return ms

    # each variant's kernel and plain times at 2048^2 wl=5 (1024 codeblocks)
    kt = {}

    def kernel_times(mode, c, blocks, streams, sizes, n_pl):
        """CUDA-event times of the mode's two kernels (KERNEL_BATCH
        launches back to back) and of their plain versions on one plane;
        returns the kernels' samples."""
        a, kw = c._bpc_args(), c._bpc_kw
        enc = device_ms(lambda: bpc_cuda.encode_blocks(blocks, *a, **kw,
                                                       n_planes=n_pl),
                        per=KERNEL_BATCH)
        dec = device_ms(lambda: bpc_cuda.decode_blocks(streams, sizes, *a,
                                                       **kw, n_planes=n_pl),
                        per=KERNEL_BATCH)
        kt[mode] = {
            "encode": report(f"BPC encode kernel {mode}", enc),
            "decode": report(f"BPC decode kernel {mode}", dec),
            "encode plain": report(
                f"BPC encode plain PyTorch on the card {mode}", device_ms(
                    lambda: bpc.encode_blocks_plain(blocks, *a, **kw,
                                                    n_planes=n_pl),
                    iters=PLAIN_ITERS, warm=1)),
            "decode plain": report(
                f"BPC decode plain PyTorch on the card {mode}", device_ms(
                    lambda: bpc.decode_blocks_plain(streams, sizes, *a, **kw,
                                                    n_planes=n_pl),
                    iters=PLAIN_ITERS, warm=1)),
        }
        return enc, dec

    report(f"device encode {SIZE}^2 wl={LEVELS} (samples -> streams)",
           host_ms(lambda: codec.encode_planes([samples])))
    report(f"device decode {SIZE}^2 wl={LEVELS} (streams -> samples)",
           host_ms(lambda: codec.decode_planes([(streams, sizes, n_planes)])))
    cli_ms = report(f"CLI round trip {SIZE}^2 wl={LEVELS} neutral LUT "
                    "(file -> file -> file)",
                    host_ms(lambda: cli_pair(gray_job("neutral")[2])))
    enc_kernel, dec_kernel = kernel_times("cp2", codec, blocks, streams,
                                          sizes, n_planes)

    # per-layer breakdown of the host API round trip; the codestream is
    # packed and unpacked on the card, so only its packed bytes cross PCIe
    header = pack_header(cfg)
    packed = pack.pack_streams(streams, sizes, header)
    shorts = packed.cpu().numpy().view(np.uint16)
    _require(np.array_equal(shorts, codec.encode(img)[0])
             and shorts.size == pack.stream_length(
                 codec.ncb, int(sizes.sum()) - codec.ncb),
             "TorchCodec.encode downloads the packed codestream alone")
    payload = int(pack.block_fields(shorts, codec.ncb)[1].sum()) - codec.ncb
    s_back, z_back = pack.unpack_streams(packed, codec.ncb, payload)
    _require(torch.equal(s_back, streams) and torch.equal(z_back, sizes),
             "device unpack == the kernel's streams and sizes")
    layers = {
        "prep+DWT+tile (X2)": device_ms(
            lambda: dwt_cuda.forward([samples], cfg)),
        "BPC encode kernel": enc_kernel,
        "device pack (X3 kernels, one scalar read)": host_ms(
            lambda: pack.pack_streams(streams, sizes, header)),
        "device pack plain (torch ops, one scalar read)": host_ms(
            lambda: pack.pack_streams_plain(streams, sizes, header)),
        "D2H packed codestream": host_ms(lambda: packed.cpu()),
        "H2D packed codestream": host_ms(
            lambda: torch.from_numpy(shorts.view(np.int16)).to(dev)),
        "device unpack (X3 kernels)": device_ms(
            lambda: pack.unpack_streams(packed, codec.ncb, payload)),
        "device unpack plain (torch ops)": device_ms(
            lambda: pack.unpack_streams_plain(packed, codec.ncb, payload)),
        "BPC decode kernel": dec_kernel,
        "untile+IDWT+clamp (X4)": device_ms(
            lambda: dwt_cuda.reverse([blocks], cfg)),
    }
    for name, times in layers.items():
        report(f"layer {name}", times, rate=False)
    print(f"{tag} packed codestream {shorts.nbytes} B crosses PCIe each "
          f"way (the raw stream buffers: {streams.nbytes + sizes.nbytes} B)")
    busy_phase(dev, tag, codec, img,
               lambda: cli_pair(gray_job("neutral")[2]), cli_ms)

    # ---- 7. probes K3/K4: kernel vs plain, then their entry points -------
    stamp("7")
    perr = {"probe": 0, "probe2": 0}
    pt = {}
    for name, module in (("probe", probe), ("probe2", probe2)):
        for what, args, skip in (
                ("probe inputs", module.inputs(0), 0),
                ("seed 1", module.inputs(1), 0),
                ("edge inputs", module.edge_inputs(), 0),
                ("views 1 word off 16-byte alignment", module.inputs(2), 1)):
            dargs = offset_views([gpu(a) for a in args], skip)
            got_k = module.run(*dargs)
            got_p = module.plain(*dargs)
            torch.cuda.synchronize()
            e = int((got_k.long() - got_p.long()).abs().max())
            perr[name] = max(perr[name], e)
            _require(e == 0, f"{name} kernel == plain ({what}), max err {e}")
            _require(torch.equal(got_p.cpu(), module.plain(
                *(torch.from_numpy(a) for a in args))),
                f"{name} plain on the card == plain on the host ({what})")
        dargs = [gpu(a) for a in module.inputs(0)]
        pt[name] = report(f"{name} kernel, {PROBE_CALLS} back-to-back "
                          "launches (total)", device_ms(
                              lambda: [module.launch(*dargs)
                                       for _ in range(PROBE_CALLS)]),
                          rate=False) / PROBE_CALLS
        pt[name + " plain"] = report(
            f"{name} plain PyTorch on the card, {PROBE_CALLS} calls "
            "(total)", device_ms(lambda: [module.plain(*dargs)
                                       for _ in range(PROBE_CALLS)]),
            rate=False) / PROBE_CALLS
        # the kernel's device time without the wrapper's host time
        pt[name + " device"] = kernel_ab.graph_ms(
            lambda: module.launch(*dargs))
        pt[name + " bound"] = module.bound_ms(*dargs)
        print(f"{tag} {name}: kernel {pt[name]:.6f} ms/call, device "
              f"{pt[name + ' device']:.6f} ms/call (CUDA graph), plain "
              f"{pt[name + ' plain']:.6f} ms/call (max abs err "
              f"{perr[name]})")
    # the floors, timed as the probes are: a one-element torch op, back to
    # back and in a CUDA graph
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floor = report(f"launch floor: a one-element torch op (add_), "
                   f"{PROBE_CALLS} back-to-back calls (total)", device_ms(
                       lambda: [one.add_(1) for _ in range(PROBE_CALLS)]),
                   rate=False) / PROBE_CALLS
    graph_floor = kernel_ab.graph_ms(lambda: one.add_(1))
    print(f"{tag} launch floor {floor:.6f} ms a call, beside the probes' "
          f"{pt['probe']:.6f} / {pt['probe2']:.6f} ms; graph floor "
          f"{graph_floor:.6f} ms a call, beside the probes' device "
          f"{pt['probe device']:.6f} / {pt['probe2 device']:.6f} ms; bounds "
          f"{pt['probe bound'][0]:.8f} / {pt['probe2 bound'][0]:.8f} ms")
    probe_launches = {}
    for name, module in (("probe", probe), ("probe2", probe2)):
        print(f"{tag} python -m picsong_tpu_torch.tools.{name}:")
        module.LAUNCHES = 0
        _require(module.main([]) == 0, f"{name} entry point")
        probe_launches[name] = module.LAUNCHES
        _require(probe_launches[name] > 0,
                 f"{name} entry point launched its kernel")
    print(f"{tag} probe entry points: kernel launches {probe_launches}")

    # ---- 8. lossy 9/7 gray, BASELINE config 2 (2048^2 wl=3 qs=1) ---------
    stamp("8")
    def check_planes(label, cfg, luts, lut_params, planes, host,
                     picks=None):
        """A path's planes on the card: each component's BPC kernels against
        their plain versions at the path's shapes, n_planes and LUT; with
        `host`, also the card's quantized codeblocks (X2) and decoded
        samples (X4) against the plain version's on the host; with `picks`,
        one codeblock of every band against the oracle's digests of the
        `picks` key = (coding passes, k, LUT folder). Returns the decoded
        planes, the codec, its codeblocks and streams per component, and
        n_planes."""
        c = TorchCodec(cfg, luts, lut_params, dev)
        tiled, top = dwt_cuda.forward([gpu(p) for p in planes], cfg)
        n_pl = bpc.planes_for_magnitude(int(top))
        coded = []
        for i, blocks in enumerate(tiled):
            what = f"{label} component {i}"
            s_, z_ = compare_encode(blocks, c._bpc_args(i), c._bpc_kw, n_pl,
                                    what)
            compare_decode(s_, z_, c._bpc_args(i), c._bpc_kw, n_pl, blocks,
                           what)
            coded.append((s_, z_))
        n_picks = (oracle_picks(label, c, tiled[0], *coded[0], picks)
                   if picks else 0)
        out = [o.cpu() for o in dwt_cuda.reverse(tiled, cfg)]
        if host:
            tiled_h, _ = dwt_cuda.forward(
                [torch.from_numpy(p) for p in planes], cfg)
            out_h = dwt_cuda.reverse(tiled_h, cfg)
            for i in range(len(tiled)):
                what = f"{label} component {i}"
                _require(torch.equal(tiled[i].cpu(), tiled_h[i]),
                         f"{what}: quantized codeblocks card == host")
                mism = int((out[i] != out_h[i]).sum())
                _require(mism == 0,
                         f"{what}: decoded samples card == host ({mism} differ)")
        print(f"{tag} {label}: {len(tiled)} x {tiled[0].shape[0]} "
              f"codeblocks, n_planes {n_pl}; kernels byte-equal to plain on "
              "every component" + ("; the card's quantized codeblocks (X2) "
                                   "and decoded samples (X4) equal to the "
                                   "host port's" if host else "")
              + (f"; {n_picks} codeblocks (LL and every level/subband) "
                 "byte-equal to the oracle" if picks else ""))
        return [o.numpy() for o in out], c, tiled, coded, n_pl

    def same_planes(back, out):
        return all(np.array_equal(b, o[:b.shape[0], :b.shape[1]])
                   for b, o in zip(back, out))

    def lossy_cli(lut_folder, out_l, k=0.0):
        enc, dec, job = gray_job(lut_folder, lossy=True, k=k)
        got = cli_pair(job)
        back = read_pgm(dec)
        _require(same_planes([back], out_l),
                 f"lossy {lut_folder} -k {k:g}: CLI decode == the "
                 "host-checked card decode")
        db = psnr(back, img)
        _require(db > 40.0, f"lossy {lut_folder} -k {k:g} PSNR {db:.2f} dB "
                 "> 40")
        print(f"{tag} {SIZE}^2 wl={LOSSY_LEVELS} lossy -k {k:g} CLI round "
              f"trip, {lut_folder} LUT: PSNR {db:.4f} dB, "
              f"{os.path.getsize(enc)} B; kernel launches {got}")
        return got

    cfg_l = CodecConfig(width=SIZE, height=SIZE,
                        wavelet_levels=LOSSY_LEVELS, is_lossy=True, qs=1.0)
    luts_l = [neutral_lut(params, LOSSY_LEVELS, 2)]
    out_l = check_planes(f"{SIZE}^2 lossy plane", cfg_l, luts_l, params,
                         [img], host=True)[0]
    for lut_folder in ("neutral", "trained"):
        lossy_cli(lut_folder, out_l)

    cfg_l512 = CodecConfig(width=512, height=512,
                           wavelet_levels=LOSSY_LEVELS, is_lossy=True, qs=1.0)
    codec_l512 = TorchCodec(cfg_l512, luts_l, params, dev)
    got = codec_l512.encode(img512)
    _require(goldens.digest(got[0]) == goldens.LOSSY_512["codestream"],
             "512^2 wl=3 lossy codestream == the oracle's (digest)")
    dec512 = codec_l512.decode(got)
    _require(goldens.digest(dec512) == goldens.LOSSY_512["decoded"],
             "512^2 wl=3 lossy decoded samples == the oracle's (digest)")
    print(f"{tag} 512^2 wl=3 lossy: codestream and decoded samples "
          f"byte-equal to the oracle's ({got[0].size} shorts, SHA-256), "
          f"PSNR {psnr(dec512, img512):.4f} dB")

    # ---- 9. planar RGB 2048x2560, lossless RCT and lossy ICT -------------
    stamp("9")
    rgb = [make_image(RGB_H, seed=s, width=RGB_W) for s in (5, 6, 7)]
    rgb_src = os.path.join(tmp.name, "rgb.raw")
    for plane in rgb:
        append_raw_frame(rgb_src, plane, np.uint8)

    def rgb_job(lossy):
        enc = os.path.join(tmp.name, f"rgb{int(lossy)}.enc")
        dec = os.path.join(tmp.name, f"rgb{int(lossy)}.raw")
        return enc, dec, (["-i", rgb_src, "-o", enc, "-xSize", str(RGB_W),
                           "-ySize", str(RGB_H), "-isRGB", "1", "-wl",
                           str(LEVELS), "-cp", "2", "-type", str(int(lossy)),
                           "-qs", "1", "-video", "0", "-k", "0",
                           "-LUTFolder", "trained"],
                          ["-i", enc, "-o", dec, "-video", "0", "-LUTFolder",
                           "trained"],
                          f"RGB {'lossy' if lossy else 'lossless'}", "cp2")

    def rgb_cli(lossy):
        enc, dec, job = rgb_job(lossy)
        got = cli_pair(job)
        back = [read_raw_frame(dec, RGB_W, RGB_H, c, np.uint8)
                for c in range(3)]
        return got, back, os.path.getsize(enc)

    cfg_rgb = CodecConfig(width=RGB_W, height=RGB_H, wavelet_levels=LEVELS,
                          is_rgb=True, components=3)
    luts_rgb, params_rgb = cli._load_luts("trained", LEVELS, 2, 0.0)
    cfg_rgb_l = CodecConfig(width=RGB_W, height=RGB_H, wavelet_levels=LEVELS,
                            is_rgb=True, components=3, is_lossy=True, qs=1.0)
    luts_rgb_l, params_rgb_l = cli._load_luts("trained", LEVELS, 2, 0.0,
                                              lossy=True)
    got, back, nbytes = rgb_cli(False)
    _require(all(np.array_equal(b, p) for b, p in zip(back, rgb)),
             "RGB lossless CLI round trip bit-exact")
    print(f"{tag} RGB {RGB_W}x{RGB_H} wl={LEVELS} lossless CLI round trip "
          f"bit-exact, {nbytes} B; kernel launches {got}")
    out = check_planes(f"RGB {RGB_W}x{RGB_H} lossless", cfg_rgb, luts_rgb,
                       params_rgb, rgb, host=False)[0]
    _require(same_planes(back, out), "RGB lossless: CLI == card decode")
    got, back, nbytes = rgb_cli(True)
    dbs = [psnr(b, p) for b, p in zip(back, rgb)]
    _require(min(dbs) > 30.0, f"RGB lossy PSNR {dbs} > 30 dB")
    print(f"{tag} RGB {RGB_W}x{RGB_H} wl={LEVELS} lossy CLI round trip: "
          f"PSNR R {dbs[0]:.4f}, G {dbs[1]:.4f}, B {dbs[2]:.4f} dB, "
          f"{nbytes} B; kernel launches {got}")
    out = check_planes(f"RGB {RGB_W}x{RGB_H} lossy", cfg_rgb_l, luts_rgb_l,
                       params_rgb_l, rgb, host=True)[0]
    _require(same_planes(back, out),
             "RGB lossy: CLI decode == the host-checked card decode")

    # ---- 10. 16-bit gray lossless, 2048^2 --------------------------------
    stamp("10")
    img16 = make_image(SIZE, seed=9, peak=65535)
    dt16 = sample_dtype(16)
    src16 = os.path.join(tmp.name, "in16.raw")
    append_raw_frame(src16, img16, dt16)
    enc16 = os.path.join(tmp.name, "o16.enc")
    dec16 = os.path.join(tmp.name, "d16.raw")
    job16 = (["-i", src16, "-o", enc16, "-xSize", str(SIZE), "-ySize",
              str(SIZE), "-bps", "16", "-wl", str(LEVELS), "-cp", "2",
              "-type", "0", "-video", "0", "-k", "0", "-LUTFolder",
              "neutral"],
             ["-i", enc16, "-o", dec16, "-video", "0", "-LUTFolder",
              "neutral"], "16-bit", "cp2")
    got = cli_pair(job16)
    back16 = read_raw_frame(dec16, SIZE, SIZE, 0, dt16)
    _require(back16.dtype == np.uint16 and np.array_equal(back16, img16),
             "16-bit CLI round trip bit-exact")
    print(f"{tag} {SIZE}^2 16-bit wl={LEVELS} lossless CLI round trip "
          f"bit-exact, {os.path.getsize(enc16)} B; kernel launches {got}")
    cfg16 = CodecConfig(width=SIZE, height=SIZE, wavelet_levels=LEVELS,
                        bit_depth=16, bps=16)
    out = check_planes(f"{SIZE}^2 16-bit plane", cfg16, luts, params,
                       [img16], host=False)[0]
    _require(same_planes([back16], out), "16-bit: CLI == card decode")

    # ---- 11. three coding passes (-cp 3) and -k 5, 2048^2 ----------------
    # gray lossless wl=5, neutral and trained LUTs, each path's launches
    # counted around its own CLI round trip; then lossy wl=3 -k 5 with the
    # trained lossy LUT, held to a CPU TorchCodec as the other lossy paths
    stamp("11")
    new_paths = {}
    for mode, cp, k in (("cp3", 3, 0.0), ("bulk", 2, K)):
        for lut_folder in ("neutral", "trained"):
            enc, dec, job = gray_job(lut_folder, cp=cp, k=k)
            got = cli_pair(job)
            launches[mode] = add(launches[mode], got)
            _require(np.array_equal(read_pgm(dec), img),
                     f"2048^2 -cp {cp} -k {k:g} {lut_folder} CLI round trip "
                     "bit-exact")
            print(f"{tag} {SIZE}^2 wl={LEVELS} -cp {cp} -k {k:g} "
                  f"{lut_folder} LUT CLI round trip bit-exact, "
                  f"{os.path.getsize(enc)} B; kernel launches {got}")
            cfg_m = CodecConfig(width=SIZE, height=SIZE,
                                wavelet_levels=LEVELS, coding_passes=cp,
                                k_factor=k)
            luts_m, params_m = cli._load_luts(lut_folder, LEVELS, cp, k)
            label = f"{SIZE}^2 -cp {cp} -k {k:g} {lut_folder} plane"
            checked = check_planes(label, cfg_m, luts_m, params_m, [img],
                                   host=False, picks=(cp, k, lut_folder))
            _require(same_planes([img], checked[0]),
                     f"{label}: card decode == input")
            if lut_folder == "neutral":
                new_paths[mode] = (cfg_m, luts_m, params_m, job, checked)
    cfg_lk = CodecConfig(width=SIZE, height=SIZE,
                         wavelet_levels=LOSSY_LEVELS, is_lossy=True, qs=1.0,
                         k_factor=K)
    luts_lk, params_lk = cli._load_luts("trained", LOSSY_LEVELS, 2, K,
                                        lossy=True)
    out_lk = check_planes(f"{SIZE}^2 lossy -k {K:g} trained plane", cfg_lk,
                          luts_lk, params_lk, [img], host=True)[0]
    launches["bulk"] = add(launches["bulk"], lossy_cli("trained", out_lk, K))
    print(f"{tag} kernel launches on the -cp 3 paths {launches['cp3']}, on "
          f"the -k {K:g} paths {launches['bulk']}")

    # ---- 12. times of the paths after the main one -----------------------
    stamp("12")
    def path_times(label, cfg, luts, lut_params, planes, job):
        """Layer, device and CLI times of a path; the CLI round trip is the
        two cli.main calls alone (no read-back, no check)."""
        c = TorchCodec(cfg, luts, lut_params, dev)
        smp = [gpu(p) for p in planes]
        mp = cfg.width * cfg.height / 1e6
        blocks, _ = dwt_cuda.forward(smp, cfg)
        coded, n_pl = c.encode_planes(smp)
        dcoded = [(s_, z_, n_pl) for s_, z_ in coded]
        torch.cuda.synchronize()
        layer = {
            "prep+DWT+tile (X2)": device_ms(
                lambda: dwt_cuda.forward(smp, cfg)),
            "BPC encode kernel": device_ms(
                lambda: [bpc_cuda.encode_blocks(b, *c._bpc_args(i),
                                                **c._bpc_kw, n_planes=n_pl)
                         for i, b in enumerate(blocks)]),
            "device pack + D2H packed": host_ms(
                lambda: [pack.pack_streams(s_, z_, None).cpu()
                         for s_, z_ in coded]),
            "BPC decode kernel": device_ms(
                lambda: [bpc_cuda.decode_blocks(s_, z_, *c._bpc_args(i),
                                                **c._bpc_kw, n_planes=n_pl)
                         for i, (s_, z_) in enumerate(coded)]),
            "untile+IDWT+finish (X4)": device_ms(
                lambda: dwt_cuda.reverse(blocks, cfg)),
        }
        for name, v in layer.items():
            report(f"{label} layer {name}", v, rate=False)
        report(f"{label} device encode", host_ms(
            lambda: c.encode_planes(smp)), mp=mp)
        report(f"{label} device decode", host_ms(
            lambda: c.decode_planes(dcoded)), mp=mp)
        report(f"{label} CLI round trip (file -> file -> file)",
               host_ms(lambda: cli_pair(job)), mp=mp)

    path_times(f"lossy {SIZE}^2 wl={LOSSY_LEVELS}", cfg_l, luts_l, params,
               [img], gray_job("neutral", lossy=True)[2])
    path_times(f"RGB {RGB_W}x{RGB_H} lossless", cfg_rgb, luts_rgb,
               params_rgb, rgb, rgb_job(False)[2])
    path_times(f"RGB {RGB_W}x{RGB_H} lossy", cfg_rgb_l, luts_rgb_l,
               params_rgb_l, rgb, rgb_job(True)[2])
    path_times(f"16-bit {SIZE}^2", cfg16, luts, params, [img16], job16)
    for mode, (cfg_m, luts_m, params_m, job, checked) in new_paths.items():
        cp, k = cfg_m.coding_passes, cfg_m.k_factor
        path_times(f"{SIZE}^2 wl={LEVELS} -cp {cp} -k {k:g} neutral", cfg_m,
                   luts_m, params_m, [img], job)
        _, c, blocks_m, coded_m, n_pl = checked
        kernel_times(mode, c, blocks_m[0], *coded_m[0], n_pl)
    path_times(f"lossy {SIZE}^2 wl={LOSSY_LEVELS} -k {K:g} trained", cfg_lk,
               luts_lk, params_lk, [img],
               gray_job("trained", lossy=True, k=K)[2])
    tmp.cleanup()

    # ---- 13. 8192^2 wl=5: 16384 codeblocks, a size that fills the card ---
    stamp("13")
    big = gpu(make_image(BIG))
    big_ms = {}
    for mode, cp, k in (("cp2", 2, 0.0), ("cp3", 3, 0.0), ("bulk", 2, K)):
        cfg_b = CodecConfig(width=BIG, height=BIG, wavelet_levels=LEVELS,
                            coding_passes=cp, k_factor=k)
        luts_b, params_b = cli._load_luts("neutral", LEVELS, cp, k)
        cb = TorchCodec(cfg_b, luts_b, params_b, dev)
        (blocks_b,), mx = dwt_cuda.forward([big], cfg_b)
        n_pl = bpc.planes_for_magnitude(int(mx))
        a, kw = cb._bpc_args(), dict(cb._bpc_kw, n_planes=n_pl)
        s_b, z_b = bpc_cuda.encode_blocks(blocks_b, *a, **kw)
        _require(torch.equal(bpc_cuda.decode_blocks(s_b, z_b, *a, **kw),
                             blocks_b), f"{BIG}^2 {mode}: decode == input")
        # 64 blocks spread over the plane, against the plain coder
        idx = torch.linspace(0, blocks_b.shape[0] - 1, BIG_PICKS,
                             device=dev).long()
        sub = (a[0], *(m[idx] for m in a[1:]))
        s_p, z_p = bpc.encode_blocks_plain(blocks_b[idx], *sub, **kw)
        e = max(int((s_p.long() - s_b[idx].long()).abs().max()),
                int((z_p.long() - z_b[idx].long()).abs().max()))
        err[mode]["encode"] = max(err[mode]["encode"], e)
        _require(e == 0, f"{BIG}^2 {mode}: {BIG_PICKS} picked blocks, "
                 f"encode kernel == plain, max err {e}")
        o_p = bpc.decode_blocks_plain(s_b[idx], z_b[idx], *sub, **kw)
        e = int((o_p.long() - blocks_b[idx].long()).abs().max())
        err[mode]["decode"] = max(err[mode]["decode"], e)
        _require(e == 0, f"{BIG}^2 {mode}: {BIG_PICKS} picked blocks, "
                 f"plain decode of the kernel's streams == input")
        if mode == "cp2":
            pack_check(tag, f"{BIG}^2 wl={LEVELS}", s_b, z_b,
                       pack_header(cfg_b), x3, timed=True)
        bound, by = bpc_cuda.bound_ms(blocks_b)
        big_ms[mode] = {
            "encode": report(f"{BIG}^2 BPC encode kernel {mode}", device_ms(
                lambda: bpc_cuda.encode_blocks(blocks_b, *a, **kw),
                iters=5, per=KERNEL_BATCH), rate=False),
            "decode": report(f"{BIG}^2 BPC decode kernel {mode}", device_ms(
                lambda: bpc_cuda.decode_blocks(s_b, z_b, *a, **kw),
                iters=5, per=KERNEL_BATCH), rate=False)}
        print(f"{tag} {BIG}^2 wl={LEVELS} {mode}: {blocks_b.shape[0]} "
              f"codeblocks, n_planes {n_pl}; kernels' round trip == input, "
              f"{BIG_PICKS} picked blocks byte-equal to plain; bound "
              f"{bound:.4f} ms ({by}), share encode "
              f"{bound / big_ms[mode]['encode']:.4f}, decode "
              f"{bound / big_ms[mode]['decode']:.4f}")
    del big

    # ---- 14. video through the CLI (-video 1), one launch per component
    # and frame batch ------------------------------------------------------
    stamp("14")
    vid = video_phase(dev, tag, err, x3)

    # ---- 15. the distribution layer: sharded images, frame-parallel and
    # multi-host video, every shard on the card ----------------------------
    stamp("15")
    shd = sharded_phase(dev, tag, err, card)

    # ---- 16. the quality tools: QUALITY.md's rows and lut_eval on the
    # card -----------------------------------------------------------------
    stamp("16")
    qual = quality_phase(dev, tag, err)
    print(f"{tag} every phase done {time.perf_counter() - started:.1f} s "
          "after the start")

    # each BPC kernel's bound at the main path's shapes: the same symbols
    # in every mode and direction
    bpc_bound, bpc_by = bpc_cuda.bound_ms(blocks)
    src_dir = "picsong_tpu_torch/csrc"
    jax_src = "picsong_tpu/entropy/bpc_jax.py"
    replaces = {
        ("cp2", "encode"): "picsong_tpu/entropy/bpc_pallas.py:394",
        ("cp2", "decode"): "picsong_tpu/entropy/bpc_pallas.py:707",
        # the cleanup pass's row body (with _spp_row_body's three_cp, :307)
        ("cp3", "encode"): f"{jax_src}:450", ("cp3", "decode"): f"{jax_src}:450",
        # the fused multi-bitplane pass
        ("bulk", "encode"): f"{jax_src}:537", ("bulk", "decode"): f"{jax_src}:537",
    }
    entries = []
    for mode in modes:
        for d in ("encode", "decode"):
            entries.append({
                "name": f"bpc_{d}" + ("" if mode == "cp2" else f"_{mode}"),
                "route": "cuda", "source": f"{src_dir}/bpc_{d}.cu",
                "replaces": replaces[(mode, d)],
                "launches": launches[mode][d], "max_abs_err": err[mode][d],
                "ms": kt[mode][d], "plain_ms": kt[mode][f"{d} plain"],
                "bound_ms": bpc_bound, "bound_by": bpc_by,
                # no single PyTorch call computes BPC-PaCo
                "library_ms": None})
            if mode == "cp2":
                # the video paths' own launches, at their batch's shape
                entries[-1]["video"] = [{
                    "workload": name, "codeblocks": r["kernel"]["codeblocks"],
                    "launches": r["launches"][d],
                    "ms": r["kernel"][f"{d}_ms"],
                    "bound_ms": r["kernel"]["bound_ms"],
                    "bound_by": r["kernel"]["bound_by"]}
                    for name, r in vid.items()]
                # the sharded workloads' own launches, at the shape of a
                # launch of their first shard
                entries[-1]["sharded"] = [{
                    "workload": r["workload"], "shards": r["shards"],
                    "codeblocks": r["codeblocks"],
                    "launches": r["launches"][d], "ms": r[f"{d}_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
                    for r in shd["workloads"]]
                # the quality tools' own launches, at the shape of their
                # natural image's lossless launch
                entries[-1]["quality"] = [{
                    "workload": r["workload"],
                    "codeblocks": r["codeblocks"],
                    "launches": r["launches"][d], "ms": r[f"{d}_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
                    for r in qual]
    # X2/X4 at the main path's shape; launches on its two CLI round trips
    main_dwt = dwt["times"][DWT_TIMED[0]]
    designs = {
        "forward": "16-row and 16-column strips lifted in registers (one "
                   "barrier between the passes), 16-byte sample loads, "
                   "staged 16-byte codeblock stores",
        "reverse": "16-column and 16-row strips lifted in registers (a "
                   "barrier after the load and after each pass), 16-byte "
                   "codeblock loads, staged 16-byte sample stores"}
    for d, line in (("forward", 157), ("reverse", 187)):
        entries.append({
            "name": f"dwt_{d}", "route": "cuda", "design": designs[d],
            "source": f"{src_dir}/dwt_{d}.cu",
            "replaces": f"picsong_tpu/transform/dwt.py:{line}",
            "launches": dwt_launches[d],
            "max_abs_err": max(dwt["err"][d], shd["dwt_err"][d]),
            "ms": main_dwt[f"{d}_ms"], "plain_ms": main_dwt[f"{d}_plain_ms"],
            "device_ms": main_dwt[f"{d}_device_ms"],
            "bound_ms": main_dwt["bound_ms"],
            "bound_by": main_dwt["bound_by"],
            # no single PyTorch call computes a lifting DWT
            "library_ms": None,
            "shapes": [{"workload": label, "ms": t[f"{d}_ms"],
                        "device_ms": t[f"{d}_device_ms"],
                        "plain_ms": t[f"{d}_plain_ms"],
                        "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"]}
                       for label, t in dwt["times"].items()]})
        entries[-1]["levels_ms"] = [
            {"workload": label, "wavelet": wavelet, "ms": levels}
            for (label, wavelet), levels in dwt["split"][d].items()]
        # the shard mode on ShardedCodec's path: one image's launches (a
        # shard and level) and their times, against X2's bound on the image
        entries[-1]["sharded"] = [{
            "workload": r["workload"], "shards": r["shards"],
            "launches": r["launches"], "ms": r[f"{d}_ms"],
            "device_ms": r[f"{d}_device_ms"], "plain_ms": r[f"{d}_plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
            for r in shd["dwt"]]
    # X3 at the main path's streams; launches on its two CLI round trips
    main_x3 = x3["times"][f"{SIZE}^2 wl={LEVELS} main path"]
    for d, line in (("pack", 1818), ("unpack", 1832)):
        t = main_x3[d]
        entries.append({
            "name": d, "route": "cuda", "source": f"{src_dir}/pack.cu",
            "replaces": f"{jax_src}:{line}",
            "launches": pack_launches[d], "max_abs_err": x3["err"][d],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "device_ms": t["device_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            # no single PyTorch call computes the relocation
            "library_ms": None,
            "shapes": [{"workload": label, "codeblocks": v["codeblocks"],
                        "payload": v["payload"], "ms": v[d]["ms"],
                        "device_ms": v[d]["device_ms"],
                        "plain_ms": v[d]["plain_ms"],
                        "bound_ms": v[d]["bound_ms"],
                        "bound_by": v[d]["bound_by"]}
                       for label, v in x3["times"].items()]})
    for name, line in (("probe", 58), ("probe2", 54)):
        bound, by = pt[name + " bound"]
        entries.append({
            "name": name, "route": "cuda", "source": f"{src_dir}/{name}.cu",
            "replaces": f"tools/pallas_{name}.py:{line}",
            "launches": probe_launches[name], "max_abs_err": perr[name],
            "ms": pt[name], "plain_ms": pt[name + " plain"],
            "device_ms": pt[name + " device"], "launch_floor_ms": floor,
            "graph_floor_ms": graph_floor,
            "bound_ms": bound, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
