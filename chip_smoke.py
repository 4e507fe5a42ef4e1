#!/usr/bin/env python3
"""The card's byte gate for the PyTorch/CUDA port (picsong_tpu_torch), on
one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from picsong_tpu_torch/csrc with nvcc (one
compiler per source, in parallel), then checks on the card, with nothing
of JAX or of the JAX package `picsong_tpu` imported:
- the BPC kernels K1/K2 byte-equal to the plain coder on random and edge
  batches of all three modes (cp2, cp3, and bulk for k > 0);
- X2 and X4 (`dwt_phase`) byte-equal to their plain versions (codeblocks,
  maximum, samples) in every case of DWT_CASES, and on the views of
  DWT_OFFSET (their scalar- and word-load variants); lossless round trips
  exact;
- codestreams and codeblocks equal to the NumPy oracle's SHA-256 digests
  recorded in picsong_tpu_torch/tools/goldens.py (which
  tests/test_torch_goldens.py regenerates from the oracle; the inputs'
  digests are checked first): 512^2 wl=1 in every mode, 512^2 wl=3 lossy,
  and one codeblock of every level and subband of the 2048^2 planes;
- CLI round trips at 2048^2: gray lossless with the neutral and trained
  LUTs (the main path), lossy 9/7 wl=3 qs 1, -cp 3, -k 5 (lossless and
  lossy), 16-bit, planar RGB 2048x2560 lossless and lossy. Each launches
  X2, X4, X3's pack and unpack and its mode's BPC kernels and no other
  mode's (counts reset before it, read after); lossless ones are
  bit-exact, lossy ones above a PSNR floor and equal to the card's decode,
  which is held to the host's; every component's BPC kernels equal the
  plain coder at the path's n_planes and LUT;
- X3 (`pack_phase`, `pack_check`) byte-equal to its plain version on
  random and edge batches, views off 16-byte alignment, and the main
  path's, a video batch's and 8192^2's streams;
- the probes K3/K4 against their plain versions, and their entry points;
- the main path's trace (`busy_phase`): it holds device spans and names
  every span of the codec's layers;
- 8192^2 wl=5 in all three modes: the kernels' round trip and BIG_PICKS
  blocks against the plain coder;
- video through the CLI (`video_phase`), the distribution layer
  (`sharded_phase`: sharded images, frame-parallel and multi-host video)
  and the quality tools (`quality_phase`), each byte-equal to its
  unsharded or recorded result, with its launch counts.
Every comparison is exact but the lossy PSNR floors, which are stated
where they are checked. It times nothing but its phases' starts:
`tools/kernel_ab.py` times a kernel against another tree's, and
`benchmark/run.py` the system.

Exits non-zero, printing no result, when there is no CUDA device or any
check fails. Otherwise its last two lines are the card's name and power
limit, then {"ok": true, "device": {"platform": "gpu", ...}}.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

SIZE = 2048
LEVELS = 5
LOSSY_LEVELS = 3              # BASELINE config 2
RGB_W, RGB_H = 2048, 2560     # the reference's image workload
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


def dwt_phase(dev, tag: str) -> None:
    """X2 and X4 (`transform/dwt_cuda.py`) against their plain versions on
    the card in every case of DWT_CASES: the kernels' codeblocks, maximum
    and samples byte-equal to the torch ops' on the same inputs (X4 on the
    kernels' codeblocks), lossless samples equal to the input; then on the
    views of DWT_OFFSET."""
    import numpy as np
    import torch

    from picsong_tpu_torch.core.header import CodecConfig
    from picsong_tpu_torch.tools import goldens
    from picsong_tpu_torch.transform import dwt_cuda

    started = time.perf_counter()
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
        _require(e == 0, f"dwt {label}: X2 kernel == plain (codeblocks, "
                 f"maximum), max abs err {e}")
        back = dwt_cuda.reverse(blocks, cfg)
        back_p = dwt_cuda.reverse_plain(blocks, cfg)
        torch.cuda.synchronize()
        e = max(diff(b, p) for b, p in zip(back, back_p))
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
        _require(e == 0, f"dwt {label} codeblocks offset by {skip}: X4 "
                 f"kernel == plain (samples), max abs err {e}")
    print(f"{tag} DWT phase: X2 and X4 byte-equal to their plain versions "
          f"in {len(DWT_CASES)} cases and on {len(DWT_OFFSET)} "
          "16-byte-misaligned view(s) each, lossless round trips exact; "
          f"{time.perf_counter() - started:.1f} s")


def pack_check(label: str, streams, sizes, header,
               views: bool = False) -> None:
    """X3 (`assembly/pack.py`) on one batch of streams on the card: the
    kernels' codestream (with `header`, with the filler, with the payload
    given) and their unpack of it (streams and sizes) byte-equal to the
    plain version on the same card tensors; the unpack equal to the
    streams and sizes packed. With `views`, also the unpack of the
    codestream held in views 1..7 shorts past a 16-byte boundary (as
    `join_frames` and the sharded uploads may hand it over)."""
    import torch

    from picsong_tpu_torch.assembly import pack

    def diff(a, b) -> int:
        _require(a.shape == b.shape, f"X3 {label}: shapes {tuple(a.shape)} "
                 f"and {tuple(b.shape)}")
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    n = streams.shape[0]
    payload = int(sizes.long().sum()) - n
    for h, p in ((header, None), (None, None), (header, payload)):
        got = pack.pack_streams(streams, sizes, h, payload=p)
        e = diff(got, pack.pack_streams_plain(streams, sizes, h, p))
        _require(e == 0, f"X3 {label}: pack kernel == plain (header "
                 f"{h is not None}, payload given {p is not None}), max abs "
                 f"err {e}")
    back = pack.unpack_streams(got, n, payload)
    want = pack.unpack_streams_plain(got, n, payload)
    torch.cuda.synchronize()
    e = max(diff(a, b) for a, b in zip(back, want))
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
        _require(e == 0 and torch.equal(back[0], streams),
                 f"X3 {label}: unpack of a view {k} shorts past a 16-byte "
                 f"boundary == plain, max abs err {e}")


def pack_phase(dev, tag: str) -> None:
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
        pack_check(f"{kind} N={n}", torch.from_numpy(streams).to(dev),
                   torch.from_numpy(sizes).to(dev), header,
                   views=kind in ("mixed", "alignments"))
    print(f"{tag} X3 pack phase: {seed + 1} random and edge batches "
          "byte-equal to the plain version both ways; "
          f"{time.perf_counter() - started:.1f} s")


# the video workloads: (name, width, height, frames, batch, RGB, LUT
# folders); the first folder's run also goes through the engine's API
VIDEO = (
    # the README's video example and BASELINE config 4
    ("1080p gray", 1920, 1080, 100, 8, False,
     ("neutral", "trained_video_lossless")),
    # the reference's video workload (4096x2048 RGB), at 16 of its frames
    ("4096x2048 RGB", 4096, 2048, 16, 4, True, ("trained_video_lossless",)),
)


def video_phase(dev, tag: str) -> None:
    """Each VIDEO workload, lossless wl=LEVELS, through `cli.main -video 1`:
    inputs from `goldens.make_frame` (a seed, integer arithmetic); for
    each LUT folder, one BPC encode and one decode launch per component
    and batch, and one X3 pack a BPC encode launch and one unpack a decode
    launch (counts reset before each CLI call and read after it); the
    decoded file equal to the input; every frame's codestream equal to
    `TorchCodec.encode` of that frame. With the first folder: the kernels
    on the first batch's codeblocks (component 0, B * ncb blocks) in a
    round trip and on BIG_PICKS blocks spread over the batch held to the
    plain coder; an encode -> decode through the engine's API equal to the
    CLI's files; on the first workload, X3 (`pack_check`) on the first
    batch's streams and torch.profiler's record of device work over one
    encode."""
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

    for name, w, h, n, batch, rgb, folders in VIDEO:
        n_comp = 3 if rgb else 1
        n_batches = -(-n // batch)
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
            for d, argv in (("encode", ["-i", raw, "-o", enc, *geo, "-wl",
                                        str(LEVELS), "-frames", str(n)]),
                            ("decode", ["-i", enc, "-o", dec])):
                bpc_cuda.reset_launches()
                pack.reset_launches()
                _require(cli.main(["-cd", "0" if d == "encode" else "1",
                                   *argv, "-video", "1", "-numberOfStreams",
                                   str(batch), "-LUTFolder", lut,
                                   "--device", str(dev)]) == 0,
                         f"{label}: CLI {d}")
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
            print(f"{tag} {label}: {n} frames, batch {batch}, "
                  f"{os.path.getsize(enc)} B; round trip bit-exact; every "
                  "frame's codestream == TorchCodec.encode of the frame; "
                  f"BPC and X3 launches {n_batches * n_comp} per direction "
                  f"({n_comp} per batch)")
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
            _require(e == 0, f"{label}: {BIG_PICKS} picked blocks of a batch, "
                     f"encode kernel == plain, max err {e}")
            o_p = bpc.decode_blocks_plain(s_k[idx], z_k[idx], *sub, **kw)
            e = int((o_p.long() - blocks[idx].long()).abs().max())
            _require(e == 0, f"{label}: {BIG_PICKS} picked blocks, plain "
                     "decode of the kernel's streams == input")
            if name == VIDEO[0][0]:
                pack_check(f"video {name} batch of {batch}", s_k, z_k, None)
            print(f"{tag} {label}: {blocks.shape[0]} codeblocks a launch, "
                  f"n_planes {n_pl}; kernels' round trip == input, "
                  f"{BIG_PICKS} picked blocks byte-equal to plain")
            del blocks, s_k, z_k, bc
            # the engine's API: the CLI's bytes both ways
            enc2 = os.path.join(tmp.name, "api.enc")
            dec2 = os.path.join(tmp.name, "api.raw")
            video.encode_video(raw, enc2, cfg, luts, params, n, batch=batch,
                               device=dev)
            _require(read(enc2) == read(enc), f"{label}: API == CLI bytes")
            video.decode_video(enc2, dec2, cfg, luts, params, batch=batch,
                               device=dev)
            _require(read(dec2) == read(raw), f"{label}: API decode")
            if name == VIDEO[0][0]:
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    video.encode_video(raw, enc2, cfg, luts, params, n,
                                       batch=batch, device=dev)
                _require(busy_ms(prof)[1] > 0, f"{label}: torch.profiler "
                         "recorded device activity")
            print(f"{tag} {label}: the engine's API gives the CLI's files"
                  + ("; torch.profiler records its device work"
                     if name == VIDEO[0][0] else ""))
        tmp.cleanup()


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
    DIR/in.raw (lossless, neutral LUT) on DEVICE, and prints its launches
    as one JSON line after "MULTIHOST "."""
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
        bpc_cuda.reset_launches()
        pack.reset_launches()
        mh.encode_video_multihost(f"{d}/in.raw", f"{d}/mh.enc", cfg, luts,
                                  params, n, batch=batch, device=device)
        enc_launches = bpc_cuda.ENCODE_LAUNCHES["cp2"]
        mh.decode_video_multihost(f"{d}/mh.enc", f"{d}/mh.raw", cfg, luts,
                                  params, batch=batch, device=device)
        print("MULTIHOST " + json.dumps({
            "rank": rank,
            "launches": {"encode": enc_launches,
                         "decode": bpc_cuda.DECODE_LAUNCHES["cp2"]},
            "x3_launches": {"pack": pack.PACK_LAUNCHES,
                            "unpack": pack.UNPACK_LAUNCHES}}))
    finally:
        dist.destroy_process_group()
    return 0


def shard_checks(label: str, calls) -> None:
    """Each shard-mode call in `calls` (`recording`'s of X2's and X4's
    `forward_shard` / `reverse_shard`) again on its inputs, and on copies
    of them one value past a 16-byte boundary, == its plain version on
    the same inputs."""
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


def sharded_phase(dev, tag: str) -> None:
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
      rows or samples); the BPC kernels' round trip on shard 0's
      codeblocks and, on 2 lossless shards, BIG_PICKS of them held to the
      plain coder;
    - the CLI's -sharded 2 round trip at 2048^2 wl=5: the unsharded CLI's
      file, a bit-exact decode, 2 BPC launches and 10 of X2's and X4's
      shard modes a direction;
    - 1080p video, SHARDED_VIDEO frames, devices=2 against devices=1:
      equal files and `_SIZE`, bit-exact decodes, one launch per share
      and batch, the kernels' round trip on a share's batch;
    - multi-host: HOSTS processes in a gloo group on the card
      (`multihost_worker`): the merged file equal to the single-host one,
      the merged decode to the input, one launch per slab batch, and the
      kernels' round trip on a worker's batch."""
    import numpy as np
    import torch

    from picsong_tpu_torch.assembly import pack
    from picsong_tpu_torch.core.header import CodecConfig
    from picsong_tpu_torch.core.image_io import (mirror_pad, read_pgm,
                                                 write_pgm)
    from picsong_tpu_torch.dist.sharded import (ShardedCodec, placement,
                                                shares)
    from picsong_tpu_torch.engine import cli, video
    from picsong_tpu_torch.engine.batch import BatchCodec
    from picsong_tpu_torch.engine.pipeline import TorchCodec
    from picsong_tpu_torch.entropy import bpc, bpc_cuda
    from picsong_tpu_torch.tools import goldens
    from picsong_tpu_torch.transform import dwt, dwt_cuda

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    def kernels_at(label, blocks, args, kw, picks=False):
        """The cp2 kernels on these blocks: round trip (a raw copy, size
        4096, keeps 16-bit words, as in the reference: those blocks are
        held to the plain decoder of the same streams, as
        tests/test_torch_cuda.py does), optionally BIG_PICKS blocks
        against the plain coder."""
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
            _require(e == 0, f"{label}: picked blocks, encode == plain")
            o_p = bpc.decode_blocks_plain(s_k[idx], z_k[idx], *sub, **kw)
            e = int((o_p.long() - blocks[idx].long()).abs().max())
            _require(e == 0, f"{label}: picked blocks, plain decode == input")

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
        shard_checks(label, calls)
        del calls
        blocks, tops = codec.tile_planes(codec.upload(pixels))
        s0 = codec.blocks[0][0]
        kw = dict(codec._kw, n_planes=codec._n_planes(tops))
        kernels_at(label, blocks[0][0], codec._bpc_args(s0, 0), kw,
                   picks=(n == 2 and not c.is_lossy))
        print(f"{tag} {label} ({placement(codec.devices)}, rows "
              f"{[r1 - r0 for r0, r1 in codec.rows]}, levels by shards "
              f"{[len(sp) for sp in codec._plan]}): "
              f"{sum(g.size for g in got)} shorts == the unsharded card "
              f"codestream; decode == unsharded"
              + ("" if c.is_lossy else " == input")
              + f"; launches {enc['cp2']} / {dec['cp2']} (shards x "
              f"components); shard 0's kernels' round trip; X2 / X4 shard "
              f"modes: {level_launches} launches each way, byte-equal to "
              "plain (and off 16 bytes); no torch-op lifting")

    # the CLI -sharded 2 at 2048^2 wl=5 against the unsharded CLI
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
    print(f"{tag} CLI -sharded 2 {SIZE}^2 wl={LEVELS}: file == the "
          "unsharded CLI file, round trip bit-exact, BPC launches 2 / 2, "
          f"X2 / X4 shard modes {x24[0]} / {x24[1]}")
    tmp.cleanup()

    # 1080p video: devices=2 against devices=1
    w, h, n, batch = SHARDED_VIDEO
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    raw = os.path.join(d, "in.raw")
    with open(raw, "wb") as f:
        for i in range(n):
            f.write(goldens.make_frame(h, w, i).tobytes())
    vcfg = CodecConfig(width=w, height=h, wavelet_levels=LEVELS, frames=n)
    n_batches = -(-n // batch)
    for devices in (1, 2):
        enc = os.path.join(d, f"v{devices}.enc")
        dec = os.path.join(d, f"v{devices}.raw")
        bpc_cuda.reset_launches()
        pack.reset_launches()
        video.encode_video(raw, enc, vcfg, luts, params, n, batch=batch,
                           devices=[dev] * devices)
        only_cp2(dict(bpc_cuda.ENCODE_LAUNCHES), n_batches * devices,
                 f"video devices={devices} encode")
        video.decode_video(enc, dec, vcfg, luts, params, batch=batch,
                           devices=[dev] * devices)
        only_cp2(dict(bpc_cuda.DECODE_LAUNCHES), n_batches * devices,
                 f"video devices={devices} decode")
        x3_as_bpc(f"video devices={devices}")
        _require(read(dec) == read(raw),
                 f"video devices={devices}: decode bit-exact")
    v1, v2 = (os.path.join(d, f"v{k}.enc") for k in (1, 2))
    _require(read(v1) == read(v2) and read(v1 + "_SIZE")
             == read(v2 + "_SIZE"), "video devices=2 file == devices=1")
    print(f"{tag} video {w}x{h} {n} frames batch {batch}: devices=2 file "
          "== devices=1, decodes bit-exact, launches "
          f"{n_batches} / {2 * n_batches} a direction")

    def frames(count):
        """The first `count` frames, padded, on the card."""
        return torch.from_numpy(np.stack([mirror_pad(
            goldens.make_frame(h, w, i), bc.aw, bc.ah)
            for i in range(count)])).to(dev)

    share = batch // 2
    bc = BatchCodec(vcfg, luts, params, share, dev)
    (vblocks,), mx = bc.prep_batch(frames(share))
    kernels_at("video share", vblocks, bc._bpc_args(0),
               dict(bc.codec._bpc_kw,
                    n_planes=bpc.planes_for_magnitude(int(mx))))

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
    tmp.cleanup()
    # the workers' launches code a batch of `batch` frames
    bc = BatchCodec(vcfg, luts, params, batch, dev)
    (vblocks,), mx = bc.prep_batch(frames(batch))
    kernels_at("multi-host batch", vblocks, bc._bpc_args(0),
               dict(bc.codec._bpc_kw,
                    n_planes=bpc.planes_for_magnitude(int(mx))))
    print(f"{tag} multi-host: merged file == single-host, merged decode == "
          f"input; launches {launches} over {HOSTS} processes")


def quality_phase(dev, tag: str) -> None:
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
    lossy qs 1."""
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
            _require(e == 0, f"quality {spec}: encode kernel == plain on "
                     f"{idx.numel()} codeblocks, max err {e}")
            o_p = bpc.decode_blocks_plain(s_k[idx], z_k[idx], *sub, **kw)
            e = int((o_p.long() - blocks[idx].long()).abs().max())
            _require(e == 0, f"quality {spec}: plain decode of the kernel's "
                     f"streams == input on {idx.numel()} codeblocks")
        print(f"{tag} quality {size}^2 natural: kernels == plain on "
              f"{idx.numel()} codeblocks of {blocks.shape[0]} (lossless "
              "trained and lossy qs 1)")


def busy_phase(dev, tag: str, codec, img, cli_round_trip) -> None:
    """The main path's trace: `device_trace` over one TorchCodec encode +
    decode of `img` and over one CLI round trip (`cli_round_trip()`), each
    after an untraced and a traced warm-up (CUPTI's first use costs
    seconds); a trace without device spans, or without every span of the
    codec's layers, fails."""
    import torch

    from picsong_tpu_torch.obs.trace import busy_ms, device_trace

    def api_round_trip():
        codec.decode(codec.encode(img))

    want = {"picsong/encode", "picsong/encode.upload",
            "picsong/encode_planes", "picsong/x2", "picsong/x2.read_max",
            "picsong/k1", "picsong/x3.pack", "picsong/x3.pack.read_total",
            "picsong/encode.download", "picsong/decode",
            "picsong/decode.upload", "picsong/x3.unpack",
            "picsong/decode_planes", "picsong/k2", "picsong/x4",
            "picsong/decode.download"}
    tmp = tempfile.TemporaryDirectory()
    for label, fn in (("TorchCodec encode + decode", api_round_trip),
                      ("CLI round trip", cli_round_trip)):
        fn()
        with device_trace(os.path.join(tmp.name, "warm"), dev):
            fn()
        log_dir = os.path.join(tmp.name, label.split()[0])
        with device_trace(log_dir, dev) as prof:
            fn()
            torch.cuda.synchronize()
        n_spans = busy_ms(prof)[1]
        _require(n_spans > 0, f"{label}: the trace holds device spans")
        (trace,) = os.listdir(log_dir)
        with open(os.path.join(log_dir, trace)) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        _require(want <= names, f"{label}: the trace names the codec's "
                 "spans")
        print(f"{tag} trace of the {label} {SIZE}^2 wl={LEVELS} lossless: "
              f"{n_spans} kernel and copy spans; the trace names the "
              "codec's spans")
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
    from picsong_tpu_torch.tools import goldens, probe, probe2
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
          "byte-equal to plain, decode == input")

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
          "LUTs; kernels byte-equal to plain, decode == input")

    # ---- 3b. X2/X4 vs plain: the DWT phase --------------------------------
    stamp("3b")
    dwt_phase(dev, tag)

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
        """One CLI encode and decode. Sets every BPC, DWT and X3 launch count to 0 first, reads
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

    exact, enc_bytes, launched = {}, {}, {}
    for lut_folder in ("neutral", "trained"):
        enc, dec, job = gray_job(lut_folder)
        launched[lut_folder] = cli_pair(job)
        exact[lut_folder] = np.array_equal(read_pgm(dec), img)
        enc_bytes[lut_folder] = os.path.getsize(enc)
    _require(all(exact.values()), f"2048^2 CLI round trips bit-exact {exact}")
    print(f"{tag} {SIZE}^2 wl={LEVELS} CLI round trips bit-exact: neutral "
          f"{enc_bytes['neutral']} B, trained {enc_bytes['trained']} B; "
          f"kernel launches on the main path: {launched}")

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
    pack_phase(dev, tag)
    pack_check(f"{SIZE}^2 wl={LEVELS} main path", streams, sizes,
               pack_header(cfg))

    # ---- 6. the main path's codestream and trace ------------------------
    # the codestream is packed and unpacked on the card, so only its
    # packed bytes cross PCIe
    stamp("6")
    packed = pack.pack_streams(streams, sizes, pack_header(cfg))
    shorts = packed.cpu().numpy().view(np.uint16)
    _require(np.array_equal(shorts, codec.encode(img)[0])
             and shorts.size == pack.stream_length(
                 codec.ncb, int(sizes.sum()) - codec.ncb),
             "TorchCodec.encode downloads the packed codestream alone")
    payload = int(pack.block_fields(shorts, codec.ncb)[1].sum()) - codec.ncb
    s_back, z_back = pack.unpack_streams(packed, codec.ncb, payload)
    _require(torch.equal(s_back, streams) and torch.equal(z_back, sizes),
             "device unpack == the kernel's streams and sizes")
    print(f"{tag} packed codestream {shorts.nbytes} B crosses PCIe each "
          f"way (the raw stream buffers: {streams.nbytes + sizes.nbytes} B)")
    busy_phase(dev, tag, codec, img,
               lambda: cli_pair(gray_job("neutral")[2]))

    # ---- 7. probes K3/K4: kernel vs plain, then their entry points -------
    stamp("7")
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
            _require(e == 0, f"{name} kernel == plain ({what}), max err {e}")
            _require(torch.equal(got_p.cpu(), module.plain(
                *(torch.from_numpy(a) for a in args))),
                f"{name} plain on the card == plain on the host ({what})")
        print(f"{tag} {name}: kernel == plain on its inputs, seed 1, edge "
              "inputs and views one word off 16-byte alignment")
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
        planes."""
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
        return [o.numpy() for o in out]

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
                         [img], host=True)
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
                       params_rgb, rgb, host=False)
    _require(same_planes(back, out), "RGB lossless: CLI == card decode")
    got, back, nbytes = rgb_cli(True)
    dbs = [psnr(b, p) for b, p in zip(back, rgb)]
    _require(min(dbs) > 30.0, f"RGB lossy PSNR {dbs} > 30 dB")
    print(f"{tag} RGB {RGB_W}x{RGB_H} wl={LEVELS} lossy CLI round trip: "
          f"PSNR R {dbs[0]:.4f}, G {dbs[1]:.4f}, B {dbs[2]:.4f} dB, "
          f"{nbytes} B; kernel launches {got}")
    out = check_planes(f"RGB {RGB_W}x{RGB_H} lossy", cfg_rgb_l, luts_rgb_l,
                       params_rgb_l, rgb, host=True)
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
                       [img16], host=False)
    _require(same_planes([back16], out), "16-bit: CLI == card decode")

    # ---- 11. three coding passes (-cp 3) and -k 5, 2048^2 ----------------
    # gray lossless wl=5, neutral and trained LUTs, each path's launches
    # counted around its own CLI round trip; then lossy wl=3 -k 5 with the
    # trained lossy LUT, held to a CPU TorchCodec as the other lossy paths
    stamp("11")
    for cp, k in ((3, 0.0), (2, K)):
        for lut_folder in ("neutral", "trained"):
            enc, dec, job = gray_job(lut_folder, cp=cp, k=k)
            got = cli_pair(job)
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
            _require(same_planes([img], checked),
                     f"{label}: card decode == input")
    cfg_lk = CodecConfig(width=SIZE, height=SIZE,
                         wavelet_levels=LOSSY_LEVELS, is_lossy=True, qs=1.0,
                         k_factor=K)
    luts_lk, params_lk = cli._load_luts("trained", LOSSY_LEVELS, 2, K,
                                        lossy=True)
    out_lk = check_planes(f"{SIZE}^2 lossy -k {K:g} trained plane", cfg_lk,
                          luts_lk, params_lk, [img], host=True)
    lossy_cli("trained", out_lk, K)
    tmp.cleanup()

    # ---- 13. 8192^2 wl=5: 16384 codeblocks, a size that fills the card ---
    stamp("13")
    big = gpu(make_image(BIG))
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
        _require(e == 0, f"{BIG}^2 {mode}: {BIG_PICKS} picked blocks, "
                 f"encode kernel == plain, max err {e}")
        o_p = bpc.decode_blocks_plain(s_b[idx], z_b[idx], *sub, **kw)
        e = int((o_p.long() - blocks_b[idx].long()).abs().max())
        _require(e == 0, f"{BIG}^2 {mode}: {BIG_PICKS} picked blocks, "
                 f"plain decode of the kernel's streams == input")
        if mode == "cp2":
            pack_check(f"{BIG}^2 wl={LEVELS}", s_b, z_b, pack_header(cfg_b))
        print(f"{tag} {BIG}^2 wl={LEVELS} {mode}: {blocks_b.shape[0]} "
              f"codeblocks, n_planes {n_pl}; kernels' round trip == input, "
              f"{BIG_PICKS} picked blocks byte-equal to plain")
    del big

    # ---- 14. video through the CLI (-video 1), one launch per component
    # and frame batch ------------------------------------------------------
    stamp("14")
    video_phase(dev, tag)

    # ---- 15. the distribution layer: sharded images, frame-parallel and
    # multi-host video, every shard on the card ----------------------------
    stamp("15")
    sharded_phase(dev, tag)

    # ---- 16. the quality tools: QUALITY.md's rows and lut_eval on the
    # card -----------------------------------------------------------------
    stamp("16")
    quality_phase(dev, tag)
    print(f"{tag} every phase done {time.perf_counter() - started:.1f} s "
          "after the start")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
