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
- gray lossless 5/3, 2048x2048 at 5 wavelet levels, neutral and trained
  LUTs (the main path; then every layer of it is timed);
- the two probe kernels against their plain versions on the probes' own
  and on edge inputs, then the probe entry points;
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
on each path after the main one it also holds the BPC kernels equal to
their plain versions on every component's codeblocks, at the path's
n_planes and with the component's LUT; on the lossy ones it holds the
card's quantized codeblocks, inverse DWT and decoded samples equal to a
CPU TorchCodec's, and the CLI's decoded file equal to those samples. Then
it times the device halves and CLI round trips of the paths (the two
cli.main calls alone) and each kernel variant against its plain version.
Every comparison is exact except the lossy PSNR floors, which are stated
where they are checked. The main path's layers include the device pack
and unpack of the codestream (assembly/pack.py): only the packed bytes
cross PCIe.

Exits non-zero, printing no result, when there is no CUDA device or any
check fails. Otherwise its last three lines are a JSON object with each
kernel's launches, error, times and bound (the larger of its bytes over
3.35 TB/s and its int32 operations over 16.7 Tops/s: bpc_cuda.bound_ms,
probe.bound_ms, probe2.bound_ms), the card's name and power limit, then
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

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
PLAIN_ITERS = 3               # the plain BPC coder takes seconds a call
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


def main() -> int:
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

    # ---- 2. build --------------------------------------------------------
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

    # ---- 4. oracle check at BASELINE config 1 (512^2, wl=1) ---------------
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
    img = make_image(SIZE)
    tmp = tempfile.TemporaryDirectory()
    src = os.path.join(tmp.name, "in.pgm")
    write_pgm(src, img)

    def cli_pair(job):
        """One CLI encode and decode (the timed round trip: no read-back, no
        check). Sets every BPC launch count to 0 first, reads them after,
        and returns the launches of the job's mode; no other mode may have
        launched."""
        enc_args, dec_args, what, mode = job
        bpc_cuda.reset_launches()
        _require(cli.main(["-cd", "0", *enc_args]) == 0, f"CLI encode {what}")
        _require(cli.main(["-cd", "1", *dec_args]) == 0, f"CLI decode {what}")
        got = {"encode": bpc_cuda.ENCODE_LAUNCHES[mode],
               "decode": bpc_cuda.DECODE_LAUNCHES[mode]}
        _require(got["encode"] > 0 and got["decode"] > 0,
                 f"{what} path launched both {mode} BPC kernels {got}")
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
    exact, enc_bytes = {}, {}
    for lut_folder in ("neutral", "trained"):
        enc, dec, job = gray_job(lut_folder)
        launches["cp2"] = add(launches["cp2"], cli_pair(job))
        exact[lut_folder] = np.array_equal(read_pgm(dec), img)
        enc_bytes[lut_folder] = os.path.getsize(enc)
    _require(all(exact.values()), f"2048^2 CLI round trips bit-exact {exact}")
    print(f"{tag} {SIZE}^2 wl={LEVELS} CLI round trips bit-exact: neutral "
          f"{enc_bytes['neutral']} B, trained {enc_bytes['trained']} B; "
          f"kernel launches on the main path {launches['cp2']}")

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
    blocks, max_mag = codec._dwt_tile_impl(codec._prep_gray_impl(samples))
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

    # ---- 6. times ----------------------------------------------------------
    mpix = SIZE * SIZE / 1e6

    def device_ms(fn, iters=ITERS, warm=2, per=1):
        """CUDA-event times of `fn`; with `per` > 1, of `per` back-to-back
        calls divided by `per`, which keeps the wrapper's host time out of
        a kernel's time."""
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
    report(f"CLI round trip {SIZE}^2 wl={LEVELS} neutral LUT "
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
        "prep+DWT+tile": device_ms(
            lambda: codec._dwt_tile_impl(codec._prep_gray_impl(samples))),
        "BPC encode kernel": enc_kernel,
        "device pack (one scalar read)": host_ms(
            lambda: pack.pack_streams(streams, sizes, header)),
        "D2H packed codestream": host_ms(lambda: packed.cpu()),
        "H2D packed codestream": host_ms(
            lambda: torch.from_numpy(shorts.view(np.int16)).to(dev)),
        "device unpack": device_ms(
            lambda: pack.unpack_streams(packed, codec.ncb, payload)),
        "BPC decode kernel": dec_kernel,
        "untile+IDWT+clamp": device_ms(
            lambda: codec._finish_gray_impl(codec._untile_idwt_impl(blocks))),
    }
    for name, times in layers.items():
        report(f"layer {name}", times, rate=False)
    print(f"{tag} packed codestream {shorts.nbytes} B crosses PCIe each "
          f"way (the raw stream buffers: {streams.nbytes + sizes.nbytes} B)")

    # ---- 7. probes K3/K4: kernel vs plain, then their entry points -------
    perr = {"probe": 0, "probe2": 0}
    pt = {}
    for name, module in (("probe", probe), ("probe2", probe2)):
        for what, args in (("probe inputs", module.inputs(0)),
                           ("seed 1", module.inputs(1)),
                           ("edge inputs", module.edge_inputs())):
            dargs = [gpu(a) for a in args]
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
        print(f"{tag} {name}: kernel {pt[name]:.6f} ms/call, plain "
              f"{pt[name + ' plain']:.6f} ms/call (max abs err "
              f"{perr[name]})")
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
    def check_planes(label, cfg, luts, lut_params, planes, host,
                     picks=None):
        """A path's planes on the card: each component's BPC kernels against
        their plain versions at the path's shapes, n_planes and LUT; with
        `host`, also the card's quantized codeblocks, inverse DWT and decoded
        samples against a CPU TorchCodec's; with `picks`, one codeblock of
        every band against the oracle's digests of the `picks` key =
        (coding passes, k, LUT folder). Returns the decoded planes, the
        codec, its codeblocks and streams per component, and n_planes."""
        c = TorchCodec(cfg, luts, lut_params, dev)
        tiled = [c._dwt_tile_impl(x)
                 for x in c._prep_impl([gpu(p) for p in planes])]
        n_pl = bpc.planes_for_magnitude(max(int(m) for _, m in tiled))
        coded = []
        for i, (blocks, _) in enumerate(tiled):
            what = f"{label} component {i}"
            s_, z_ = compare_encode(blocks, c._bpc_args(i), c._bpc_kw, n_pl,
                                    what)
            compare_decode(s_, z_, c._bpc_args(i), c._bpc_kw, n_pl, blocks,
                           what)
            coded.append((s_, z_))
        n_picks = (oracle_picks(label, c, tiled[0][0], *coded[0], picks)
                   if picks else 0)
        comps = [c._untile_idwt_impl(b) for b, _ in tiled]
        out = [o.cpu() for o in c._finish_impl(comps)]
        if host:
            h = TorchCodec(cfg, luts, lut_params, "cpu")
            tiled_h = [h._dwt_tile_impl(x) for x in h._prep_impl(
                [torch.from_numpy(p) for p in planes])]
            comps_h = [h._untile_idwt_impl(b) for b, _ in tiled_h]
            out_h = h._finish_impl(comps_h)
            for i in range(len(tiled)):
                what = f"{label} component {i}"
                _require(torch.equal(tiled[i][0].cpu(), tiled_h[i][0]),
                         f"{what}: quantized codeblocks card == host")
                _require(torch.equal(comps[i].cpu(), comps_h[i]),
                         f"{what}: inverse DWT card == host, max abs diff "
                         f"{float((comps[i].cpu() - comps_h[i]).abs().max())}")
                mism = int((out[i] != out_h[i]).sum())
                _require(mism == 0,
                         f"{what}: decoded samples card == host ({mism} differ)")
        print(f"{tag} {label}: {len(tiled)} x {tiled[0][0].shape[0]} "
              f"codeblocks, n_planes {n_pl}; kernels byte-equal to plain on "
              "every component" + ("; quantized codeblocks, inverse DWT and "
                                   "decoded samples equal to the host port's"
                                   if host else "")
              + (f"; {n_picks} codeblocks (LL and every level/subband) "
                 "byte-equal to the oracle" if picks else ""))
        return ([o.numpy() for o in out], c, [b for b, _ in tiled], coded,
                n_pl)

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
    def path_times(label, cfg, luts, lut_params, planes, job):
        """Layer, device and CLI times of a path; the CLI round trip is the
        two cli.main calls alone (no read-back, no check)."""
        c = TorchCodec(cfg, luts, lut_params, dev)
        smp = [gpu(p) for p in planes]
        mp = cfg.width * cfg.height / 1e6
        blocks = [b for b, _ in (c._dwt_tile_impl(x)
                                 for x in c._prep_impl(smp))]
        coded, n_pl = c.encode_planes(smp)
        dcoded = [(s_, z_, n_pl) for s_, z_ in coded]
        torch.cuda.synchronize()
        layer = {
            "prep+DWT+tile": device_ms(
                lambda: [c._dwt_tile_impl(x) for x in c._prep_impl(smp)]),
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
            "untile+IDWT+finish": device_ms(
                lambda: c._finish_impl([c._untile_idwt_impl(b)
                                        for b in blocks])),
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
    big = gpu(make_image(BIG))
    big_ms = {}
    for mode, cp, k in (("cp2", 2, 0.0), ("cp3", 3, 0.0), ("bulk", 2, K)):
        cfg_b = CodecConfig(width=BIG, height=BIG, wavelet_levels=LEVELS,
                            coding_passes=cp, k_factor=k)
        luts_b, params_b = cli._load_luts("neutral", LEVELS, cp, k)
        cb = TorchCodec(cfg_b, luts_b, params_b, dev)
        blocks_b, mx = cb._dwt_tile_impl(cb._prep_gray_impl(big))
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
    for name, line in (("probe", 58), ("probe2", 54)):
        module = probe if name == "probe" else probe2
        bound, by = module.bound_ms(*(gpu(x) for x in module.inputs(0)))
        entries.append({
            "name": name, "route": "cuda", "source": f"{src_dir}/{name}.cu",
            "replaces": f"tools/pallas_{name}.py:{line}",
            "launches": probe_launches[name], "max_abs_err": perr[name],
            "ms": pt[name], "plain_ms": pt[name + " plain"],
            "bound_ms": bound, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
