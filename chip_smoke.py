#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (picsong_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from picsong_tpu_torch/csrc with nvcc (one
compiler per source, in parallel), holds each kernel equal to its plain
PyTorch version on the card, holds the port's codestreams byte-equal to
the NumPy oracle, and drives each of the port's paths through the CLI,
reading the kernels' launch counts around each path:
- gray lossless 5/3, 2048x2048 at 5 wavelet levels, neutral and trained
  LUTs (the main path; then every layer of it is timed);
- the two probe kernels against their plain versions on the probes' own
  and on edge inputs, then the probe entry points;
- gray lossy 9/7, 2048x2048 at 3 levels, qs 1 (BASELINE config 2),
  neutral and trained lossy LUTs, plus a 512x512 byte check against the
  oracle;
- planar RGB 2048x2560 (the reference's image workload), lossless RCT and
  lossy ICT;
- 16-bit gray lossless, 2048x2048;
on each of the new paths it also holds the BPC kernels equal to their
plain versions on every component's codeblocks, at the path's n_planes
and with the component's LUT; on the lossy ones it holds the card's
quantized codeblocks, inverse DWT and decoded samples equal to a CPU
TorchCodec's, and the CLI's decoded file equal to those samples. Then it
times the device halves and CLI round trips of the new paths (the two
cli.main calls alone). Every comparison is exact except the lossy PSNR
floors, which are stated where they are checked.

Exits non-zero, printing no result, when there is no CUDA device or any
check fails. Otherwise its last two lines are a JSON object with each
kernel's launches, error and times, then
{"ok": true, "device": {"platform": "gpu", ...}}; the line before those
holds the card's name and power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

SIZE = 2048
LEVELS = 5
ITERS = 10
LOSSY_LEVELS = 3              # BASELINE config 2
RGB_W, RGB_H = 2048, 2560     # the reference's image workload
PROBE_CALLS = 200


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    _require(proc.returncode == 0, f"{' '.join(cmd)} exited {proc.returncode}")
    return proc.stdout.strip()


def make_image(size: int, seed: int = 3, width: int | None = None,
               peak: int = 255):
    """Smooth pattern plus Gaussian noise (the verify recipe's), 8-bit, or
    scaled to `peak` as uint16."""
    import numpy as np
    width = width or size
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:width]
    img = (120 + 70 * np.sin(x / 11.0) * np.cos(y / 17.0)
           + rng.normal(0, 6, (size, width))) * (peak / 255)
    return np.clip(img, 0, peak).astype(np.uint8 if peak == 255
                                        else np.uint16)


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
    sys.modules["jax"] = None        # the port must run without JAX

    import numpy as np

    from picsong_tpu.core.geometry import codeblock_bands
    from picsong_tpu.core.header import CodecConfig
    from picsong_tpu.core.image_io import (append_raw_frame, read_pgm,
                                           read_raw_frame, sample_dtype,
                                           write_pgm)
    from picsong_tpu.core.lut import LUTParams, neutral_lut
    from picsong_tpu.reference import bpc as oracle_bpc
    from picsong_tpu.reference import codec as oracle_codec
    from picsong_tpu_torch import kernels
    from picsong_tpu_torch.engine import cli
    from picsong_tpu_torch.engine.pipeline import TorchCodec
    from picsong_tpu_torch.entropy import bpc, bpc_cuda
    from picsong_tpu_torch.tools import probe, probe2

    dev = torch.device("cuda")
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
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    err = {"encode": 0, "decode": 0}

    def gpu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def compare_encode(blocks, args, params, n_planes, what):
        s_k, n_k = bpc_cuda.encode_blocks(blocks, *args, params=params,
                                          n_planes=n_planes)
        s_p, n_p = bpc.encode_blocks_plain(blocks, *args, params=params,
                                           n_planes=n_planes)
        torch.cuda.synchronize()
        e = max(int((s_k.long() - s_p.long()).abs().max()),
                int((n_k.long() - n_p.long()).abs().max()))
        err["encode"] = max(err["encode"], e)
        _require(e == 0, f"encode kernel == plain ({what}), max err {e}")
        return s_k, n_k

    def compare_decode(streams, sizes, args, params, n_planes, want, what):
        o_k = bpc_cuda.decode_blocks(streams, sizes, *args, params=params,
                                     n_planes=n_planes)
        o_p = bpc.decode_blocks_plain(streams, sizes, *args, params=params,
                                      n_planes=n_planes)
        torch.cuda.synchronize()
        e = int((o_k.long() - o_p.long()).abs().max())
        err["decode"] = max(err["decode"], e)
        _require(e == 0, f"decode kernel == plain ({what}), max err {e}")
        _require(torch.equal(o_k, want), f"decode == input ({what})")

    # ---- 3. kernel vs plain on random batches ----------------------------
    params = LUTParams()
    wl = 2
    lut = neutral_lut(params, wl, 2)
    lut = lut + (np.arange(lut.size, dtype=np.int32) % 41)
    n = 256
    levels = (np.arange(n) % (wl + 1)).astype(np.int32)
    subbands = np.where(levels == wl, 0, np.arange(n) % 3).astype(np.int32)
    meta = bpc.block_metadata(levels, subbands, params, wl, 2, 0.0)
    args = [gpu(a) for a in (lut, meta["ref"], meta["sig"], meta["sign"])]
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
            s, z = compare_encode(b, args, params, n_planes, what)
            _require(int(z[5]) == 4096 and int(z[3]) == 1,
                     f"raw fallback and empty block exercised ({what})")
            compare_decode(s, z, args, params, n_planes, b, what)
    print(f"{tag} random batches: 9 x {n} codeblocks, kernels byte-equal to "
          f"plain (max abs err encode {err['encode']}, decode "
          f"{err['decode']}), decode == input")

    # ---- 4. oracle check at BASELINE config 1 (512^2, wl=1) ---------------
    img512 = make_image(512)
    cfg1 = CodecConfig(width=512, height=512, wavelet_levels=1)
    luts1 = [neutral_lut(params, 1, 2)]
    codec1 = TorchCodec(cfg1, luts1, params, dev)
    got = codec1.encode(img512)[0]
    t0 = time.perf_counter()
    want = oracle_codec.encode_image(img512, cfg1, luts1, params)[0]
    oracle_s = time.perf_counter() - t0
    _require(np.array_equal(got, want), "512^2 wl=1 codestream == oracle")
    _require(np.array_equal(codec1.decode([got]), img512),
             "512^2 wl=1 decode bit-exact")
    print(f"{tag} 512^2 wl=1: codestream byte-equal to the NumPy oracle "
          f"({got.size} shorts; oracle took {oracle_s:.1f} s on the host), "
          "decode bit-exact")

    # ---- 5. the slice at 2048^2 wl=5 through the CLI ----------------------
    img = make_image(SIZE)
    tmp = tempfile.TemporaryDirectory()
    src = os.path.join(tmp.name, "in.pgm")
    write_pgm(src, img)

    def cli_pair(job):
        """One CLI encode and decode (the timed round trip: no read-back, no
        check); resets the BPC launch counts first and returns them."""
        enc_args, dec_args, what = job
        bpc_cuda.ENCODE_LAUNCHES = bpc_cuda.DECODE_LAUNCHES = 0
        _require(cli.main(["-cd", "0", *enc_args]) == 0, f"CLI encode {what}")
        _require(cli.main(["-cd", "1", *dec_args]) == 0, f"CLI decode {what}")
        got = {"encode": bpc_cuda.ENCODE_LAUNCHES,
               "decode": bpc_cuda.DECODE_LAUNCHES}
        _require(got["encode"] > 0 and got["decode"] > 0,
                 f"{what} path launched both BPC kernels {got}")
        return got

    def gray_job(lut_folder, lossy=False):
        """(codestream path, decoded path, cli_pair job) of a gray round
        trip of `src`: lossless wl=5, or lossy wl=3 qs=1."""
        name = f"lossy_{lut_folder}" if lossy else lut_folder
        enc = os.path.join(tmp.name, f"{name}.enc")
        dec = os.path.join(tmp.name, f"{name}.pgm")
        kind = ["-wl", str(LOSSY_LEVELS), "-cp", "2", "-type", "1", "-qs",
                "1"] if lossy else ["-wl", str(LEVELS), "-cp", "2", "-type",
                                    "0"]
        return enc, dec, (["-i", src, "-o", enc, *kind, "-video", "0", "-k",
                           "0", "-LUTFolder", lut_folder],
                          ["-i", enc, "-o", dec, "-video", "0", "-LUTFolder",
                           lut_folder],
                          f"{'lossy' if lossy else 'lossless'} {lut_folder}")

    launches = {"encode": 0, "decode": 0}
    exact = {}
    for lut_folder in ("neutral", "trained"):
        _, dec, job = gray_job(lut_folder)
        got = cli_pair(job)
        launches = {k: launches[k] + got[k] for k in launches}
        exact[lut_folder] = np.array_equal(read_pgm(dec), img)
    _require(all(exact.values()), f"2048^2 CLI round trips bit-exact {exact}")
    _require(launches["encode"] > 0 and launches["decode"] > 0,
             f"main path launched both kernels {launches}")
    enc_bytes = {f: os.path.getsize(os.path.join(tmp.name, f"{f}.enc"))
                 for f in exact}
    print(f"{tag} {SIZE}^2 wl={LEVELS} CLI round trips bit-exact: neutral "
          f"{enc_bytes['neutral']} B, trained {enc_bytes['trained']} B; "
          f"kernel launches on the main path {launches}")

    cfg = CodecConfig(width=SIZE, height=SIZE, wavelet_levels=LEVELS)
    luts = [neutral_lut(params, LEVELS, 2)]
    codec = TorchCodec(cfg, luts, params, dev)
    samples = gpu(img)
    blocks, max_mag = codec._dwt_tile_impl(codec._prep_gray_impl(samples))
    n_planes = bpc.planes_for_magnitude(int(max_mag))
    pargs = codec._bpc_args()
    streams, sizes = compare_encode(blocks, pargs, params, n_planes,
                                    f"{SIZE}^2 plane")
    compare_decode(streams, sizes, pargs, params, n_planes, blocks,
                   f"{SIZE}^2 plane")
    lv, sb = codeblock_bands(SIZE, SIZE, LEVELS)
    picks = sorted({(int(a), int(c)): i
                    for i, (a, c) in reversed(list(enumerate(zip(lv, sb))))
                    }.items())
    _require(len(picks) == 3 * LEVELS + 1, "every level and subband picked")
    blocks_np, streams_np = blocks.cpu().numpy(), streams.cpu().numpy()
    for (level, subband), i in picks:
        want_s, want_n = oracle_bpc.encode_codeblock(
            blocks_np[i], level, subband, luts[0], params, LEVELS)
        _require(int(sizes[i]) == want_n
                 and np.array_equal(streams_np[i], want_s),
                 f"codeblock {i} (level {level}, subband {subband}) == oracle")
    print(f"{tag} {SIZE}^2 plane: {blocks.shape[0]} codeblocks, n_planes "
          f"{n_planes}, kernels byte-equal to plain; {len(picks)} codeblocks "
          "(LL and every level/subband) byte-equal to the oracle")

    # ---- 6. times ----------------------------------------------------------
    mpix = SIZE * SIZE / 1e6

    def device_ms(fn, iters=ITERS, warm=2):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
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

    t = {}
    t["device encode"] = report(
        f"device encode {SIZE}^2 wl={LEVELS} (samples -> streams)",
        host_ms(lambda: codec.encode_planes([samples])))
    t["device decode"] = report(
        f"device decode {SIZE}^2 wl={LEVELS} (streams -> samples)",
        host_ms(lambda: codec.decode_planes([(streams, sizes, n_planes)])))
    t["cli"] = report(f"CLI round trip {SIZE}^2 wl={LEVELS} neutral LUT "
                      "(file -> file -> file)",
                      host_ms(lambda: cli_pair(gray_job("neutral")[2])))
    enc_kernel = device_ms(
        lambda: bpc_cuda.encode_blocks(blocks, *pargs, params=params,
                                       n_planes=n_planes))
    dec_kernel = device_ms(
        lambda: bpc_cuda.decode_blocks(streams, sizes, *pargs, params=params,
                                       n_planes=n_planes))
    t["enc kernel"] = report("BPC encode kernel", enc_kernel)
    t["dec kernel"] = report("BPC decode kernel", dec_kernel)
    t["enc plain"] = report("BPC encode plain PyTorch on the card", device_ms(
        lambda: bpc.encode_blocks_plain(blocks, *pargs, params=params,
                                        n_planes=n_planes), warm=1))
    t["dec plain"] = report("BPC decode plain PyTorch on the card", device_ms(
        lambda: bpc.decode_blocks_plain(streams, sizes, *pargs,
                                        params=params, n_planes=n_planes),
        warm=1))

    # per-layer breakdown of the host API round trip
    from picsong_tpu import native
    from picsong_tpu.core.header import pack_header
    header = pack_header(cfg)
    s_np, z_np = streams.cpu().numpy(), sizes.cpu().numpy()
    packed = native.pack_streams(s_np, z_np, header)
    layers = {
        "prep+DWT+tile": device_ms(
            lambda: codec._dwt_tile_impl(codec._prep_gray_impl(samples))),
        "BPC encode kernel": enc_kernel,
        "D2H streams+sizes": host_ms(
            lambda: (streams.cpu(), sizes.cpu())),
        "host pack": host_ms(lambda: native.pack_streams(s_np, z_np, header)),
        "host unpack": host_ms(lambda: native.unpack_streams(packed,
                                                             codec.ncb)),
        "H2D streams+sizes": host_ms(
            lambda: (gpu(s_np), gpu(z_np.astype(np.int32)))),
        "BPC decode kernel": dec_kernel,
        "untile+IDWT+clamp": device_ms(
            lambda: codec._finish_gray_impl(codec._untile_idwt_impl(blocks))),
    }
    for name, times in layers.items():
        report(f"layer {name}", times, rate=False)
    print(f"{tag} host packed codestream {packed.size * 2} B, native pack "
          f"{'on' if native.available() else 'off (NumPy)'}")

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
    def check_planes(label, cfg, luts, lut_params, planes, host):
        """A path's planes on the card: each component's BPC kernels against
        their plain versions at the path's shapes, n_planes and LUT; with
        `host`, also the card's quantized codeblocks, inverse DWT and decoded
        samples against a CPU TorchCodec's. Returns the decoded planes."""
        c = TorchCodec(cfg, luts, lut_params, dev)
        tiled = [c._dwt_tile_impl(x)
                 for x in c._prep_impl([gpu(p) for p in planes])]
        n_pl = bpc.planes_for_magnitude(max(int(m) for _, m in tiled))
        for i, (blocks, _) in enumerate(tiled):
            what = f"{label} component {i}"
            s_, z_ = compare_encode(blocks, c._bpc_args(i), lut_params, n_pl,
                                    what)
            compare_decode(s_, z_, c._bpc_args(i), lut_params, n_pl, blocks,
                           what)
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
                                   if host else ""))
        return [o.numpy() for o in out]

    def same_planes(back, out):
        return all(np.array_equal(b, o[:b.shape[0], :b.shape[1]])
                   for b, o in zip(back, out))

    cfg_l = CodecConfig(width=SIZE, height=SIZE,
                        wavelet_levels=LOSSY_LEVELS, is_lossy=True, qs=1.0)
    luts_l = [neutral_lut(params, LOSSY_LEVELS, 2)]
    out_l = check_planes(f"{SIZE}^2 lossy plane", cfg_l, luts_l, params,
                         [img], host=True)
    for lut_folder in ("neutral", "trained"):
        enc, dec, job = gray_job(lut_folder, lossy=True)
        n = cli_pair(job)
        back = read_pgm(dec)
        _require(same_planes([back], out_l),
                 f"lossy {lut_folder}: CLI decode == the host-checked card "
                 "decode")
        db = psnr(back, img)
        _require(db > 40.0, f"lossy {lut_folder} PSNR {db:.2f} dB > 40")
        print(f"{tag} {SIZE}^2 wl={LOSSY_LEVELS} lossy CLI round trip, "
              f"{lut_folder} LUT: PSNR {db:.4f} dB, {os.path.getsize(enc)} B; "
              f"kernel launches {n}")

    cfg_l512 = CodecConfig(width=512, height=512,
                           wavelet_levels=LOSSY_LEVELS, is_lossy=True, qs=1.0)
    codec_l512 = TorchCodec(cfg_l512, luts_l, params, dev)
    got = codec_l512.encode(img512)
    t0 = time.perf_counter()
    want = oracle_codec.encode_image(img512, cfg_l512, luts_l, params)
    oracle_db = psnr(oracle_codec.decode_image(want, cfg_l512, luts_l,
                                               params), img512)
    oracle_s = time.perf_counter() - t0
    _require(np.array_equal(got[0], want[0]),
             "512^2 wl=3 lossy codestream == oracle")
    port_db = psnr(codec_l512.decode(got), img512)
    _require(port_db >= oracle_db - 0.05,
             f"512^2 lossy PSNR {port_db:.4f} >= oracle {oracle_db:.4f} - 0.05")
    print(f"{tag} 512^2 wl=3 lossy: codestream byte-equal to the oracle "
          f"({got[0].size} shorts), PSNR {port_db:.4f} dB vs oracle "
          f"{oracle_db:.4f} dB (oracle took {oracle_s:.1f} s on the host)")

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
                          f"RGB {'lossy' if lossy else 'lossless'}")

    def rgb_cli(lossy):
        enc, dec, job = rgb_job(lossy)
        n = cli_pair(job)
        back = [read_raw_frame(dec, RGB_W, RGB_H, c, np.uint8)
                for c in range(3)]
        return n, back, os.path.getsize(enc)

    cfg_rgb = CodecConfig(width=RGB_W, height=RGB_H, wavelet_levels=LEVELS,
                          is_rgb=True, components=3)
    luts_rgb, params_rgb = cli._load_luts("trained", LEVELS, 2, 0.0)
    cfg_rgb_l = CodecConfig(width=RGB_W, height=RGB_H, wavelet_levels=LEVELS,
                            is_rgb=True, components=3, is_lossy=True, qs=1.0)
    luts_rgb_l, params_rgb_l = cli._load_luts("trained", LEVELS, 2, 0.0,
                                              lossy=True)
    n, back, nbytes = rgb_cli(False)
    _require(all(np.array_equal(b, p) for b, p in zip(back, rgb)),
             "RGB lossless CLI round trip bit-exact")
    print(f"{tag} RGB {RGB_W}x{RGB_H} wl={LEVELS} lossless CLI round trip "
          f"bit-exact, {nbytes} B; kernel launches {n}")
    out = check_planes(f"RGB {RGB_W}x{RGB_H} lossless", cfg_rgb, luts_rgb,
                       params_rgb, rgb, host=False)
    _require(same_planes(back, out), "RGB lossless: CLI == card decode")
    n, back, nbytes = rgb_cli(True)
    dbs = [psnr(b, p) for b, p in zip(back, rgb)]
    _require(min(dbs) > 30.0, f"RGB lossy PSNR {dbs} > 30 dB")
    print(f"{tag} RGB {RGB_W}x{RGB_H} wl={LEVELS} lossy CLI round trip: "
          f"PSNR R {dbs[0]:.4f}, G {dbs[1]:.4f}, B {dbs[2]:.4f} dB, "
          f"{nbytes} B; kernel launches {n}")
    out = check_planes(f"RGB {RGB_W}x{RGB_H} lossy", cfg_rgb_l, luts_rgb_l,
                       params_rgb_l, rgb, host=True)
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
              "neutral"], "16-bit")
    n = cli_pair(job16)
    back16 = read_raw_frame(dec16, SIZE, SIZE, 0, dt16)
    _require(back16.dtype == np.uint16 and np.array_equal(back16, img16),
             "16-bit CLI round trip bit-exact")
    print(f"{tag} {SIZE}^2 16-bit wl={LEVELS} lossless CLI round trip "
          f"bit-exact, {os.path.getsize(enc16)} B; kernel launches {n}")
    cfg16 = CodecConfig(width=SIZE, height=SIZE, wavelet_levels=LEVELS,
                        bit_depth=16, bps=16)
    out = check_planes(f"{SIZE}^2 16-bit plane", cfg16, luts, params,
                       [img16], host=False)
    _require(same_planes([back16], out), "16-bit: CLI == card decode")

    # ---- 11. times of the new paths (no plain BPC here: seconds a call) --
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
                                                params=lut_params,
                                                n_planes=n_pl)
                         for i, b in enumerate(blocks)]),
            "D2H streams+sizes": host_ms(
                lambda: [(s_.cpu(), z_.cpu()) for s_, z_ in coded]),
            "BPC decode kernel": device_ms(
                lambda: [bpc_cuda.decode_blocks(s_, z_, *c._bpc_args(i),
                                                params=lut_params,
                                                n_planes=n_pl)
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
    tmp.cleanup()

    src_dir = "picsong_tpu_torch/csrc"
    print(json.dumps({"kernels": [
        {"name": "bpc_encode", "route": "cuda",
         "source": f"{src_dir}/bpc_encode.cu",
         "replaces": "picsong_tpu/entropy/bpc_pallas.py:394",
         "launches": launches["encode"], "max_abs_err": err["encode"],
         "ms": t["enc kernel"], "plain_ms": t["enc plain"]},
        {"name": "bpc_decode", "route": "cuda",
         "source": f"{src_dir}/bpc_decode.cu",
         "replaces": "picsong_tpu/entropy/bpc_pallas.py:707",
         "launches": launches["decode"], "max_abs_err": err["decode"],
         "ms": t["dec kernel"], "plain_ms": t["dec plain"]},
        {"name": "probe", "route": "cuda", "source": f"{src_dir}/probe.cu",
         "replaces": "tools/pallas_probe.py:58",
         "launches": probe_launches["probe"], "max_abs_err": perr["probe"],
         "ms": pt["probe"], "plain_ms": pt["probe plain"]},
        {"name": "probe2", "route": "cuda", "source": f"{src_dir}/probe2.cu",
         "replaces": "tools/pallas_probe2.py:54",
         "launches": probe_launches["probe2"],
         "max_abs_err": perr["probe2"],
         "ms": pt["probe2"], "plain_ms": pt["probe2 plain"]},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
