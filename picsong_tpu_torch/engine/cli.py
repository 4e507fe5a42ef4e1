"""Command line of the PyTorch/CUDA port, mirroring picsong_tpu.engine.cli.

Same flags, defaults and validation (Launcher.cu:36-163); on decode every
configuration value comes from the codestream header. Image mode, for
every configuration `TorchCodec` covers (gray or planar RGB, lossless 5/3
or lossy 9/7, up to 16 bits per sample, signed or unsigned, either
endianness, -cp 2 or 3, any -k), and video mode (-video 1) for the same
configurations on a planar RAW frame sequence, `-numberOfStreams` frames
a batch (`engine/video.py`); `-sharded N` (N > 1) codes an image
row-sharded over N devices (`dist/sharded.py::ShardedCodec`) and a video
frame-parallel over N devices (`encode_video(devices=N)`), the shards
placed by `make_devices` and the placement printed; the files are the
unsharded ones, byte for byte. One extra flag, `--device` (default
`cuda`), picks the device (type) the codec runs on.

  python -m picsong_tpu_torch.engine.cli -cd 0 -i in.pgm -o out.enc \
      -wl 5 -cp 2 -type 0 -video 0 -LUTFolder trained -k 0
  python -m picsong_tpu_torch.engine.cli -cd 1 -i out.enc -o dec.pgm \
      -video 0 -LUTFolder trained
  python -m picsong_tpu_torch.engine.cli -cd 0 -i in.raw -o out.enc \
      -xSize 2048 -ySize 2560 -isRGB 1 -type 1 -qs 1 -LUTFolder trained
  python -m picsong_tpu_torch.engine.cli -cd 0 -i in.pgm -o out.enc \
      -wl 5 -cp 2 -k 5 -LUTFolder trained
  python -m picsong_tpu_torch.engine.cli -cd 1 -i out.enc -o dec.raw \
      -LUTFolder trained
  python -m picsong_tpu_torch.engine.cli -cd 0 -i video.raw -o video.enc \
      -xSize 1920 -ySize 1080 -video 1 -frames 100 -numberOfStreams 8
  python -m picsong_tpu_torch.engine.cli -cd 1 -i video.enc -o dec.raw \
      -video 1 -numberOfStreams 8
  python -m picsong_tpu_torch.engine.cli -cd 0 -i in.pgm -o out.enc \
      -wl 5 -sharded 2
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..core.header import CodecConfig, unpack_header
from ..core.image_io import (append_raw_frame, read_codestream,
                             read_header_shorts, read_pgm, read_raw_frame,
                             read_sizes, sample_dtype, write_codestream,
                             write_pgm)
from ..core.lut import LUTParams, load_luts, neutral_lut
from ..dist.sharded import ShardedCodec, make_devices, placement
from .pipeline import TorchCodec
from .video import decode_video, encode_video

HELP = """PICSONG codec, PyTorch/CUDA port. Options (reference-compatible):
  -h                 show this help
  -cd [0|1]          0 = encode, 1 = decode (required)
  -i FILE            input file (.pgm or planar RAW for encode)
  -o FILE            output file
  -wl N              wavelet decomposition levels, 1..10 (encode)
  -cp [2|3]          coding passes
  -type [0|1]        0 = lossless 5/3, 1 = lossy 9/7
  -qs Q              quantization size in [0, 1] (lossy only)
  -cbWidth N         codeblock width knob (multiple of 64)
  -cbHeight N        DWT tile length knob (18..20)
  -xSize N -ySize N  image width / height (RAW inputs)
  -video [0|1]       frame-sequence mode (planar RAW frames)
  -frames N          number of frames (video encode)
  -isRGB [0|1]       planar RGB input
  -components N      component count
  -bps N             bits per sample (8, 12 or 16)
  -endianess [0|1]   sample endianness
  -signedOrUnsigned [0|1]
  -numberOfStreams N video frame batch size (frames a launch, default 8)
  -sharded N         shard coding over N devices (image: rows; video:
                     frames)
  -LUTFolder PATH    LUT folder (or 'neutral' / 'trained': the lossless
                     or, with -type 1, the lossy trained tables)
  -k K               complexity-scalability factor (0 = off)
  --device DEV       torch device to run on (default cuda)
"""

def _parse_args(argv: list[str]) -> dict:
    opts = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok == "-h":
            opts["h"] = True
            i += 1
            continue
        if tok.startswith("-") and i + 1 < len(argv):
            opts[tok[2:] if tok.startswith("--") else tok[1:]] = argv[i + 1]
            i += 2
        else:
            i += 1
    return opts


def _load_luts(folder: str, wavelet_levels: int, coding_passes: int,
               k_factor: float, lossy: bool = False):
    if folder == "trained":
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        folder = os.path.join(repo, "luts",
                              "trained_lossy" if lossy else "trained_lossless")
    if not folder or folder == "neutral" or not os.path.isdir(folder):
        params = LUTParams()
        groups = params.n_bitplane_files if k_factor > 0 else 1
        return [neutral_lut(params, wavelet_levels, coding_passes, groups)], params
    return load_luts(folder, wavelet_levels, coding_passes, k_factor)


def _shard_devices(opts: dict, device: str):
    """-sharded N > 1: the N shards' devices, printed; else None (one
    device)."""
    n = int(opts.get("sharded", 0))
    if n <= 1:
        return None
    devices = make_devices(n, device)
    print(placement(devices))
    return devices


def _make_image_codec(cfg: CodecConfig, luts, params, devices, device):
    """TorchCodec on one device, or ShardedCodec over the -sharded
    devices."""
    if devices is None:
        return TorchCodec(cfg, luts, params, device)
    return ShardedCodec(cfg, luts, params, devices)


def _read_encode_input(path: str, cfg: CodecConfig):
    """A PGM plane, or the planar RAW frame: one plane (gray) or the R, G
    and B planes one after the other."""
    if path.endswith(".pgm"):
        return read_pgm(path)
    dtype = sample_dtype(cfg.bps, cfg.endianess, cfg.is_signed)
    if cfg.is_rgb:
        return [read_raw_frame(path, cfg.width, cfg.height, c, dtype)
                for c in range(3)]
    return read_raw_frame(path, cfg.width, cfg.height, 0, dtype)


def _read_codestreams(path: str) -> list[np.ndarray]:
    """The component codestreams of an image file: by its `_SIZE` sidecar,
    or the whole file as one codestream without it."""
    if not os.path.exists(path + "_SIZE"):
        return [read_codestream(path, 0, os.path.getsize(path) // 2)]
    sizes = read_sizes(path)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    return [read_codestream(path, int(offsets[j]), int(sizes[j]))
            for j in range(len(sizes))]


def _write_decoded(path: str, out, cfg: CodecConfig) -> None:
    """RGB as planar RAW; gray as PGM (by extension) or RAW, in the
    header's sample type."""
    dtype = sample_dtype(cfg.bps, cfg.endianess, cfg.is_signed)
    if not cfg.is_rgb and path.endswith(".pgm"):
        write_pgm(path, out, cfg.bit_depth)
        return
    if os.path.exists(path):
        os.remove(path)
    for plane in (out if cfg.is_rgb else [out]):
        append_raw_frame(path, plane, dtype)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = _parse_args(argv)
    if "h" in opts or not opts:
        print(HELP)
        return 0

    t_start = time.perf_counter()
    cd = int(opts.get("cd", 2))
    input_file = opts.get("i", "")
    output_file = opts.get("o", "")
    device = opts.get("device", "cuda")
    streams_depth = int(opts.get("numberOfStreams", 8))
    is_video = int(opts.get("video", 0)) == 1

    if cd == 0:
        wl = int(opts.get("wl", 5))
        cp = int(opts.get("cp", 2))
        lossy = int(opts.get("type", 0)) == 1
        qs = float(opts.get("qs", 1))
        cb_width = int(opts.get("cbWidth", 64))
        cb_height = int(opts.get("cbHeight", 18))
        x_size = int(opts.get("xSize", 0))
        y_size = int(opts.get("ySize", 0))
        frames = int(opts.get("frames", 0))
        components = int(opts.get("components", 1))
        is_rgb = int(opts.get("isRGB", 0)) == 1
        bps = int(opts.get("bps", 8))
        endianess = int(opts.get("endianess", 0))
        is_signed = int(opts.get("signedOrUnsigned", 0)) == 1
        k = float(opts.get("k", 0))

        if input_file.endswith(".pgm") and (x_size == 0 or y_size == 0):
            img = read_pgm(input_file)
            y_size, x_size = img.shape

        # validation predicate (Launcher.cu:132)
        if (not (0 <= qs <= 1) or not (1 <= wl <= 10) or x_size <= 0
                or y_size <= 0 or not input_file or not output_file
                or cb_width % 64 != 0 or not (18 <= cb_height <= 20)
                or cp not in (2, 3) or not (0 <= k <= 65.535)):
            print("Incorrect parameters. Please choose valid values.")
            return 1

        cfg = CodecConfig(width=x_size, height=y_size, components=components,
                          coding_passes=cp, cb_height=cb_height,
                          cb_width=cb_width, wavelet_levels=wl, bit_depth=bps,
                          is_lossy=lossy, qs=qs, is_rgb=is_rgb,
                          endianess=endianess, bps=bps, is_signed=is_signed,
                          frames=frames, k_factor=k)
        luts, params = _load_luts(opts.get("LUTFolder", ""), wl, cp, k, lossy)
        devices = _shard_devices(opts, device)
        if is_video:
            stats = encode_video(input_file, output_file, cfg, luts, params,
                                 frames, batch=max(streams_depth, 1),
                                 progress=True, devices=devices or 1,
                                 device=device)
            print(f"Encoded {stats.frames} frames in {stats.wall_s:.3f}s "
                  f"(batch {stats.batch}, compute {stats.compute_s:.3f}s, "
                  f"reader stall {stats.reader_stall_s:.3f}s, writer stall "
                  f"{stats.writer_stall_s:.3f}s, writer busy "
                  f"{stats.writer_busy_s:.3f}s)")
        else:
            pixels = _read_encode_input(input_file, cfg)
            codec = _make_image_codec(cfg, luts, params, devices, device)
            streams = codec.encode(pixels)
            for j, s in enumerate(streams):
                write_codestream(output_file, s, first=(j == 0))
    elif cd == 1:
        cfg = unpack_header(read_header_shorts(input_file))
        luts, params = _load_luts(opts.get("LUTFolder", ""),
                                  cfg.wavelet_levels, cfg.coding_passes,
                                  cfg.k_factor, cfg.is_lossy)
        devices = _shard_devices(opts, device)
        if is_video:
            stats = decode_video(input_file, output_file, cfg, luts, params,
                                 batch=max(streams_depth, 1), progress=True,
                                 devices=devices or 1, device=device)
            print(f"Decoded {stats.frames} frames in {stats.wall_s:.3f}s "
                  f"(compute {stats.compute_s:.3f}s)")
        else:
            out = _make_image_codec(cfg, luts, params, devices,
                                    device).decode(
                _read_codestreams(input_file))
            _write_decoded(output_file, out, cfg)
    else:
        print("Incorrect parameters. Please choose valid values.")
        return 1

    print(f"The time spent with the app is: {time.perf_counter() - t_start:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
