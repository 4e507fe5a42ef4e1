"""Frame-data-parallel video in the port: `FrameParallelCodec` and
`encode_video` / `decode_video` with devices > 1, against the
single-device port and the JAX engine's `encode_video(devices=4)` on the
8-device CPU mesh.

The devices are CPU shares here (the plain BPC coder); files, `_SIZE`
sidecars and codestreams are compared byte for byte, decodes bit for bit
(tolerance 0).
"""

import numpy as np
import pytest
import torch

from picsong_tpu.engine import video as jvideo
from picsong_tpu_torch.assembly import pack
from picsong_tpu_torch.core.header import CodecConfig, pack_header
from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
from picsong_tpu_torch.dist.sharded import FrameParallelCodec
from picsong_tpu_torch.engine import video
from picsong_tpu_torch.engine.pipeline import TorchCodec

from torch_twins import J

PARAMS = LUTParams()


def make_image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = (96 + 64 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, 8, size=(h, w)))
    return np.clip(base, 0, 255).astype(np.uint8)


def uneven_frames(rng, n, h, w):
    """Frames of very different content: flat black, flat white, the
    smooth pattern, full-range noise (each a different bitplane count)."""
    kinds = [lambda: np.zeros((h, w), np.uint8),
             lambda: np.full((h, w), 255, np.uint8),
             lambda: make_image(rng, h, w),
             lambda: rng.integers(0, 256, size=(h, w)).astype(np.uint8)]
    return [kinds[i % 4]() for i in range(n)]


def read(path):
    with open(path, "rb") as f:
        return f.read()


def test_frame_parallel_codec_matches_single_device():
    """4 frames of uneven content over 2 devices, 2 a device: every
    frame's codestream equal to TorchCodec.encode of the frame, and the
    batch decoded back."""
    rng = np.random.default_rng(2)
    frames = np.stack(uneven_frames(rng, 4, 64, 64))
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1)
    luts = [neutral_lut(PARAMS, 1, 2)]
    fp = FrameParallelCodec(cfg, luts, PARAMS, ["cpu"] * 2, batch=4)
    assert fp.share == 2 and len(fp.codecs) == 2
    [(streams, sizes)] = fp.encode_batch(frames)
    assert streams.shape == (4, fp.ncb, 4096) and sizes.shape == (4, fp.ncb)
    single = TorchCodec(cfg, luts, PARAMS, "cpu")
    for i in range(4):
        got = pack.pack_streams(torch.from_numpy(streams[i]),
                                torch.from_numpy(sizes[i]),
                                pack_header(cfg)).numpy().view(np.uint16)
        assert np.array_equal(got, single.encode(frames[i])[0]), i
    assert np.array_equal(fp.decode_batch([(streams, sizes)]), frames)
    with pytest.raises(ValueError, match="multiple"):
        FrameParallelCodec(cfg, luts, PARAMS, ["cpu"] * 4, batch=6)


def _write(path, planes):
    with open(path, "wb") as f:
        for p in planes:
            f.write(p.tobytes())


def test_encode_video_devices_equal_single_and_jax(tmp_path):
    """6 frames of uneven content, batch 3 over 4 devices (rounded up to
    4: one frame a device, then a padded tail batch): the file and `_SIZE`
    of devices=1 and of the JAX engine's encode_video(devices=4); decode
    over 2 devices back to the input."""
    frames = uneven_frames(np.random.default_rng(9), 6, 64, 64)
    raw, one, jax, four, dec = (str(tmp_path / n) for n in
                                ("v.raw", "1.enc", "j.enc", "4.enc", "d.raw"))
    _write(raw, frames)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=6)
    luts = [neutral_lut(PARAMS, 1, 2)]
    video.encode_video(raw, one, cfg, luts, PARAMS, frames=6, batch=3,
                       device="cpu")
    jvideo.encode_video(raw, jax, J(cfg), luts, J(PARAMS), frames=6,
                        batch=3, devices=4)
    stats = video.encode_video(raw, four, cfg, luts, PARAMS, frames=6,
                               batch=3, devices=4, device="cpu")
    assert stats.frames == 6 and stats.batch == 4 and stats.batches == 2
    for got in (jax, four):
        assert read(got) == read(one)
        assert read(got + "_SIZE") == read(one + "_SIZE")
    stats = video.decode_video(four, dec, cfg, luts, PARAMS, batch=3,
                               devices=2, device="cpu")
    assert stats.frames == 6 and stats.batch == 4
    assert read(dec) == read(raw)


def test_rgb_video_devices_equal_single(tmp_path):
    """Planar RGB, 2 frames over 2 devices: the file of devices=1, and
    the decode back to the input."""
    rng = np.random.default_rng(10)
    planes = [make_image(rng, 64, 64) for _ in range(6)]
    raw, one, two, dec = (str(tmp_path / n) for n in
                          ("v.raw", "1.enc", "2.enc", "d.raw"))
    _write(raw, planes)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=2,
                      is_rgb=True, components=3)
    luts = [neutral_lut(PARAMS, 1, 2)] * 3
    video.encode_video(raw, one, cfg, luts, PARAMS, frames=2, batch=2,
                       device="cpu")
    video.encode_video(raw, two, cfg, luts, PARAMS, frames=2, batch=2,
                       devices=2, device="cpu")
    assert read(two) == read(one)
    assert read(two + "_SIZE") == read(one + "_SIZE")
    video.decode_video(two, dec, cfg, luts, PARAMS, batch=2, devices=2,
                       device="cpu")
    assert read(dec) == read(raw)
