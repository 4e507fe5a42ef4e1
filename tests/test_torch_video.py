"""The port's video engine (`engine/video.py`) against the JAX package's
`encode_video`/`decode_video`, lossless, and the port's CLI with -video 1.

The port runs on the CPU here (device="cpu", the plain BPC coder), on the
frame sizes of tests/test_cli_video.py. Files and `_SIZE` sidecars are
compared with the JAX engine's byte for byte, and decoded frames with the
input bit for bit (tolerance 0). The lossy paths, `BatchCodec` and the
engine's failure paths are in tests/test_torch_video_batch.py.
"""

import os

import numpy as np
import pytest

from picsong_tpu.engine import video as jvideo
from picsong_tpu.reference import codec as oracle
from picsong_tpu_torch.core.header import CodecConfig
from picsong_tpu_torch.core.image_io import (read_codestream, read_raw_frame,
                                             read_sizes, sample_dtype)
from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
from picsong_tpu_torch.engine import cli
from picsong_tpu_torch.engine import video
from picsong_tpu_torch.engine.batch import BatchCodec

from torch_twins import J

PARAMS = LUTParams()


def make_image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = (96 + 64 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, 8, size=(h, w)))
    return np.clip(base, 0, 255).astype(np.uint8)


def write_raw(path, planes):
    with open(path, "wb") as f:
        for p in planes:
            f.write(np.asarray(p).tobytes())


def read(path):
    with open(path, "rb") as f:
        return f.read()


def assert_same_file(got, want):
    assert read(got) == read(want)
    assert read(got + "_SIZE") == read(want + "_SIZE")


def luts_for(cfg):
    groups = PARAMS.n_bitplane_files if cfg.k_factor > 0 else 1
    return [neutral_lut(PARAMS, cfg.wavelet_levels, cfg.coding_passes,
                        groups)] * (3 if cfg.is_rgb else 1)


@pytest.fixture(scope="module")
def gray5(tmp_path_factory):
    """Five 64x128 gray frames, wl=1, encoded by the port and by the JAX
    engine with batch 2 (the third batch is a padded tail)."""
    d = tmp_path_factory.mktemp("gray5")
    rng = np.random.default_rng(3)
    frames = [make_image(rng, 64, 128) for _ in range(5)]
    raw, port, jax = (str(d / n) for n in ("v.raw", "port.enc", "jax.enc"))
    write_raw(raw, frames)
    cfg = CodecConfig(width=128, height=64, wavelet_levels=1, frames=5)
    luts = luts_for(cfg)
    stats = video.encode_video(raw, port, cfg, luts, PARAMS, frames=5,
                               batch=2, device="cpu")
    jvideo.encode_video(raw, jax, J(cfg), luts, J(PARAMS), frames=5, batch=2)
    return dict(dir=d, frames=frames, raw=raw, port=port, jax=jax, cfg=cfg,
                luts=luts, stats=stats)


def test_gray_lossless_file_equals_jax_encode_video(gray5):
    assert gray5["stats"].frames == 5
    assert gray5["stats"].batches == 3          # 2 + 2 + 1 (padded tail)
    assert_same_file(gray5["port"], gray5["jax"])


def test_perframe_engine_equals_batched_engine(gray5):
    """batch=1 codes one frame a launch: the same file bytes as batch 2
    (frame batching changes the launch shape, not the codestream), and it
    decodes back to the input."""
    out = str(gray5["dir"] / "perframe.enc")
    stats = video.encode_video(gray5["raw"], out, gray5["cfg"],
                               gray5["luts"], PARAMS, frames=5, batch=1,
                               device="cpu")
    assert stats.frames == 5 and stats.batches == 5 and stats.batch == 1
    assert_same_file(out, gray5["port"])
    dec = str(gray5["dir"] / "perframe.raw")
    stats = video.decode_video(out, dec, gray5["cfg"], gray5["luts"], PARAMS,
                               batch=1, device="cpu")
    assert stats.frames == 5 and stats.batches == 5
    assert read(dec) == read(gray5["raw"])


def test_decode_of_jax_written_video_is_bit_exact(gray5):
    """The port decodes the JAX engine's file (byte-equal to its own) back
    to the input, batch 2 with a padded tail; a stale output is replaced."""
    dec = str(gray5["dir"] / "dec.raw")
    with open(dec, "wb") as f:
        f.write(b"stale")
    stats = video.decode_video(gray5["jax"], dec, gray5["cfg"],
                               gray5["luts"], PARAMS, batch=2, device="cpu")
    assert stats.frames == 5 and stats.batches == 3
    assert os.path.getsize(dec) == 5 * 64 * 128
    for i, fr in enumerate(gray5["frames"]):
        assert np.array_equal(read_raw_frame(dec, 128, 64, i), fr)


def test_decode_window_frame_offset(gray5):
    dec = str(gray5["dir"] / "window.raw")
    stats = video.decode_video(gray5["port"], dec, gray5["cfg"],
                               gray5["luts"], PARAMS, batch=2, device="cpu",
                               frame_offset=1, frames=3)
    assert stats.frames == 3
    assert os.path.getsize(dec) == 3 * 64 * 128
    for i in range(3):
        assert np.array_equal(read_raw_frame(dec, 128, 64, i),
                              gray5["frames"][1 + i])


@pytest.mark.parametrize("cfg_kw,n_frames,batch", [
    (dict(is_rgb=True, components=3), 2, 2),
    (dict(coding_passes=3), 3, 3),
    (dict(k_factor=5.0), 3, 3),
])
def test_lossless_modes_equal_jax_and_round_trip(tmp_path, cfg_kw, n_frames,
                                                 batch):
    """RGB, -cp 3 and -k 5: file bytes equal to the JAX engine's (its
    default batch of 8), and the port's decode bit-exact."""
    rng = np.random.default_rng(len(cfg_kw) + n_frames)
    n_comp = 3 if cfg_kw.get("is_rgb") else 1
    planes = [make_image(rng, 64, 64) for _ in range(n_frames * n_comp)]
    raw, port, jax, dec = (str(tmp_path / n) for n in
                           ("v.raw", "p.enc", "j.enc", "d.raw"))
    write_raw(raw, planes)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=n_frames,
                      **cfg_kw)
    luts = luts_for(cfg)
    video.encode_video(raw, port, cfg, luts, PARAMS, frames=n_frames,
                       batch=batch, device="cpu")
    jvideo.encode_video(raw, jax, J(cfg), luts, J(PARAMS), frames=n_frames)
    assert_same_file(port, jax)
    video.decode_video(port, dec, cfg, luts, PARAMS, batch=batch,
                       device="cpu")
    assert read(dec) == read(raw)


def test_tame_then_wild_frames_give_jax_bytes_without_retry(tmp_path,
                                                           monkeypatch):
    """tests/test_cli_video.py::test_batched_video_overflow_retry's case:
    a flat first batch, then wild frames. The port takes every batch's
    bitplane count from that batch, so it encodes each batch once."""
    rng = np.random.default_rng(4)
    tame = np.full((64, 64), 128, np.uint8)
    wild = (rng.integers(0, 2, size=(64, 64)) * 255).astype(np.uint8)
    frames = [tame, tame, wild, wild]
    raw, port, jax, dec = (str(tmp_path / n) for n in
                           ("v.raw", "p.enc", "j.enc", "d.raw"))
    write_raw(raw, frames)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=4)
    luts = luts_for(cfg)
    calls = []
    encode_blocks = BatchCodec.encode_blocks

    def counted(self, blocks, n_planes):
        calls.append(n_planes)
        return encode_blocks(self, blocks, n_planes)

    monkeypatch.setattr(BatchCodec, "encode_blocks", counted)
    stats = video.encode_video(raw, port, cfg, luts, PARAMS, frames=4,
                               batch=2, device="cpu")
    assert stats.batches == 2 and len(calls) == 2
    assert calls[0] < calls[1] == stats.n_planes >= 8
    jvideo.encode_video(raw, jax, J(cfg), luts, J(PARAMS), frames=4, batch=2)
    assert_same_file(port, jax)
    video.decode_video(port, dec, cfg, luts, PARAMS, batch=2, device="cpu")
    assert read(dec) == read(raw)


def _depth_frames(rng, n, bps, signed):
    """`n` planes of a smooth pattern plus noise over the sample range."""
    lo, hi = ((-(1 << (bps - 1)), (1 << (bps - 1)) - 1) if signed
              else (0, (1 << bps) - 1))
    span = hi - lo
    y, x = np.mgrid[0:64, 0:64]
    return [np.clip(lo + span / 2 + span / 3 * np.sin(x / 9.0 + k)
                    * np.cos(y / 13.0) + rng.normal(0, span / 64, (64, 64)),
                    lo, hi).astype(np.int32) for k in range(n)]


@pytest.mark.parametrize("bps,signed,endianess,rgb", [
    (16, False, 1, False), (12, True, 0, False), (16, True, 0, True)])
def test_high_depth_lossless_video_equals_jax(tmp_path, bps, signed,
                                              endianess, rgb):
    """16-bit unsigned big-endian, 12-bit signed and 16-bit signed RGB, 3
    frames, batch 2, wl=2: the file and `_SIZE` of the JAX engine, and a
    decode equal to the JAX engine's decode."""
    n_comp = 3 if rgb else 1
    dtype = sample_dtype(bps, endianess, signed)
    planes = _depth_frames(np.random.default_rng(bps + signed), 3 * n_comp,
                           bps, signed)
    raw, port, jax, dec, jdec = (str(tmp_path / n) for n in
                                 ("v.raw", "p.enc", "j.enc", "d.raw",
                                  "jd.raw"))
    write_raw(raw, [p.astype(dtype) for p in planes])
    cfg = CodecConfig(width=64, height=64, wavelet_levels=2, frames=3,
                      bit_depth=bps, bps=bps, is_signed=signed,
                      endianess=endianess, is_rgb=rgb, components=n_comp)
    luts = luts_for(cfg)
    video.encode_video(raw, port, cfg, luts, PARAMS, frames=3, batch=2,
                       device="cpu")
    jvideo.encode_video(raw, jax, J(cfg), luts, J(PARAMS), frames=3, batch=2)
    assert_same_file(port, jax)
    video.decode_video(port, dec, cfg, luts, PARAMS, batch=2, device="cpu")
    jvideo.decode_video(jax, jdec, J(cfg), luts, J(PARAMS), batch=2)
    assert read(dec) == read(jdec)


@pytest.mark.parametrize("bps,signed,endianess", [
    (16, False, 0), (12, True, 1), (16, True, 1)])
def test_high_depth_lossy_video_frames_equal_oracle(tmp_path, bps, signed,
                                                    endianess):
    """Lossy 9/7 video at 16-bit unsigned and at 12- and 16-bit signed
    big-endian: every frame's codestream is the oracle's `encode_image` of
    that frame."""
    dtype = sample_dtype(bps, endianess, signed)
    planes = _depth_frames(np.random.default_rng(3 * bps + signed), 3, bps,
                           signed)
    raw, port = str(tmp_path / "v.raw"), str(tmp_path / "p.enc")
    write_raw(raw, [p.astype(dtype) for p in planes])
    cfg = CodecConfig(width=64, height=64, wavelet_levels=2, frames=3,
                      bit_depth=bps, bps=bps, is_signed=signed,
                      endianess=endianess, is_lossy=True, qs=1.0)
    luts = luts_for(cfg)
    video.encode_video(raw, port, cfg, luts, PARAMS, frames=3, batch=2,
                       device="cpu")
    sizes = read_sizes(port)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    native = dtype.newbyteorder("=")
    for i, plane in enumerate(planes):
        want = oracle.encode_image(plane.astype(native), J(cfg), luts,
                                   J(PARAMS))[0]
        got = read_codestream(port, int(offsets[i]), int(sizes[i]))
        assert np.array_equal(got, want), f"frame {i}"


def test_cli_video_round_trip(tmp_path, capsys):
    rng = np.random.default_rng(8)
    frames = [make_image(rng, 64, 64) for _ in range(3)]
    raw, enc, dec, jax = (str(tmp_path / n) for n in
                          ("v.raw", "v.enc", "d.raw", "j.enc"))
    write_raw(raw, frames)
    assert cli.main(["-cd", "0", "-i", raw, "-o", enc, "-wl", "1", "-video",
                     "1", "-frames", "3", "-xSize", "64", "-ySize", "64",
                     "-numberOfStreams", "2", "-LUTFolder", "neutral",
                     "--device", "cpu"]) == 0
    assert "Encoded 3 frames" in capsys.readouterr().out
    assert cli.main(["-cd", "1", "-i", enc, "-o", dec, "-video", "1",
                     "-numberOfStreams", "2", "-LUTFolder", "neutral",
                     "--device", "cpu"]) == 0
    assert "Decoded 3 frames" in capsys.readouterr().out
    assert read(dec) == read(raw)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=3)
    jvideo.encode_video(raw, jax, J(cfg), luts_for(cfg), J(PARAMS), frames=3,
                        batch=2)
    assert_same_file(enc, jax)


def test_cli_sharded_video_exits_2(tmp_path, capsys):
    """-sharded 2 with -video 1, refused until frame data parallelism was
    ported, now codes each batch over two CPU shares: the file of the
    unsharded CLI (and of the JAX engine), and a bit-exact decode."""
    rng = np.random.default_rng(11)
    raw, enc, one, dec = (str(tmp_path / n) for n in
                          ("v.raw", "v.enc", "one.enc", "d.raw"))
    write_raw(raw, [make_image(rng, 64, 64) for _ in range(3)])
    args = ["-wl", "1", "-video", "1", "-frames", "3", "-xSize", "64",
            "-ySize", "64", "-numberOfStreams", "2", "--device", "cpu"]
    assert cli.main(["-cd", "0", "-i", raw, "-o", enc, *args,
                     "-sharded", "2"]) == 0
    assert "2 shards on the CPU" in capsys.readouterr().out
    assert cli.main(["-cd", "0", "-i", raw, "-o", one, *args]) == 0
    assert_same_file(enc, one)
    assert cli.main(["-cd", "1", "-i", enc, "-o", dec, "-video", "1",
                     "-numberOfStreams", "2", "-sharded", "2",
                     "--device", "cpu"]) == 0
    assert read(dec) == read(raw)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=3)
    jax = str(tmp_path / "j.enc")
    jvideo.encode_video(raw, jax, J(cfg), luts_for(cfg), J(PARAMS), frames=3,
                        batch=2, devices=2)
    assert_same_file(enc, jax)
