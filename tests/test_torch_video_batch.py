"""The port's frame batching (`engine/batch.py`, the batch pack of
`assembly/pack.py`), its lossy video path, and the video engine's failure
paths.

The port runs on the CPU here (device="cpu", the plain BPC coder). A
batch's codestreams are compared with TorchCodec's, and each lossy
frame's with the NumPy oracle's `encode_image` of that frame, byte for
byte. Against the JAX engine, whose XLA:CPU 9/7 DWT and ICT round
differently from the oracle (ROADMAP queue 3), the gate is
tests/test_torch_lossy.py's tolerance: every frame the port decodes from
the JAX engine's file is within 0.05 dB PSNR of the oracle's own round
trip of that frame.
"""

import threading

import numpy as np
import pytest
import torch

from picsong_tpu.engine import video as jvideo
from picsong_tpu.reference import codec as oracle
from picsong_tpu_torch.assembly import pack
from picsong_tpu_torch.core.header import CodecConfig, pack_header
from picsong_tpu_torch.core.image_io import (mirror_pad, read_codestream,
                                             read_raw_frame, read_sizes)
from picsong_tpu_torch.engine import video
from picsong_tpu_torch.engine.batch import BatchCodec
from picsong_tpu_torch.engine.pipeline import TorchCodec
from picsong_tpu_torch.entropy import bpc

from test_torch_rgb_depth import _blas_contracts_ict
from test_torch_video import PARAMS, luts_for, make_image, read, write_raw
from torch_twins import J


def psnr(a, b, peak=255.0):
    err = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 10 * np.log10(peak ** 2 / max(float(np.mean(err * err)), 1e-12))


def frame_streams(path, n_comp):
    """Per frame, the list of its component codestreams."""
    sizes = read_sizes(path)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    streams = [read_codestream(path, int(offsets[i]), int(sizes[i]))
               for i in range(len(sizes))]
    return [streams[i:i + n_comp] for i in range(0, len(streams), n_comp)]


@pytest.mark.parametrize("rgb", [False, True])
def test_lossy_frames_equal_oracle_and_near_jax(tmp_path, rgb):
    if rgb and not _blas_contracts_ict():
        pytest.skip("NumPy's BLAS evaluates the oracle's float32 ICT "
                    "without FMA, so its bytes are not the FMA chain the "
                    "port computes")
    rng = np.random.default_rng(5 + rgb)
    n_frames, n_comp = (2, 3) if rgb else (3, 1)
    planes = [make_image(rng, 64, 64) for _ in range(n_frames * n_comp)]
    raw, port, jax, dec = (str(tmp_path / n) for n in
                           ("v.raw", "p.enc", "j.enc", "d.raw"))
    write_raw(raw, planes)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=2, frames=n_frames,
                      is_lossy=True, qs=1.0, is_rgb=rgb,
                      components=n_comp)
    luts = luts_for(cfg)
    video.encode_video(raw, port, cfg, luts, PARAMS, frames=n_frames,
                       batch=n_frames, device="cpu")
    frames = [planes[i * n_comp:(i + 1) * n_comp] for i in range(n_frames)]
    want = [oracle.encode_image(f if rgb else f[0], J(cfg), luts, J(PARAMS))
            for f in frames]
    for got, w in zip(frame_streams(port, n_comp), want, strict=True):
        assert all(np.array_equal(g, x) for g, x in zip(got, w, strict=True))
    jvideo.encode_video(raw, jax, J(cfg), luts, J(PARAMS), frames=n_frames)
    video.decode_video(jax, dec, cfg, luts, PARAMS, batch=n_frames,
                       device="cpu")
    for i, (f, w) in enumerate(zip(frames, want)):
        back = oracle.decode_image(w, J(cfg), luts, J(PARAMS))
        for c, p in enumerate(f):
            ref = psnr(back[c] if rgb else back, p)
            got = psnr(read_raw_frame(dec, 64, 64, i * n_comp + c), p)
            assert got >= ref - 0.05, (i, c, got, ref)


def _bounded(fn, seconds=120):
    """Run fn on a thread; fail if it has not returned within `seconds`.
    Returns the exception it raised (None if it returned)."""
    box = {}

    def run():
        try:
            fn()
        except BaseException as e:       # handed to the test
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"the call did not return in {seconds} s"
    return box.get("error")


def test_failures_raise_without_hanging_or_leaking_threads(tmp_path):
    """A truncated RAW input (the reader fails on frame 2), a truncated
    codestream file (decode) and an unwritable output (the writer fails)
    each raise in the caller within a time limit, and no thread of the
    engine outlives the call."""
    rng = np.random.default_rng(9)
    frames = [make_image(rng, 64, 64) for _ in range(2)]
    raw = str(tmp_path / "v.raw")
    write_raw(raw, frames)
    with open(raw, "ab") as f:
        f.write(b"\x00" * 100)           # frame 2 is truncated
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=4)
    luts = luts_for(cfg)
    whole, cut = str(tmp_path / "whole.enc"), str(tmp_path / "cut.enc")
    jvideo.encode_video(raw, whole, J(cfg), luts, J(PARAMS), frames=2)
    with open(cut, "wb") as f:
        f.write(read(whole)[:-200])
    with open(cut + "_SIZE", "wb") as f:
        f.write(read(whole + "_SIZE"))
    before = set(threading.enumerate())
    calls = [
        lambda: video.encode_video(raw, str(tmp_path / "a.enc"), cfg, luts,
                                   PARAMS, frames=4, batch=2, device="cpu"),
        lambda: video.encode_video(raw, str(tmp_path / "b.enc"), cfg, luts,
                                   PARAMS, frames=4, batch=1, device="cpu"),
        lambda: video.decode_video(cut, str(tmp_path / "c.raw"), cfg, luts,
                                   PARAMS, batch=2, device="cpu"),
        lambda: video.encode_video(raw, str(tmp_path / "no" / "d.enc"), cfg,
                                   luts, PARAMS, frames=2, batch=2,
                                   device="cpu"),
    ]
    for call in calls:
        err = _bounded(call)
        assert isinstance(err, (ValueError, OSError)), err
        assert set(threading.enumerate()) <= before


def test_batch_codec_frames_equal_torch_codec():
    """BatchCodec codes two frames in one launch; the batch's packed
    codestream, cut per frame, is TorchCodec.encode of each frame, and
    decode_batch gives the frames back."""
    rng = np.random.default_rng(11)
    frames = [make_image(rng, 64, 128) for _ in range(2)]
    cfg = CodecConfig(width=128, height=64, wavelet_levels=2)
    luts = luts_for(cfg)
    bc = BatchCodec(cfg, luts, PARAMS, 2, device="cpu")
    padded = torch.from_numpy(np.stack([mirror_pad(f, bc.aw, bc.ah)
                                        for f in frames]))
    blocks, max_mag = bc.prep_batch(padded)
    n_planes = bpc.planes_for_magnitude(int(max_mag))
    coded = bc.encode_blocks(blocks, n_planes)
    (streams, sizes), = coded
    assert streams.shape == (2 * bc.ncb, 4096)
    shorts = pack.pack_streams(streams, sizes, None).numpy().view(np.uint16)
    got = pack.split_frames(shorts, 2, bc.ncb, pack_header(cfg))
    codec = TorchCodec(cfg, luts, PARAMS, device="cpu")
    for g, f in zip(got, frames, strict=True):
        assert np.array_equal(g, codec.encode(f)[0])
    out = bc.decode_batch(coded, n_planes)
    assert np.array_equal(out.numpy(), padded.numpy())


def test_split_and_join_frames_invert_each_other():
    """split_frames of a batch's packed codestream gives each frame's own
    pack_streams; join_frames glues them back into the batch's."""
    rng = np.random.default_rng(12)
    n_frames, ncb = 3, 5
    n = n_frames * ncb
    sizes = torch.from_numpy(rng.integers(1, 40, n).astype(np.int32))
    sizes[4] = 4096                      # a raw copy
    streams = torch.from_numpy(rng.integers(-1, 65536, (n, 4096))
                               .astype(np.int32))
    header = np.arange(9, dtype=np.uint16)
    batch = pack.pack_streams(streams, sizes, None).numpy().view(np.uint16)
    frames = pack.split_frames(batch, n_frames, ncb, header)
    for f, got in enumerate(frames):
        rows = slice(f * ncb, (f + 1) * ncb)
        want = pack.pack_streams(streams[rows], sizes[rows], header)
        assert np.array_equal(got, want.numpy().view(np.uint16))
    joined, msb, z = pack.join_frames(frames, ncb)
    assert np.array_equal(joined, batch)
    assert np.array_equal(z, sizes.numpy())
    assert np.array_equal(msb, streams[:, 0].numpy() & 0xFFFF)
