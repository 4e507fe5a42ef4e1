"""TorchCodec and the port's CLI against TPUCodec and the NumPy oracle.

The codestreams are compared byte for byte and the decoded planes bit for
bit (tolerance 0); a lossy decode is compared with the oracle's decode,
also bit for bit. The port runs on the CPU here, where the BPC coder is
its plain PyTorch version.
"""

import os

import numpy as np
import pytest

from picsong_tpu.engine.pipeline import TPUCodec
from picsong_tpu.reference import codec as oracle
from picsong_tpu_torch.core.header import CodecConfig
from picsong_tpu_torch.core.image_io import (append_raw_frame, read_pgm,
                                             read_raw_frame, sample_dtype,
                                             write_pgm)
from picsong_tpu_torch.core.lut import LUTParams, load_luts, neutral_lut
from picsong_tpu_torch.engine import cli
from picsong_tpu_torch.engine.pipeline import TorchCodec

from torch_twins import J

PARAMS = LUTParams()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = (96 + 64 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, 8, size=(h, w)))
    return np.clip(base, 0, 255).astype(np.uint8)


def _neutral(wl):
    return [neutral_lut(PARAMS, wl, 2)], PARAMS


def _trained(wl):
    return load_luts(os.path.join(REPO, "luts", "trained_lossless"), wl, 2,
                     0.0)


@pytest.mark.parametrize("h,w,wl,luts", [
    (128, 128, 2, _neutral),
    (90, 130, 1, _neutral),          # mirror padding to 128x192
    (128, 128, 3, _trained),
])
def test_torch_codec_matches_tpu_codec_and_oracle(h, w, wl, luts):
    rng = np.random.default_rng(h + w + wl)
    img = make_image(rng, h, w)
    cfg = CodecConfig(width=w, height=h, wavelet_levels=wl)
    lut_list, params = luts(wl)
    codec = TorchCodec(cfg, lut_list, params, device="cpu")
    got = codec.encode(img)
    want = TPUCodec(J(cfg), lut_list, J(params)).encode(img)
    assert len(got) == len(want) == 1
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[0], oracle.encode_image(img, J(cfg), lut_list,
                                                      J(params))[0])
    out = codec.decode(got)
    assert out.dtype == np.uint8
    assert np.array_equal(out, img)


def test_torch_codec_signed_samples_round_trip():
    rng = np.random.default_rng(5)
    img = (make_image(rng, 64, 64).astype(np.int16) - 128).astype(np.int8)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=2, is_signed=True)
    luts, params = _neutral(2)
    codec = TorchCodec(cfg, luts, params, device="cpu")
    got = codec.encode(img)
    assert np.array_equal(got[0], oracle.encode_image(img, J(cfg), luts,
                                                      J(params))[0])
    assert np.array_equal(codec.decode(got), img)


@pytest.mark.parametrize("cfg_kw,item", [
    (dict(is_rgb=True, components=3, coding_passes=3), "item 8"),
    (dict(bps=12, bit_depth=12, k_factor=2.0), "item 8"),
    (dict(is_lossy=True, coding_passes=3), "item 8"),
    (dict(coding_passes=3), "item 8"),
    (dict(k_factor=4.0), "item 8"),
])
def test_torch_codec_rejects_unported_configs(cfg_kw, item):
    """The configurations refused until ROADMAP queue 1 `item` was ported
    (cp=3 and -k): each now codes to the oracle's bytes and decodes to the
    oracle's samples, which for lossless are the input's."""
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, **cfg_kw)
    luts, params = cli._load_luts("neutral", 1, cfg.coding_passes,
                                  cfg.k_factor)
    img = make_image(np.random.default_rng(len(cfg_kw)), 64, 64)
    if cfg.bps > 8:
        img = img.astype(np.uint16) * 16
    pixels = [np.roll(img, 7 * c, axis=1) for c in range(3)] if cfg.is_rgb \
        else img
    codec = TorchCodec(cfg, luts, params, device="cpu")
    got = codec.encode(pixels)
    want = oracle.encode_image(pixels, J(cfg), luts, J(params))
    assert all(np.array_equal(g, w) for g, w in zip(got, want, strict=True))
    out = codec.decode(got)
    expect = (oracle.decode_image(want, J(cfg), luts, J(params)) if cfg.is_lossy
              else pixels)
    assert np.array_equal(np.asarray(out), np.asarray(expect)), item


def test_torch_codec_rejects_chunking():
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1)
    with pytest.raises(NotImplementedError, match="Not ported"):
        TorchCodec(cfg, *_neutral(1), device="cpu", chunk_blocks=64)


@pytest.mark.parametrize("lut_folder", ["neutral", "trained"])
def test_cli_round_trip(tmp_path, lut_folder):
    rng = np.random.default_rng(13)
    img = make_image(rng, 128, 128)
    src, enc, dec = (str(tmp_path / n) for n in ("in.pgm", "out.enc",
                                                  "dec.pgm"))
    write_pgm(src, img)
    assert cli.main(["-cd", "0", "-i", src, "-o", enc, "-wl", "3", "-cp", "2",
                     "-type", "0", "-video", "0", "-LUTFolder", lut_folder,
                     "-k", "0", "--device", "cpu"]) == 0
    assert cli.main(["-cd", "1", "-i", enc, "-o", dec, "-video", "0",
                     "-LUTFolder", lut_folder, "--device", "cpu"]) == 0
    assert np.array_equal(read_pgm(dec), img)
    cfg = CodecConfig(width=128, height=128, wavelet_levels=3)
    luts, params = cli._load_luts(lut_folder, 3, 2, 0.0)
    want = oracle.encode_image(img, J(cfg), luts, J(params))[0]
    assert open(enc, "rb").read() == want.tobytes()


@pytest.mark.parametrize("flags", [
    ["-video", "1"], ["-sharded", "2"], ["-isRGB", "1", "-cp", "3"],
    ["-type", "1", "-k", "2"], ["-cp", "3"], ["-k", "2"],
    ["-bps", "12", "-cp", "3"],
])
def test_cli_unported_flags_exit_2(tmp_path, capsys, flags):
    """Video and sharded coding exit 2; the cp=3 and -k flags, refused
    until they were ported, now round-trip a planar RAW frame (bit-exact
    for lossless; a gray codestream is the oracle's, byte for byte)."""
    opts = dict(zip(flags[::2], flags[1::2]))
    rgb, bps = opts.get("-isRGB") == "1", int(opts.get("-bps", 8))
    img = make_image(np.random.default_rng(3), 64, 64).astype(np.uint16)
    planes = [np.roll(img, 7 * c, axis=1) << (bps - 8)
              for c in range(3 if rgb else 1)]
    dtype = sample_dtype(bps)
    src, enc, dec = (str(tmp_path / n) for n in ("in.raw", "o.enc", "d.raw"))
    for plane in planes:
        append_raw_frame(src, plane, dtype)
    rc = cli.main(["-cd", "0", "-i", src, "-o", enc, "-xSize", "64",
                   "-ySize", "64", "-wl", "1", "--device", "cpu", *flags])
    if flags[0] in ("-video", "-sharded"):
        assert rc == 2
        assert "not yet ported" in capsys.readouterr().out
        assert not os.path.exists(enc)
        return
    assert rc == 0
    assert cli.main(["-cd", "1", "-i", enc, "-o", dec, "--device",
                     "cpu"]) == 0
    back = [read_raw_frame(dec, 64, 64, c, dtype) for c in range(len(planes))]
    lossy = opts.get("-type") == "1"
    cp, k = int(opts.get("-cp", 2)), float(opts.get("-k", 0))
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, coding_passes=cp,
                      k_factor=k, is_lossy=lossy, bps=bps, bit_depth=bps,
                      is_rgb=rgb, components=3 if rgb else 1)
    luts, params = cli._load_luts("", 1, cp, k, lossy)
    if lossy:
        want = oracle.encode_image(planes[0], J(cfg), luts, J(params))
        assert open(enc, "rb").read() == want[0].tobytes()
        assert np.array_equal(back[0], oracle.decode_image(want, J(cfg), luts,
                                                           J(params)))
    else:
        assert all(np.array_equal(b, p) for b, p in zip(back, planes))
        if not rgb:
            want = oracle.encode_image(planes[0], J(cfg), luts, J(params))[0]
            assert open(enc, "rb").read() == want.tobytes()


def test_cli_decode_of_unported_stream_exits_2(tmp_path):
    """An oracle cp=3 codestream, refused until cp=3 was ported, now
    decodes through the CLI to the image, bit for bit."""
    img = make_image(np.random.default_rng(1), 64, 64)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, coding_passes=3)
    enc = tmp_path / "cp3.enc"
    enc.write_bytes(oracle.encode_image(
        img, J(cfg), [neutral_lut(J(PARAMS), 1, 3)], J(PARAMS))[0].tobytes())
    rc = cli.main(["-cd", "1", "-i", str(enc), "-o", str(tmp_path / "d.pgm"),
                   "--device", "cpu"])
    assert rc == 0
    assert np.array_equal(read_pgm(str(tmp_path / "d.pgm")), img)


def test_cli_validation_matches_reference_predicate(tmp_path, capsys):
    src = str(tmp_path / "in.pgm")
    write_pgm(src, np.zeros((64, 64), np.uint8))
    rc = cli.main(["-cd", "0", "-i", src, "-o", str(tmp_path / "o.enc"),
                   "-wl", "11", "--device", "cpu"])
    assert rc == 1
    assert "Incorrect parameters" in capsys.readouterr().out
