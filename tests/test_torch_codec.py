"""TorchCodec and the port's CLI against TPUCodec and the NumPy oracle.

The codestreams are compared byte for byte and the decoded planes bit for
bit (tolerance 0): the slice is lossless. The port runs on the CPU here,
where the BPC coder is its plain PyTorch version.
"""

import os

import numpy as np
import pytest

from picsong_tpu.core.header import CodecConfig
from picsong_tpu.core.image_io import read_pgm, write_pgm
from picsong_tpu.core.lut import LUTParams, load_luts, neutral_lut
from picsong_tpu.engine.pipeline import TPUCodec
from picsong_tpu.reference import codec as oracle
from picsong_tpu_torch.engine import cli
from picsong_tpu_torch.engine.pipeline import TorchCodec

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
    want = TPUCodec(cfg, lut_list, params).encode(img)
    assert len(got) == len(want) == 1
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[0], oracle.encode_image(img, cfg, lut_list,
                                                      params)[0])
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
    assert np.array_equal(got[0], oracle.encode_image(img, cfg, luts,
                                                      params)[0])
    assert np.array_equal(codec.decode(got), img)


@pytest.mark.parametrize("cfg_kw,item", [
    (dict(is_rgb=True, components=3, coding_passes=3), "item 8"),
    (dict(bps=12, bit_depth=12, k_factor=2.0), "item 8"),
    (dict(is_lossy=True, coding_passes=3), "item 8"),
    (dict(coding_passes=3), "item 8"),
    (dict(k_factor=4.0), "item 8"),
])
def test_torch_codec_rejects_unported_configs(cfg_kw, item):
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, **cfg_kw)
    with pytest.raises(NotImplementedError, match=item):
        TorchCodec(cfg, *_neutral(1), device="cpu")


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
    want = oracle.encode_image(img, cfg, luts, params)[0]
    assert open(enc, "rb").read() == want.tobytes()


@pytest.mark.parametrize("flags", [
    ["-video", "1"], ["-sharded", "2"], ["-isRGB", "1", "-cp", "3"],
    ["-type", "1", "-k", "2"], ["-cp", "3"], ["-k", "2"],
    ["-bps", "12", "-cp", "3"],
])
def test_cli_unported_flags_exit_2(tmp_path, capsys, flags):
    src = str(tmp_path / "in.pgm")
    write_pgm(src, np.zeros((64, 64), np.uint8))
    rc = cli.main(["-cd", "0", "-i", src, "-o", str(tmp_path / "o.enc"),
                   "-wl", "1", "--device", "cpu", *flags])
    assert rc == 2
    assert "not yet ported" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "o.enc")


def test_cli_decode_of_unported_stream_exits_2(tmp_path, capsys):
    img = make_image(np.random.default_rng(1), 64, 64)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, coding_passes=3)
    enc = tmp_path / "cp3.enc"
    enc.write_bytes(oracle.encode_image(
        img, cfg, [neutral_lut(PARAMS, 1, 3)], PARAMS)[0].tobytes())
    rc = cli.main(["-cd", "1", "-i", str(enc), "-o", str(tmp_path / "d.pgm"),
                   "--device", "cpu"])
    assert rc == 2
    assert "not yet ported" in capsys.readouterr().out


def test_cli_validation_matches_reference_predicate(tmp_path, capsys):
    src = str(tmp_path / "in.pgm")
    write_pgm(src, np.zeros((64, 64), np.uint8))
    rc = cli.main(["-cd", "0", "-i", src, "-o", str(tmp_path / "o.enc"),
                   "-wl", "11", "--device", "cpu"])
    assert rc == 1
    assert "Incorrect parameters" in capsys.readouterr().out
