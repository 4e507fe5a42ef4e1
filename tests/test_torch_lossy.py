"""The port's lossy 9/7 path against the NumPy oracle and TPUCodec.

The torch 9/7 DWT runs the JAX op order in float32, one rounding per op,
so it equals the oracle (`reference/dwt.py`) exactly: the float mosaic and
the quantized int32 coefficients forward, and the float32 plane back
(tolerance 0 both ways). The lossy codestreams are therefore byte-equal to
the oracle's. The JAX DWT on XLA:CPU is not bit-identical to the oracle
(its fused float ops round differently), so against TPUCodec the gates are
a tolerance: quantized coefficients may differ by +-1 in at most 1e-4 of
the positions, and cross-decoded PSNR must stay within 0.05 dB of the
oracle's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picsong_tpu.engine.pipeline import TPUCodec
from picsong_tpu.reference import codec as oracle
from picsong_tpu.reference import dwt as odwt
from picsong_tpu_torch.core.header import CodecConfig
from picsong_tpu_torch.core.image_io import read_pgm, write_pgm
from picsong_tpu_torch.core.lut import LUTParams, load_luts, neutral_lut
from picsong_tpu_torch.engine import cli
from picsong_tpu_torch.engine.pipeline import TorchCodec
from picsong_tpu_torch.transform import dwt as tdwt

from torch_twins import J

PARAMS = LUTParams()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = (96 + 64 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, 8, size=(h, w)))
    return np.clip(base, 0, 255).astype(np.uint8)


def psnr(a, b, peak=255.0):
    err = a.astype(np.float64) - b.astype(np.float64)
    return 10 * np.log10(peak ** 2 / max(float(np.mean(err * err)), 1e-12))


@pytest.mark.parametrize("qs", [1.0, 0.5])
@pytest.mark.parametrize("levels", [1, 2, 3])
def test_97_forward_matches_oracle_exactly(levels, qs):
    rng = np.random.default_rng(levels)
    plane = (make_image(rng, 256, 192).astype(np.int32) - 128).astype(
        np.float32)
    want = odwt.dwt_forward(plane, levels, lossy=True, qs=qs)
    got = tdwt.dwt_forward(torch.from_numpy(plane), levels, lossy=True,
                           qs=qs)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.to(torch.int32).numpy(), want.astype(np.int32))


@pytest.mark.parametrize("qs", [1.0, 0.5])
@pytest.mark.parametrize("levels", [1, 2, 3])
def test_97_reverse_matches_oracle_exactly(levels, qs):
    rng = np.random.default_rng(10 + levels)
    plane = (make_image(rng, 128, 256).astype(np.int32) - 128).astype(
        np.float32)
    q = odwt.dwt_forward(plane, levels, lossy=True, qs=qs).astype(np.int32)
    q[::7, ::5] = -q[::7, ::5]                # both signs in every band
    want = odwt.dwt_reverse(q, levels, lossy=True, qs=qs)
    got = tdwt.dwt_reverse(torch.from_numpy(q), levels, lossy=True, qs=qs)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


def _lossy_case(lut_kind):
    """tests/test_engine.py::test_engine_lossy_matches_oracle's case."""
    rng = np.random.default_rng(12)
    img = make_image(rng, 128, 128)
    cfg = CodecConfig(width=128, height=128, wavelet_levels=3, is_lossy=True,
                      qs=1.0)
    if lut_kind == "neutral":
        return img, cfg, [neutral_lut(PARAMS, 3, 2)], PARAMS
    luts, params = load_luts(os.path.join(REPO, "luts", "trained_lossy"), 3,
                             2, 0.0)
    return img, cfg, luts, params


@pytest.mark.parametrize("lut_kind", ["neutral", "trained"])
def test_lossy_codestream_and_decode_match_oracle(lut_kind):
    img, cfg, luts, params = _lossy_case(lut_kind)
    codec = TorchCodec(cfg, luts, params, device="cpu")
    got = codec.encode(img)
    want = oracle.encode_image(img, J(cfg), luts, J(params))
    assert len(got) == 1 and np.array_equal(got[0], want[0])
    out = codec.decode(got)
    assert out.dtype == np.uint8
    assert np.array_equal(out, oracle.decode_image(want, J(cfg), luts, J(params)))
    assert psnr(out, img) > 40.0


def test_lossy_against_tpu_codec_within_tolerance():
    img, cfg, luts, params = _lossy_case("neutral")
    tc = TorchCodec(cfg, luts, params, device="cpu")
    jc = TPUCodec(J(cfg), luts, J(params))

    plane = torch.from_numpy(np.asarray(img))
    q_torch = tc._dwt_tile_impl(tc._prep_gray_impl(plane))[0].numpy()
    q_jax = np.asarray(jc._dwt_tile(jc._prep_gray(jnp.asarray(img)))[0])
    diff = np.abs(q_torch.astype(np.int64) - q_jax)
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= 1e-4 * diff.size

    torch_streams, jax_streams = tc.encode(img), jc.encode(img)
    oracle_psnr = psnr(oracle.decode_image(
        oracle.encode_image(img, J(cfg), luts, J(params)), J(cfg), luts, J(params)), img)
    for decoded in (tc.decode(jax_streams), jc.decode(torch_streams),
                    tc.decode(torch_streams)):
        assert psnr(decoded, img) >= oracle_psnr - 0.05


def test_cli_lossy_round_trip_matches_oracle(tmp_path):
    rng = np.random.default_rng(21)
    img = make_image(rng, 128, 128)
    src, enc, dec = (str(tmp_path / n) for n in ("in.pgm", "o.enc", "d.pgm"))
    write_pgm(src, img)
    assert cli.main(["-cd", "0", "-i", src, "-o", enc, "-wl", "3", "-type",
                     "1", "-qs", "0.5", "-LUTFolder", "trained",
                     "--device", "cpu"]) == 0
    assert cli.main(["-cd", "1", "-i", enc, "-o", dec, "-LUTFolder",
                     "trained", "--device", "cpu"]) == 0
    cfg = CodecConfig(width=128, height=128, wavelet_levels=3, is_lossy=True,
                      qs=0.5)
    luts, params = cli._load_luts("trained", 3, 2, 0.0, lossy=True)
    want = oracle.encode_image(img, J(cfg), luts, J(params))
    assert open(enc, "rb").read() == want[0].tobytes()
    assert np.array_equal(read_pgm(dec),
                          oracle.decode_image(want, J(cfg), luts, J(params)))
