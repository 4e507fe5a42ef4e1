"""TorchCodec with three coding passes (-cp 3) and complexity scalability
(-k 5) against the NumPy oracle and TPUCodec (JAX on the CPU).

Codestreams are compared byte for byte and decoded samples bit for bit
(tolerance 0). The port runs on the CPU here, where the BPC coder is its
plain PyTorch version.
"""

import numpy as np
import pytest

from picsong_tpu.engine.pipeline import TPUCodec
from picsong_tpu.reference import codec as oracle
from picsong_tpu_torch.core.header import CodecConfig
from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
from picsong_tpu_torch.engine.pipeline import TorchCodec

from torch_twins import J

PARAMS = LUTParams()


def make_image(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (96 + 64 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, 8, size=(h, w)))
    return np.clip(base, 0, 255).astype(np.uint8)


def _luts(cfg):
    groups = PARAMS.n_bitplane_files if cfg.k_factor > 0 else 1
    return [neutral_lut(PARAMS, cfg.wavelet_levels, cfg.coding_passes,
                        groups)]


@pytest.mark.parametrize("wl", [2, 3])
@pytest.mark.parametrize("mode", [dict(coding_passes=3), dict(k_factor=5.0)])
def test_lossless_matches_oracle_and_tpu_codec(mode, wl):
    img = make_image(wl, 128, 128)
    cfg = CodecConfig(width=128, height=128, wavelet_levels=wl, **mode)
    luts = _luts(cfg)
    codec = TorchCodec(cfg, luts, PARAMS, device="cpu")
    got = codec.encode(img)
    assert np.array_equal(got[0], oracle.encode_image(img, J(cfg), luts,
                                                      J(PARAMS))[0])
    assert np.array_equal(got[0], TPUCodec(J(cfg), luts, J(PARAMS)).encode(img)[0])
    assert np.array_equal(codec.decode(got), img)


def test_lossy_k5_matches_oracle():
    img = make_image(9, 128, 128)
    cfg = CodecConfig(width=128, height=128, wavelet_levels=2, is_lossy=True,
                      qs=1.0, k_factor=5.0)
    luts = _luts(cfg)
    codec = TorchCodec(cfg, luts, PARAMS, device="cpu")
    got = codec.encode(img)
    want = oracle.encode_image(img, J(cfg), luts, J(PARAMS))
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(codec.decode(got),
                          oracle.decode_image(want, J(cfg), luts, J(PARAMS)))
