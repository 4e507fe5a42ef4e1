"""Every digest that `chip_smoke.py` holds the card to, regenerated from the
NumPy oracle (`picsong_tpu.reference`) on the CPU.

`picsong_tpu_torch/tools/goldens.py` records the digests, so that the card
run needs neither the oracle nor the JAX package; this file is what ties
them to the oracle. Each digest is SHA-256 over exact integer bytes
(tolerance 0).
"""

import os

import numpy as np
import pytest

from picsong_tpu.core.header import CodecConfig
from picsong_tpu.core.lut import LUTParams, load_luts, neutral_lut
from picsong_tpu.reference import bpc as obpc
from picsong_tpu.reference import codec as oracle
from picsong_tpu.reference import dwt as odwt
from picsong_tpu_torch.tools import goldens

PARAMS = LUTParams()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUT_DIRS = {"trained": os.path.join(REPO, "luts", "trained_lossless")}


def _luts(folder, wl, cp, k):
    if folder == "neutral":
        groups = PARAMS.n_bitplane_files if k > 0 else 1
        return [neutral_lut(PARAMS, wl, cp, groups)], PARAMS
    return load_luts(LUT_DIRS[folder], wl, cp, k)


def oracle_codestream_512(cp, k):
    cfg = CodecConfig(width=512, height=512, wavelet_levels=1,
                      coding_passes=cp, k_factor=k)
    luts, params = _luts("neutral", 1, cp, k)
    return goldens.digest(oracle.encode_image(goldens.make_image(512), cfg,
                                              luts, params)[0])


def oracle_lossy_512():
    cfg = CodecConfig(width=512, height=512, wavelet_levels=3, is_lossy=True,
                      qs=1.0)
    luts, params = _luts("neutral", 3, 2, 0.0)
    streams = oracle.encode_image(goldens.make_image(512), cfg, luts, params)
    return {"codestream": goldens.digest(streams[0]),
            "decoded": goldens.digest(oracle.decode_image(streams, cfg, luts,
                                                          params))}


def blocks_2048():
    """The oracle's codeblocks of the 2048^2 wl=5 lossless plane and the
    index of the first codeblock of every (level, subband)."""
    plane = goldens.make_image(2048).astype(np.int32) - 128
    coeffs = odwt.dwt_forward(plane, 5, False, 1.0).astype(np.int32)
    levels, subbands = oracle.codeblock_bands(2048, 2048, 5)
    picks = {}
    for i, band in enumerate(zip(levels.tolist(), subbands.tolist())):
        picks.setdefault(band, i)
    return oracle.plane_to_codeblocks(coeffs), levels, subbands, picks


def oracle_picks(cp, k, folder):
    blocks, levels, subbands, picks = blocks_2048()
    luts, params = _luts(folder, 5, cp, k)
    out = {}
    for i in sorted(picks.values()):
        stream, size = obpc.encode_codeblock(
            blocks[i], int(levels[i]), int(subbands[i]), luts[0], params, 5,
            coding_passes=cp, k_factor=k)
        out[i] = goldens.digest(stream.astype(np.int32), np.int32(size))
    return out


@pytest.mark.parametrize("key", sorted(goldens.IMAGES))
def test_image_digests(key):
    assert goldens.digest(goldens.make_image(*key)) == goldens.IMAGES[key]


def test_make_image_is_integer_pattern():
    a = goldens.make_image(64, seed=1)
    assert a.dtype == np.uint8 and a.shape == (64, 64)
    b = goldens.make_image(64, seed=1, width=96, peak=65535)
    assert b.dtype == np.uint16 and b.shape == (64, 96)
    assert np.array_equal(goldens.make_image(64, seed=1), a)


@pytest.mark.parametrize("cp,k", sorted(goldens.CODESTREAMS_512))
def test_codestream_512_digests(cp, k):
    assert oracle_codestream_512(cp, k) == goldens.CODESTREAMS_512[(cp, k)]


def test_lossy_512_digests():
    assert oracle_lossy_512() == goldens.LOSSY_512


def test_block_digests_2048():
    blocks, _, _, picks = blocks_2048()
    assert len(picks) == 3 * 5 + 1
    assert {i: goldens.digest(blocks[i]) for i in picks.values()} \
        == goldens.BLOCKS_2048


@pytest.mark.parametrize("config", sorted(goldens.PICKS_2048))
def test_pick_digests_2048(config):
    assert oracle_picks(*config) == goldens.PICKS_2048[config]
