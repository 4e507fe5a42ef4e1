"""Each kernel's work count, checked by hand at one small shape."""

import numpy as np
import pytest

from benchmark.reference.codec import Coded, Config
from benchmark.roofline import k1, k2, peaks, x2, x3_pack, x3_unpack, x4

INT32 = 132 * 64 * 1.98e9
HBM = 3.35e12


def _cfg(**change):
    base = dict(width=128, height=64, components=1, is_rgb=False,
                bit_depth=8, bps=8, is_signed=False, endianess=0,
                is_lossy=False, qs=1.0, wavelet_levels=2, coding_passes=2,
                k_factor=0.0, cb_height=18, cb_width=64)
    return Config(**dict(base, **change))


# two blocks: MSB 3 with 10 nonzero coefficients and 7 coded words, and
# an empty one (MSB -1, one word)
CODED = Coded(codestreams=[], decoded=[], msb=[np.array([3, -1])],
              nonzero=[np.array([10, 0])], words=[np.array([7, 1])])


def test_peaks():
    assert peaks.INT32_OPS_PER_S == pytest.approx(16.72704e12)
    assert peaks.least_seconds(3.35e12, 0, 1.0) == pytest.approx(3.35e12)
    assert peaks.least_seconds(1.0, 6.7e12, 1e12) == pytest.approx(2.0)


@pytest.mark.parametrize("kernel", [k1, k2])
def test_bpc(kernel):
    # symbols: 4 planes x 4096 cells + 10 signs; 12 ops each
    ops = 12 * (4 * 4096 + 10)
    # bytes: 2 blocks x 4096 int32 coefficients + 8 coded 16-bit words
    nbytes = 2 * 4096 * 4 + 8 * 2
    assert ops / INT32 > nbytes / HBM
    assert kernel.least_seconds(CODED, _cfg()) == pytest.approx(ops / INT32)


def test_bpc_sums_components():
    three = Coded([], [], CODED.msb * 3, CODED.nonzero * 3, CODED.words * 3)
    assert k1.least_seconds(three, _cfg()) == pytest.approx(
        3 * k1.least_seconds(CODED, _cfg()))


@pytest.mark.parametrize("kernel", [x2, x4])
def test_dwt_53(kernel):
    # 64 x 128 uint8 samples in, int32 out; 7 ops a sample at level 0 and
    # at level 1 on a quarter: bound by bytes
    samples = 64 * 128
    nbytes = samples * (1 + 4)
    ops = 7 * (samples + samples / 4)
    assert nbytes / HBM > ops / INT32
    assert kernel.least_seconds(CODED, _cfg()) == pytest.approx(
        nbytes / HBM)


def test_dwt_97_rgb():
    cfg = _cfg(is_lossy=True, wavelet_levels=3)
    samples = 64 * 128
    ops = 14 * samples * (1 + 1 / 4 + 1 / 16)
    expect = max(samples * 5 / HBM, ops / 67e12)
    assert x2.least_seconds(CODED, cfg) == pytest.approx(expect)
    rgb = _cfg(is_rgb=True)
    assert x2.least_seconds(CODED, rgb) == pytest.approx(
        3 * x2.least_seconds(CODED, _cfg()))


@pytest.mark.parametrize("kernel", [x3_pack, x3_unpack])
def test_pack(kernel):
    # 2 blocks, payload 6 + 0 words: the fields are 2 x 2 + 6 shorts, the
    # codestream 9 + 10 + 1 shorts; every short read or written once
    fields = 2 * 2 + 6
    codestream = 9 + fields + 1
    assert kernel.least_seconds(CODED, _cfg()) == pytest.approx(
        2 * (fields + codestream) / HBM)
