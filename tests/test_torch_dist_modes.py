"""The port's row-sharded `ShardedCodec` (`dist/sharded.py`) in every
image mode: RGB, lossy 9/7 (with the deep-level gather), 5/3 with the
gather, 12/16-bit and signed samples, three coding passes and complexity
scalability (`-k`); against `TPUCodec`, the single-device port and the
NumPy oracle (tests/test_torch_dist.py has the
shard counts, the uneven rows and the JAX `ShardedCodec`).

The shards sit on the CPU here (`["cpu"] * N`, where the JAX tests use
the 8-device CPU mesh of tests/conftest.py), so every halo, gather and
tiling copy runs, with the plain BPC coder. Codestreams are compared byte
for byte and lossless decodes bit for bit (tolerance 0); the lossy bytes
are held to the oracle's, which `TPUCodec`'s XLA:CPU 9/7 can miss by a
few coefficients (ROADMAP queue 3).
"""

import os

import numpy as np
import pytest

from picsong_tpu.engine.pipeline import TPUCodec
from picsong_tpu.reference import codec as oracle
from picsong_tpu_torch.core.header import CodecConfig
from picsong_tpu_torch.core.lut import LUTParams, load_luts, neutral_lut
from picsong_tpu_torch.dist.sharded import ShardedCodec
from picsong_tpu_torch.engine.pipeline import TorchCodec

from torch_twins import J

PARAMS = LUTParams()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_image(rng, h, w, lo=0, hi=255, dtype=np.uint8):
    y, x = np.mgrid[0:h, 0:w]
    span = hi - lo
    base = (lo + span / 2 + span / 3 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, span / 64, size=(h, w)))
    return np.clip(base, lo, hi).astype(dtype)


def sharded(cfg, n, luts=None):
    luts = luts or [neutral_lut(PARAMS, cfg.wavelet_levels, 2)]
    return ShardedCodec(cfg, luts, PARAMS, ["cpu"] * n)


def test_sharded_rgb_lossless_full_codestream():
    rng = np.random.default_rng(4)
    planes = [make_image(rng, 128, 64) for _ in range(3)]
    cfg = CodecConfig(width=64, height=128, wavelet_levels=1, is_rgb=True,
                      components=3)
    luts = [neutral_lut(PARAMS, 1, 2)] * 3
    codec = sharded(cfg, 2, luts)
    got = codec.encode(planes)
    want = TPUCodec(J(cfg), luts, J(PARAMS)).encode(planes)
    single = TorchCodec(cfg, luts, PARAMS, "cpu").encode(planes)
    assert len(got) == 3
    for g, w, s in zip(got, want, single):
        assert np.array_equal(g, w) and np.array_equal(g, s)
    for p, orig in zip(codec.decode(got), planes):
        assert np.array_equal(p, orig)


@pytest.mark.parametrize("h,wl,n", [(128, 2, 2), (256, 5, 4)])
def test_sharded_lossy_bytes_match_oracle(h, wl, n):
    """Lossy 9/7: the oracle's codestream and decoded samples. At wl=5 over
    4 shards, level 5 starts with 4 rows a shard, no more than the 9/7
    halo, so the LL is gathered onto the first shard for that level."""
    img = make_image(np.random.default_rng(5 + wl), h, 64)
    cfg = CodecConfig(width=64, height=h, wavelet_levels=wl, is_lossy=True,
                      qs=1.0)
    luts = [neutral_lut(PARAMS, wl, 2)]
    codec = sharded(cfg, n, luts)
    gathered = [len(spans) for spans in codec._plan]
    assert gathered[0] == n and (gathered[-1] == 1) == (wl == 5)
    got = codec.encode(img)
    want = oracle.encode_image(img, J(cfg), luts, J(PARAMS))
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(codec.decode(got),
                          oracle.decode_image(want, J(cfg), luts, J(PARAMS)))


def test_sharded_deep_lossless_gather():
    """5/3 at wl=6 over 4 shards: level 6 starts with 2 rows a shard, the
    5/3 halo, so the gather runs on the lossless path too."""
    img = make_image(np.random.default_rng(6), 256, 64)
    cfg = CodecConfig(width=64, height=256, wavelet_levels=6)
    codec = sharded(cfg, 4)
    assert [len(s) for s in codec._plan] == [4] * 5 + [1]
    got = codec.encode(img)
    want = TPUCodec(J(cfg), [neutral_lut(PARAMS, 6, 2)], J(PARAMS)).encode(img)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(codec.decode(got), img)


@pytest.mark.parametrize("bps,signed", [(12, False), (16, False), (16, True)])
def test_sharded_highdepth_matches_single(bps, signed):
    """12/16-bit and signed samples: TPUCodec's bytes, the sample type kept,
    a bit-exact decode."""
    if signed:
        lo, hi, dtype = -(1 << (bps - 1)), (1 << (bps - 1)) - 1, np.int16
    else:
        lo, hi, dtype = 0, (1 << bps) - 1, np.uint16
    img = make_image(np.random.default_rng(20 + bps + signed), 128, 64, lo,
                     hi, dtype)
    cfg = CodecConfig(width=64, height=128, wavelet_levels=1, bit_depth=bps,
                      bps=bps, is_signed=signed)
    codec = sharded(cfg, 2)
    got = codec.encode(img)
    want = TPUCodec(J(cfg), [neutral_lut(PARAMS, 1, 2)], J(PARAMS)).encode(img)
    assert np.array_equal(got[0], want[0])
    out = codec.decode(got)
    assert out.dtype == dtype and np.array_equal(out, img)


# (lossy, coding passes, k, LUT folder under luts/, or None: neutral)
CODING_MODES = [
    (False, 3, 0.0, None),
    (False, 2, 5.0, "trained_lossless"),
    (False, 3, 5.0, "trained_lossless"),
    (True, 2, 5.0, "trained_lossy"),
]


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("lossy,cp,k,folder", CODING_MODES)
def test_sharded_coding_modes_match_single(lossy, cp, k, folder, n):
    """cp=3 and -k 5 (the bulk pass, with every bitplane group's LUT),
    lossless and lossy, over 2 and 3 shards of 256x128 at wl=2: the
    unsharded TorchCodec's codestream byte for byte and its decode, and
    lossless the input."""
    wl = 2
    img = make_image(np.random.default_rng(30 + cp + int(k)), 128, 256)
    cfg = CodecConfig(width=256, height=128, wavelet_levels=wl,
                      is_lossy=lossy, qs=1.0, coding_passes=cp, k_factor=k)
    if folder is None:
        luts, params = [neutral_lut(PARAMS, wl, cp)], PARAMS
    else:
        luts, params = load_luts(os.path.join(REPO, "luts", folder), wl, cp,
                                 k)
    codec = ShardedCodec(cfg, luts, params, ["cpu"] * n)
    single = TorchCodec(cfg, luts, params, "cpu")
    got, want = codec.encode(img), single.encode(img)
    assert len(got) == len(want) == 1
    assert np.array_equal(got[0], want[0])
    out = codec.decode(got)
    assert np.array_equal(out, single.decode(want))
    if not lossy:
        assert np.array_equal(out, img)
