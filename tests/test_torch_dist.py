"""The port's row-sharded `ShardedCodec` (`dist/sharded.py`) against the
single-device port, `TPUCodec`, the JAX `ShardedCodec` and the NumPy
oracle.

The shards sit on the CPU here (`["cpu"] * N`, where the JAX tests use
the 8-device CPU mesh of tests/conftest.py), so every halo, gather and
tiling copy runs, with the plain BPC coder. Codestreams are compared byte
for byte and lossless decodes bit for bit (tolerance 0); the lossy bytes
are held to the oracle's, which `TPUCodec`'s XLA:CPU 9/7 can miss by a
few coefficients (ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch

from picsong_tpu.dist.sharded import ShardedCodec as JaxShardedCodec
from picsong_tpu.dist.sharded import make_mesh
from picsong_tpu.engine.pipeline import TPUCodec
from picsong_tpu_torch.core.header import CodecConfig
from picsong_tpu_torch.core.image_io import mirror_pad
from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
from picsong_tpu_torch.dist.sharded import (ShardedCodec, make_devices,
                                            placement, shares)
from picsong_tpu_torch.engine.pipeline import TorchCodec

from torch_twins import J

PARAMS = LUTParams()


def make_image(rng, h, w, lo=0, hi=255, dtype=np.uint8):
    y, x = np.mgrid[0:h, 0:w]
    span = hi - lo
    base = (lo + span / 2 + span / 3 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, span / 64, size=(h, w)))
    return np.clip(base, lo, hi).astype(dtype)


def sharded(cfg, n, luts=None):
    luts = luts or [neutral_lut(PARAMS, cfg.wavelet_levels, 2)]
    return ShardedCodec(cfg, luts, PARAMS, ["cpu"] * n)


@pytest.fixture(scope="module")
def gray():
    """256x128 gray, wl=2 (4 codeblock rows, 8 codeblocks): the port's
    and TPUCodec's codestreams."""
    img = make_image(np.random.default_rng(0), 256, 128)
    cfg = CodecConfig(width=128, height=256, wavelet_levels=2)
    luts = [neutral_lut(PARAMS, 2, 2)]
    want = TorchCodec(cfg, luts, PARAMS, "cpu").encode(img)
    tpu = TPUCodec(J(cfg), luts, J(PARAMS)).encode(img)
    assert np.array_equal(want[0], tpu[0])
    return img, cfg, want


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_sharded_gray_matches_single_device(gray, n):
    """1-8 shards; 8 of them are more shards than codeblock rows (4): four
    shards hold no rows, and each holds one of the 8 codeblocks, which the
    mosaic's rows put together from other shards' subbands. The codestream
    of the single-device port (== TPUCodec's), and a bit-exact decode."""
    img, cfg, want = gray
    codec = sharded(cfg, n)
    if n == 8:
        assert [r1 - r0 for r0, r1 in codec.rows].count(0) == 4
        assert [b1 - b0 for _, b0, b1 in codec.blocks] == [1] * 8
    got = codec.encode(img)
    assert len(got) == 1 and np.array_equal(got[0], want[0])
    assert np.array_equal(codec.decode(got), img)


def test_sharded_matches_jax_sharded_codec(gray):
    """The same bytes as the JAX ShardedCodec on 4 devices of the 8-device
    CPU mesh."""
    img, cfg, want = gray
    jax_codec = JaxShardedCodec(J(cfg), [neutral_lut(PARAMS, 2, 2)],
                                J(PARAMS), make_mesh(4))
    got = sharded(cfg, 4).encode(img)
    assert np.array_equal(got[0], jax_codec.encode(img)[0])
    assert np.array_equal(got[0], want[0])


def test_sharded_plane_round_trip():
    """encode_plane / decode_plane on a DC-shifted plane (the JAX
    test_sharded_decode_roundtrip): the streams of the single-device
    coder, and the plane back."""
    img = make_image(np.random.default_rng(1), 128, 128)
    cfg = CodecConfig(width=128, height=128, wavelet_levels=1)
    codec = sharded(cfg, 2)
    plane = mirror_pad(img, 128, 128).astype(np.int32) - 128
    streams, sizes = codec.encode_plane(plane)
    single = TorchCodec(cfg, [neutral_lut(PARAMS, 1, 2)], PARAMS, "cpu")
    [(want_s, want_z)], _ = single.encode_planes([torch.from_numpy(img)])
    assert np.array_equal(sizes, want_z.numpy())
    assert np.array_equal(streams, want_s.numpy())
    assert np.array_equal(codec.decode_plane(streams, sizes), plane)


@pytest.mark.parametrize("n", [3, 4])
def test_sharded_uneven_rows_match_single(n):
    """320 rows (5 codeblock rows) over 3 and 4 shards (2/2/1, 2/1/1/1
    rows of codeblocks): a 310x100 image, mirror-padded to 320x128."""
    img = make_image(np.random.default_rng(22 + n), 310, 100)
    cfg = CodecConfig(width=100, height=310, wavelet_levels=2)
    codec = sharded(cfg, n)
    assert codec.ah == 320 and [r1 - r0 for r0, r1 in codec.rows] == \
        [64 * k for k in ([2, 2, 1] if n == 3 else [2, 1, 1, 1])]
    want = TorchCodec(cfg, [neutral_lut(PARAMS, 2, 2)], PARAMS,
                      "cpu").encode(img)
    got = codec.encode(img)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(codec.decode(got), img)


def test_make_devices_and_placement():
    assert make_devices(3, "cpu") == [torch.device("cpu")] * 3
    assert make_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert placement(make_devices(2, "cpu")) == "2 shards on the CPU"
    assert placement(["cuda:0", "cuda:0"]) == \
        "2 shards on 1 card(s) (cuda:0, cuda:0)"
    with pytest.raises(ValueError):
        make_devices(0, "cpu")
    if not torch.cuda.is_available():
        # no CPU fallback for a request of cards
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_devices(2, "cuda")
    assert shares(17, 4) == [(0, 5), (5, 9), (9, 13), (13, 17)]
    assert shares(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
