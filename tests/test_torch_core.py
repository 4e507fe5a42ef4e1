"""The port's own copies of the core layers against the JAX package's, and
its device pack/unpack against the host pack of `picsong_tpu.native` and
`picsong_tpu.assembly.pack`.

Each side builds its own objects from the same numbers; every comparison
is exact (tolerance 0).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from picsong_tpu import native
from picsong_tpu.assembly import pack as jpack
from picsong_tpu.core import geometry as jgeom
from picsong_tpu.core import header as jheader
from picsong_tpu.core import image_io as jio
from picsong_tpu.core import lut as jlut
from picsong_tpu.core import spec as jspec
from picsong_tpu_torch.assembly import pack
from picsong_tpu_torch.core import geometry, header, image_io, lut, spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", [
    "CBLOCK_WIDTH", "CBLOCK_LENGTH", "CBLOCK_SIZE", "LANES",
    "AC_INTERVAL_INIT", "MAX_RESERVED_SLOT", "MAX_SLOT_COUNT",
    "BIT_SIGNIFICANT", "BIT_CP_CANDIDATE", "BIT_REFINEMENT", "BITPLANE_SHIFT",
    "MAGNITUDE_MASK", "I97_ALPHA", "I97_BETA", "I97_GAMMA", "I97_DELTA",
    "I97_K1", "I97_K2", "WAVELET_QSTEPS", "RECONSTRUCTION_FACTOR",
    "ICT_FORWARD", "ICT_BACKWARD", "SUBBAND_HL", "SUBBAND_LH", "SUBBAND_HH",
    "QS_LL", "QS_HL", "QS_LH", "QS_HH"])
def test_spec_constants_equal(name):
    got, want = getattr(spec, name), getattr(jspec, name)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    assert np.array_equal(got, want)


def test_spec_functions_equal():
    for w, h in ((1, 1), (64, 64), (130, 90), (2048, 2560)):
        assert spec.adapted_size(w, h) == jspec.adapted_size(w, h)
    for wl in range(1, 11):
        for level in range(wl + 1):
            for sb in range(3):
                assert (spec.l2norm_column(level, sb, wl)
                        == jspec.l2norm_column(level, sb, wl))


def _configs():
    rng = np.random.default_rng(0)
    for _ in range(40):
        yield dict(width=int(rng.integers(1, 9000)),
                   height=int(rng.integers(1, 9000)),
                   components=int(rng.integers(1, 4)),
                   coding_passes=int(rng.choice([2, 3])),
                   cb_height=int(rng.integers(18, 21)),
                   wavelet_levels=int(rng.integers(1, 8)),
                   bit_depth=int(rng.choice([8, 12, 16])),
                   is_lossy=bool(rng.integers(2)),
                   qs=float(rng.integers(0, 10001)) / 10000,
                   is_rgb=bool(rng.integers(2)),
                   endianess=int(rng.integers(2)),
                   bps=int(rng.choice([8, 12, 16])),
                   is_signed=bool(rng.integers(2)),
                   frames=int(rng.integers(0, 1000)),
                   k_factor=float(rng.integers(0, 65536)) / 1000)


def test_header_pack_unpack_equal():
    for kw in _configs():
        got = header.pack_header(header.CodecConfig(**kw))
        want = jheader.pack_header(jheader.CodecConfig(**kw))
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert (dataclasses.asdict(header.unpack_header(got))
                == dataclasses.asdict(jheader.unpack_header(want)))


@pytest.mark.parametrize("folder", ["trained_lossless", "trained_lossy",
                                    "trained_video_lossless",
                                    "trained_video_lossy"])
@pytest.mark.parametrize("wl,cp,k", [(5, 2, 0.0), (3, 3, 0.0), (1, 2, 5.0)])
def test_load_luts_equal(folder, wl, cp, k):
    path = os.path.join(REPO, "luts", folder)
    got, gparams = lut.load_luts(path, wl, cp, k)
    want, wparams = jlut.load_luts(path, wl, cp, k)
    assert dataclasses.asdict(gparams) == dataclasses.asdict(wparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_neutral_lut_and_geometry_equal():
    p, jp = lut.LUTParams(), jlut.LUTParams()
    for wl in range(1, 11):
        for cp in (2, 3):
            for groups in (1, 15):
                assert np.array_equal(lut.neutral_lut(p, wl, cp, groups),
                                      jlut.neutral_lut(jp, wl, cp, groups))
            assert p.section_offsets(wl, cp) == jp.section_offsets(wl, cp)
            assert p.size_per_group(wl, cp) == jp.size_per_group(wl, cp)
        assert p.stride_per_group(wl) == jp.stride_per_group(wl)
        for level in range(wl + 1):
            for sb in range(3):
                for n_ctx in (1, 4, 9):
                    assert (lut.group_base(p, wl, level, sb, n_ctx)
                            == jlut.group_base(jp, wl, level, sb, n_ctx))


@pytest.mark.parametrize("w,h,wl", [(64, 64, 1), (192, 128, 2),
                                    (2048, 2560, 5), (512, 512, 7)])
def test_codeblock_bands_equal(w, h, wl):
    got, want = geometry.codeblock_bands(w, h, wl), jgeom.codeblock_bands(w, h, wl)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and np.array_equal(g, x)


def test_image_io_equal(tmp_path):
    rng = np.random.default_rng(1)
    img8 = rng.integers(0, 256, size=(37, 53), dtype=np.uint8)
    img16 = rng.integers(0, 65536, size=(21, 19)).astype(np.uint16)
    for name, img, depth in (("a.pgm", img8, 8), ("b.pgm", img16, 16)):
        image_io.write_pgm(str(tmp_path / name), img, depth)
        jio.write_pgm(str(tmp_path / ("j" + name)), img, depth)
        assert ((tmp_path / name).read_bytes()
                == (tmp_path / ("j" + name)).read_bytes())
        assert np.array_equal(image_io.read_pgm(str(tmp_path / name)),
                              jio.read_pgm(str(tmp_path / name)))
    assert np.array_equal(image_io.mirror_pad(img8, 64, 64),
                          jio.mirror_pad(img8, 64, 64))
    for bps, end, sig in ((8, 0, False), (8, 0, True), (16, 1, False),
                          (12, 0, True)):
        dt = image_io.sample_dtype(bps, end, sig)
        assert dt == jio.sample_dtype(bps, end, sig)
        raw = tmp_path / f"r{bps}{end}{sig}.raw"
        image_io.append_raw_frame(str(raw), img16 >> 4, dt)
        image_io.append_raw_frame(str(raw), img16 >> 5, dt)
        for f in (0, 1):
            assert np.array_equal(
                image_io.read_raw_frame(str(raw), 19, 21, f, dt),
                jio.read_raw_frame(str(raw), 19, 21, f, dt))
    enc = str(tmp_path / "o.enc")
    image_io.write_codestream(enc, img16[0], first=True)
    image_io.write_codestream(enc, img16[1], first=False)
    assert image_io.read_sizes(enc) == jio.read_sizes(enc) == [19, 19]
    assert np.array_equal(image_io.read_codestream(enc, 19, 19),
                          jio.read_codestream(enc, 19, 19))
    assert np.array_equal(image_io.read_header_shorts(enc),
                          jio.read_header_shorts(enc))


def _batch(seed, n, sizes_kind):
    """(N, 4096) int32 streams (word 0 an MSB word, -1 past the size) and
    sizes: all empty (1), all raw (4096), or mixed with both."""
    rng = np.random.default_rng(seed)
    if sizes_kind == "empty":
        sizes = np.ones(n, dtype=np.int64)
    elif sizes_kind == "raw":
        sizes = np.full(n, 4096, dtype=np.int64)
    else:
        sizes = rng.integers(1, 4097, size=n).astype(np.int64)
        sizes[:3] = (1, 4096, 2)
    streams = np.full((n, 4096), -1, dtype=np.int32)
    for i, z in enumerate(sizes):
        streams[i, :z] = rng.integers(0, 1 << 16, size=z)
    streams[:, 0] = np.where(sizes == 1, 32, rng.integers(0, 16, size=n))
    streams[sizes == 4096] = rng.integers(0, 1 << 16, size=(
        int((sizes == 4096).sum()), 4096))
    return streams, sizes


@pytest.mark.parametrize("kind,n", [("empty", 5), ("raw", 3), ("mixed", 40),
                                    ("empty", 0)])
def test_device_pack_equals_host_pack(kind, n):
    streams, sizes = _batch(n, n, kind)
    hdr = jheader.pack_header(jheader.CodecConfig(width=64, height=64))
    for h in (hdr, None):
        got = pack.pack_streams(torch.from_numpy(streams),
                                torch.from_numpy(sizes.astype(np.int32)), h)
        got = got.numpy().view(np.uint16)
        assert np.array_equal(got, native.pack_streams(streams, sizes, h))
        assert np.array_equal(got, jpack.pack_streams(streams, sizes, h))
        msb, z = pack.block_fields(got, n)
        assert np.array_equal(z, sizes)
        s_back, z_back = pack.unpack_streams(
            torch.from_numpy(got.view(np.int16)), n, int(z.sum()) - n)
        want_s, want_z = native.unpack_streams(got, n)
        assert np.array_equal(s_back.numpy(), want_s)
        assert np.array_equal(z_back.numpy(), want_z.astype(np.int32))
        assert np.array_equal(s_back.numpy(),
                              jpack.unpack_streams(got, n)[0])


def test_device_pack_two_components_round_trip():
    """Two component codestreams, the header on the first only (the RGB
    layout of TorchCodec.encode), each byte-equal to the host pack."""
    hdr = jheader.pack_header(jheader.CodecConfig(width=64, height=128,
                                                  is_rgb=True, components=3))
    for i, h in enumerate((hdr, None)):
        streams, sizes = _batch(10 + i, 12, "mixed")
        got = pack.pack_streams(torch.from_numpy(streams),
                                torch.from_numpy(sizes.astype(np.int32)), h)
        got = got.numpy().view(np.uint16)
        assert np.array_equal(got, native.pack_streams(streams, sizes, h))
        assert (got[:9] == 0xFFFF).all() == (h is None)


def test_block_fields_rejects_bad_codestreams():
    streams, sizes = _batch(3, 4, "mixed")
    good = native.pack_streams(streams, sizes, None)
    with pytest.raises(ValueError, match="too short"):
        pack.block_fields(good[:10], 4)
    with pytest.raises(ValueError, match="shorter than its sizes"):
        pack.block_fields(good[:-5], 4)
    bad = good.copy()
    bad[10] = 0
    with pytest.raises(ValueError, match="outside 1..4096"):
        pack.block_fields(bad, 4)
