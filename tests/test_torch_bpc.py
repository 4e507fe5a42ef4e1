"""The port's plain BPC-PaCo against the JAX package and the NumPy oracle.

Every value is an integer, so every comparison is exact (tolerance 0).
The JAX side runs the Pallas kernels in interpret mode, as
tests/test_pallas_bpc.py does, and the XLA coder `bpc_jax.encode`.
"""

import numpy as np
import pytest
import torch

from picsong_tpu.entropy import bpc_jax, bpc_pallas
from picsong_tpu.reference import bpc as obpc
from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
from picsong_tpu_torch.entropy import bpc, bpc_cuda

from torch_twins import J

PARAMS = LUTParams()
WL = 2


def _case(seed, maxmag, n=24):
    """The batches of tests/test_pallas_bpc.py: 70% zeros, one empty block
    and, at the largest magnitude, one dense block at the raw fallback."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(-maxmag, maxmag + 1, size=(n, 64, 64),
                          dtype=np.int32)
    blocks[rng.random(blocks.shape) < 0.7] = 0
    blocks[3] = 0
    if maxmag >= 30000:
        blocks[5] = rng.integers(-maxmag, maxmag + 1, size=(64, 64),
                                 dtype=np.int32)
    levels = (np.arange(n) % WL).astype(np.int32)
    subbands = (np.arange(n) % 3).astype(np.int32)
    lut = neutral_lut(PARAMS, WL, 2)
    lut = lut + (np.arange(lut.size, dtype=np.int32) % 41)
    return blocks, levels, subbands, lut


KW = dict(params=PARAMS, wavelet_levels=WL, coding_passes=2, has_k=False)


def _torch_args(lut, meta):
    """The LUT and the six per-block arrays of a cp=2 k=0 batch."""
    zeros = torch.zeros(len(meta["ref"]), dtype=torch.int32)
    return (torch.from_numpy(lut), torch.from_numpy(meta["ref"]),
            torch.from_numpy(meta["sig"]), torch.from_numpy(meta["sign"]),
            zeros, zeros, torch.from_numpy(meta["k_over_l2"]))


@pytest.mark.parametrize("seed,maxmag", [(0, 200), (1, 7), (2, 30000)])
def test_plain_encode_matches_pallas_and_xla(seed, maxmag):
    blocks, levels, subbands, lut = _case(seed, maxmag)
    meta = bpc.block_metadata(levels, subbands, PARAMS, WL, 2, 0.0)
    n_planes = bpc.planes_for_magnitude(int(np.max(np.abs(blocks))))
    streams, sizes = bpc.encode_blocks_plain(
        torch.from_numpy(blocks), *_torch_args(lut, meta), **KW,
        n_planes=n_planes)
    assert streams.dtype == torch.int32 and sizes.dtype == torch.int32

    want_s, want_n = bpc_pallas.encode_blocks(
        blocks, lut, meta["ref"], meta["sig"], meta["sign"],
        params=J(PARAMS), n_planes=n_planes, interpret=True)
    assert np.array_equal(sizes.numpy(), np.asarray(want_n))
    assert np.array_equal(streams.numpy(), np.asarray(want_s))

    xla_s, xla_n = bpc_jax.encode(blocks, levels, subbands, lut, J(PARAMS), WL)
    assert np.array_equal(sizes.numpy(), xla_n)
    assert np.array_equal(streams.numpy(), xla_s)
    if maxmag >= 30000:
        assert sizes[5] == 4096          # the raw fallback was exercised


@pytest.mark.parametrize("seed,maxmag", [(0, 200), (1, 7), (2, 30000)])
def test_plain_decode_matches_pallas_and_inverts(seed, maxmag):
    blocks, levels, subbands, lut = _case(seed, maxmag)
    streams, sizes = bpc_jax.encode(blocks, levels, subbands, lut, J(PARAMS), WL)
    meta = bpc.block_metadata(levels, subbands, PARAMS, WL, 2, 0.0)
    n_planes = bpc.planes_for_streams(streams[:, 0], sizes)
    out = bpc.decode_blocks_plain(
        torch.from_numpy(np.array(streams)),
        torch.from_numpy(sizes.astype(np.int32)),
        *_torch_args(lut, meta), **KW, n_planes=n_planes)
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), blocks)
    if maxmag < 30000:   # the interpret-mode decoder is the slow half
        want = bpc_pallas.decode_blocks(
            streams, sizes, lut, meta["ref"], meta["sig"], meta["sign"],
            params=J(PARAMS), n_planes=n_planes, interpret=True)
        assert np.array_equal(out.numpy(), np.asarray(want))


def test_plain_encode_matches_oracle_per_block():
    """Trained-style random LUT, a subband mix including the residual LL."""
    rng = np.random.default_rng(7)
    n = 5
    blocks = rng.integers(-300, 301, size=(n, 64, 64), dtype=np.int32)
    blocks[rng.random(blocks.shape) < 0.5] = 0
    blocks[0] = 0
    levels = np.array([0, 1, 2, 0, 1], dtype=np.int32)
    subbands = np.array([0, 1, 0, 2, 2], dtype=np.int32)
    lut = rng.integers(1, 127, size=PARAMS.size_per_group(WL, 2)).astype(
        np.int32)
    meta = bpc.block_metadata(levels, subbands, PARAMS, WL, 2, 0.0)
    streams, sizes = bpc_cuda.encode_blocks(
        torch.from_numpy(blocks), *_torch_args(lut, meta), **KW,
        n_planes=bpc.planes_for_magnitude(int(np.max(np.abs(blocks)))))
    for i in range(n):
        want_s, want_n = obpc.encode_codeblock(
            blocks[i], int(levels[i]), int(subbands[i]), lut, J(PARAMS), WL)
        assert int(sizes[i]) == want_n
        assert np.array_equal(streams[i].numpy(), want_s)


@pytest.mark.parametrize("wl,cp,k", [(2, 2, 0.0), (3, 3, 0.0), (5, 2, 4.0)])
def test_block_metadata_matches_jax(wl, cp, k):
    rng = np.random.default_rng(wl)
    levels = rng.integers(0, wl + 1, size=40).astype(np.int32)
    subbands = np.where(levels == wl, 0,
                        rng.integers(0, 3, size=40)).astype(np.int32)
    got = bpc.block_metadata(levels, subbands, PARAMS, wl, cp, k)
    want = bpc_jax.block_metadata(levels, subbands, J(PARAMS), wl, cp, k)
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key]))
    for g, w in zip(bpc._meta_args(levels, subbands, PARAMS, wl, cp, k),
                    bpc_jax._meta_args(levels, subbands, J(PARAMS), wl, cp, k)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("mag", [0, 1, 7, 8, 15, 16, 255, 256, 32767, 65536])
def test_planes_helpers_match_jax(mag):
    assert bpc.planes_for_magnitude(mag) == bpc_jax.planes_for_magnitude(mag)
    msb = np.array([32, 3, mag.bit_length() - 1 if mag else 32, 5])
    sizes = np.array([1, 40, 100, 4096])
    assert (bpc.planes_for_streams(msb, sizes)
            == bpc_jax.planes_for_streams(msb, sizes))
    for n_planes in (4, 8, 16, 20):
        outcomes = []
        for mod in (bpc, bpc_jax):
            try:
                mod.check_planes_bound(msb, sizes, n_planes)
                outcomes.append(None)
            except mod.PlaneOverflowError as e:
                outcomes.append((e.msb, e.needed, str(e)))
        assert outcomes[0] == outcomes[1]


def test_prob_tables_match_pallas():
    rng = np.random.default_rng(3)
    lut = rng.integers(1, 127, size=500).astype(np.int32)
    # bases near both ends of the table exercise the index clip
    ref_b = np.array([0, 10, 480, 499, -3], dtype=np.int32)
    sig_b = np.array([5, 400, 470, 0, 20], dtype=np.int32)
    sign_b = np.array([495, 3, 250, 100, 7], dtype=np.int32)
    got = bpc._prob_tables(torch.from_numpy(lut), torch.from_numpy(ref_b),
                           torch.from_numpy(sig_b), torch.from_numpy(sign_b),
                           6)
    want = bpc_pallas._prob_tables(lut, ref_b, sig_b, sign_b, 6)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_layouts_match_jax():
    rng = np.random.default_rng(4)
    words = rng.integers(0, 1 << 24, size=(3, 64, 64)).astype(np.int64)
    te, to = bpc._to_grids(torch.from_numpy(words))
    jte, jto = bpc_jax._to_grids(words.astype(np.uint32))
    assert np.array_equal(te.numpy(), np.asarray(jte))
    assert np.array_equal(to.numpy(), np.asarray(jto))
    assert np.array_equal(bpc._from_grids(te, to).numpy(), words)
    raw = bpc._raw_layout(torch.from_numpy(words))
    assert np.array_equal(raw.numpy(),
                          np.asarray(bpc_jax._raw_layout(words.astype(np.uint32))))
    assert np.array_equal(bpc._raw_unlayout(raw).numpy(), words & 0xFFFF)
