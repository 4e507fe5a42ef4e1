"""The port's plain BPC-PaCo with three coding passes (cp=3) and with
complexity scalability (k > 0, the bulk pass), against the NumPy oracle and
the JAX package's XLA coder, both its monolithic program
(`bpc_jax.encode_blocks` / `decode_blocks`) and its staged one
(`bpc_jax.encode` / `decode`).

Every value is an integer, so every comparison is exact (tolerance 0).
Inputs come from numpy seeds; the sizes are those of tests/test_jax_bpc.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picsong_tpu.core import spec
from picsong_tpu.core.lut import LUTParams
from picsong_tpu.entropy import bpc_jax
from picsong_tpu.reference import bpc as obpc
from picsong_tpu_torch.entropy import bpc, bpc_cuda

PARAMS = LUTParams()
WL = 2


def _batch(seed, n, amplitude, sparsity, raw_block):
    """Random blocks with block 0 empty; with `raw_block`, block 1 dense
    at 12-bit magnitudes, which the random LUT cannot code in fewer than
    4096 words (the raw fallback keeps them whole)."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(-amplitude, amplitude + 1, size=(n, 64, 64),
                          dtype=np.int32)
    blocks = np.where(rng.random((n, 64, 64)) < sparsity, blocks, 0)
    blocks = blocks.astype(np.int32)
    blocks[0] = 0
    if raw_block:
        blocks[1] = rng.integers(-(1 << 12), 1 << 12, size=(64, 64),
                                 dtype=np.int32)
    levels = rng.integers(0, WL + 1, size=n).astype(np.int32)
    subbands = np.where(levels == WL, 0,
                        rng.integers(0, 3, size=n)).astype(np.int32)
    return blocks, levels, subbands


# cp, k, seed, blocks, amplitude, sparsity, raw block, LUT floor. The
# MSB-15 batch takes a LUT that favours zeros: at even odds each of 16
# planes costs a bit per cell, which overflows every block.
CASES = {
    "cp3": (3, 0.0, 13, 4, 40, 0.25, False, 1),
    "k1": (2, 1.0, 11, 3, 900, 0.6, False, 1),
    "k5": (2, 5.0, 21, 4, 700, 0.5, True, 1),
    "k8": (2, 8.0, 11, 3, 900, 0.6, False, 1),
    "k8_msb15": (2, 8.0, 17, 4, 65535, 0.03, False, 96),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_coder_matches_oracle_and_jax(name):
    """Encode: the plain coder == the oracle per block == bpc_jax's mono
    and staged encoders. Decode: the plain decoder inverts it and == the
    staged decoder."""
    cp, k, seed, n, amplitude, sparsity, raw, lut_floor = CASES[name]
    blocks, levels, subbands = _batch(seed, n, amplitude, sparsity, raw)
    lut = np.random.default_rng(seed).integers(
        lut_floor, 127, size=PARAMS.size_per_group(WL, cp)
        * (PARAMS.n_bitplane_files if k > 0 else 1)).astype(np.int32)
    args = bpc._meta_args(levels, subbands, PARAMS, WL, cp, k)
    kw = dict(params=PARAMS, wavelet_levels=WL, coding_passes=cp,
              has_k=k > 0)
    targs = [torch.from_numpy(np.asarray(a)) for a in (lut, *args)]
    n_planes = bpc.planes_for_magnitude(int(np.max(np.abs(blocks))))
    streams, sizes = bpc_cuda.encode_blocks(
        torch.from_numpy(blocks), *targs, **kw, n_planes=n_planes)

    for i, block in enumerate(blocks):
        want_s, want_n = obpc.encode_codeblock(
            block, int(levels[i]), int(subbands[i]), lut, PARAMS, WL,
            coding_passes=cp, k_factor=k)
        assert int(sizes[i]) == want_n
        assert np.array_equal(streams[i].numpy(), want_s)
    mono_s, mono_n = bpc_jax.encode_blocks(
        jnp.asarray(blocks), jnp.asarray(lut), *args, **kw,
        n_planes=n_planes)
    assert np.array_equal(sizes.numpy(), np.asarray(mono_n))
    assert np.array_equal(streams.numpy(), np.asarray(mono_s))
    staged_s, staged_n = bpc_jax.encode(blocks, levels, subbands, lut, PARAMS,
                                        WL, coding_passes=cp, k_factor=k)
    assert np.array_equal(sizes.numpy(), staged_n)
    assert np.array_equal(streams.numpy(), staged_s)

    assert sizes[0] == 1 and streams[0, 0] == 32         # the empty block
    if raw:
        assert sizes[1] == spec.CBLOCK_SIZE              # the raw fallback
    if name == "k8_msb15":
        # the split plane of an MSB-15 block reaches group 15, one past
        # the last group table: its reads are clipped into the LUT's tail
        msb = streams[:, 0].numpy()
        consec = np.floor(msb.astype(np.float32) * args[5])
        assert ((msb == 15) & (consec >= 15)).sum() >= 2

    n_planes = bpc.planes_for_streams(streams[:, 0].numpy(), sizes.numpy())
    out = bpc_cuda.decode_blocks(streams, sizes, *targs, **kw,
                                 n_planes=n_planes)
    assert np.array_equal(out.numpy(), blocks)
    staged = bpc_jax.decode(streams.numpy(), sizes.numpy(), levels, subbands,
                            lut, PARAMS, WL, coding_passes=cp, k_factor=k)
    assert np.array_equal(out.numpy(), staged)


def test_split_plane_float32_rule_matches_oracle():
    """Every k the header can carry (k = i / 1000, i < 2^16), every L2 step
    and every MSB: the float32 split plane the port computes
    (`bpc.split_plane`, on k / L2 rounded to float32 as `block_metadata`
    rounds it) gives the oracle's float64 rule wherever it reaches the
    coder, which is min(consec, msb + 1)."""
    k = np.arange(1 << 16) / 1000.0
    qsteps = spec.WAVELET_QSTEPS.reshape(-1)
    assert qsteps.size == 40
    k_over_l2 = (np.float32(k)[:, None] / qsteps[None, :]).astype(np.float32)
    assert k_over_l2.dtype == np.float32
    k_over_l2_t = torch.from_numpy(k_over_l2.reshape(-1))
    exact = k[:, None] / qsteps[None, :]             # float64, as the oracle
    for msb in range(32):
        msbs = torch.full(k_over_l2_t.shape, msb, dtype=torch.int64)
        port = bpc.split_plane(msbs, k_over_l2_t).numpy()
        want = np.maximum(np.floor(msb * exact.reshape(-1)), 0)
        assert np.array_equal(np.minimum(port, msb + 1),
                              np.minimum(want, msb + 1)), msb
