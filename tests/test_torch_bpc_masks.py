"""A numpy model of the cp2 encoder's bitmasks (`MaskEncoder`,
picsong_tpu_torch/csrc/bpc_encode.cu), lane for lane: the bit-plane
transpose at block start, the four-column windows built by shuffles, the
SPP contexts from the plane's bit and before-plane masks, the sign steps on
warp-uniform row masks and the MRP steps skipped where no lane refines.
Its streams must equal the plain coder's, and its step counts
`bpc_steps.step_counts`; the card test holds the kernel itself to the
plain coder (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from bpc_steps import step_counts
from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
from picsong_tpu_torch.entropy import bpc

LANES = 32
M32 = 0xFFFFFFFF
MASK_PLANES = 23
PARAMS = LUTParams()
WL = 2
_LANE = np.arange(LANES)
_POPC = np.array([bin(i).count("1") for i in range(1 << 12)])
# Window<P>: the cell, its neighbours, those scanned before it, and its
# horizontal and vertical sign neighbours, in a 12-bit window
WINDOW = {0: (0x10, 0x767, 0x00F, 0x060, 0x101),
          1: (0x20, 0xB9B, 0x0FF, 0x090, 0x202)}
SIGN_TABLE = 0x73468D0


def transpose32(a):
    """The kernel's five rounds on a list of 32 uint64 lane vectors."""
    a = list(a)
    for rnd, m in enumerate((0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F,
                             0x33333333, 0x55555555)):
        j = 16 >> rnd
        for i in range(16):
            k = (i // j) * 2 * j + i % j
            t = ((a[k] >> j) ^ a[k + j]) & m
            a[k] = (a[k] ^ (t << j)) & M32
            a[k + j] = a[k + j] ^ t
    return a


def spread_rows(w, half):
    """spread_rows<H>: __byte_perm, then two shift-or-mask rounds."""
    lo, hi = (w >> (16 * half)) & 0xFF, (w >> (16 * half + 8)) & 0xFF
    x = lo | (hi << 16)
    x = (x | (x << 4)) & 0x0F0F0F0F
    return (x | (x << 2)) & 0x33333333


def four_columns(own):
    x, prev = [], np.zeros(LANES, np.uint64)
    for j in range(4):
        left, right = np.roll(own[j], 1), np.roll(own[j], -1)
        side = (np.where(_LANE == 0, 0, (left >> 1) & 0x55555555)
                | np.where(_LANE == LANES - 1, 0,
                           (right << 1) & 0xAAAAAAAA)).astype(np.uint64)
        m0 = spread_rows(own[j], 0) | (spread_rows(side, 0) << 2)
        m1 = spread_rows(own[j], 1) | (spread_rows(side, 1) << 2)
        x += [((m0 << 4) | (prev >> 28)) & M32, ((m1 << 4) | (m0 >> 28)) & M32]
        prev = m1
    return x + [prev >> 28]


def to_word(v):
    return ((np.abs(v) << 1) | (v < 0)).astype(np.uint64)


class Coder:
    """ac_encode and reserve for one warp."""

    def __init__(self, prec):
        self.low = np.zeros(LANES, np.int64)
        self.size = np.zeros(LANES, np.int64)
        self.resv = np.zeros(LANES, np.int64)
        self.counter, self.prec = 0, prec
        self.out = np.full(4096, -1, np.int64)

    def code(self, active, bit, prob):
        active, bit = np.asarray(active, bool), np.asarray(bit, np.int64)
        need = active & (self.size == 0)
        slot = np.minimum(np.cumsum(need) - need + self.counter, 4094) + 1
        self.counter = min(self.counter + int(need.sum()), 4095)
        self.resv = np.where(need, slot, self.resv)
        size = np.where(need, 0xFFFF, self.size)
        low = np.where(need, 0, self.low)
        aux = ((size * prob) >> self.prec) + bit
        nsize = np.where(bit == 1, size - aux, aux)
        self.low = np.where(active & (bit == 1), low + aux, low)
        self.size = np.where(active, nsize, size)
        for lane in np.nonzero(active & (nsize == 0))[0]:
            self.out[self.resv[lane]] = self.low[lane]


def sign_context(nb, neg, horizontal, vertical):
    pos, neg = nb & ~neg, nb & neg
    hp, hn = (pos & horizontal) != 0, (neg & horizontal) != 0
    vp, vn = (pos & vertical) != 0, (neg & vertical) != 0
    h = np.where(hp & ~hn, 3, np.where(hn & ~hp, 6, 0))
    v = np.where(vp & ~vn, 1, np.where(vn & ~vp, 2, 0))
    return (SIGN_TABLE >> (3 * (h + v))) & 7


def encode_block(block, probs, n_planes, prec):
    """One block as the kernel codes it: (stream, size, steps, skipped);
    `probs` (planes, 14) is its staged table."""
    src = block.astype(np.int64)
    sliced, neg, mag_or = [], [], np.zeros(LANES, np.uint64)
    for j in range(4):
        a = []
        for i in range(16):
            a += [to_word(src[16 * j + i, 0::2]),
                  to_word(src[16 * j + i, 1::2])]
            mag_or |= a[-1] | a[-2]
        a = transpose32(a)
        sliced.append(a[1:MASK_PLANES + 1])
        neg.append(a[0])
    neg4, sig4 = four_columns(neg), [np.zeros(LANES, np.uint64)] * 9
    sig = [np.zeros(LANES, np.uint64)] * 4
    mag = int(np.bitwise_or.reduce(mag_or >> 1))
    msb = mag.bit_length() - 1
    top = min(msb, n_planes - 1)
    ac, skipped = Coder(prec), 0
    for plane in range(top, -1, -1):
        pp = probs[plane]
        bit = [sliced[j][plane] if plane < MASK_PLANES
               else np.zeros(LANES, np.uint64) for j in range(4)]
        turned = [int(np.bitwise_or.reduce(b & ~s & M32))
                  for b, s in zip(bit, sig)]
        refine = [int(np.bitwise_or.reduce(s)) for s in sig]
        bit4 = four_columns(bit)
        for r in range(64):
            g, shift = r // 8, 4 * (r % 8)
            w = [(((x[g + 1] << 32) | x[g]) >> shift) & M32
                 for x in (sig4, bit4, neg4)]
            row = turned[r // 16] >> (2 * (r % 16))
            for phase in (0, 1):
                cell, neighbours, scanned, hor, ver = WINDOW[phase]
                nb = (w[0] | (w[1] & scanned)) & neighbours
                insig = (w[0] & cell) == 0
                b = ((w[1] & cell) != 0).astype(np.int64)
                ac.code(insig, b, pp[_POPC[nb.astype(np.int64)]])
                if row >> phase & 1:
                    sctx = sign_context(nb, w[2], hor, ver)
                    ssym = ((w[2] & cell) != 0).astype(np.int64) ^ (sctx & 1)
                    ac.code(insig & (b == 1), ssym, pp[9 + (sctx >> 1)])
        for j in range(4):
            steps = refine[j]
            while steps:
                i = (steps & -steps).bit_length() - 1
                ac.code((sig[j] >> i) & 1 == 1,
                        ((bit[j] >> i) & 1).astype(np.int64), pp[13])
                steps &= steps - 1
            skipped += 32 - bin(refine[j]).count("1")
        sig = [s | b for s, b in zip(sig, bit)]
        sig4 = [s | b for s, b in zip(sig4, bit4)]
    out = ac.out
    out[ac.resv] = ac.low        # lanes in order; a slot is a lane's own
    size = 1 if msb < 0 else ac.counter + 1
    if size == 4096:
        words = to_word(src) & 0xFFFF
        out = words.reshape(64, 32, 2).transpose(1, 0, 2).reshape(-1)
    else:
        out[0] = 32 if msb < 0 else msb
    coded = top >= 0 and size != 4096
    return (out.astype(np.int64).astype(np.int32), size,
            256 * (top + 1) if coded else 0, skipped if coded else 0)


def _probs(lut, ref_b, sig_b, sign_b, top):
    """stage_probs for cp2: each plane's 9 + 4 + 1 indices, clipped."""
    planes = np.arange(top + 1)[:, None]
    idx = np.concatenate([sig_b + planes * 9 + np.arange(9),
                          sign_b + planes * 4 + np.arange(4),
                          ref_b + planes], axis=1)
    return np.asarray(lut)[np.clip(idx, 0, len(lut) - 1)].astype(np.int64)


def _cases():
    rng = np.random.default_rng(31)
    rand = np.where(rng.random((3, 64, 64)) < 0.3,
                    rng.integers(-200, 201, size=(3, 64, 64)), 0)
    rand[1] = 0
    rand[2] = rng.integers(-1, 2, size=(64, 64))
    borders = np.zeros((3, 64, 64), np.int64)
    borders[0, 0, 0] = borders[2, 0, 0] = 5
    borders[1, 63, 63] = borders[2, 63, 63] = -6
    borders[2, 0, 63], borders[2, 63, 0], borders[2, 0, 1] = -7, 4, 3
    signs = np.zeros((2, 64, 64), np.int64)
    signs[0, :, 10] = -7
    signs[1] = (rng.integers(1, 4, size=(64, 64))
                * np.where(rng.random((64, 64)) < 0.5, -1, 1))
    cut = np.where(rng.random((1, 64, 64)) < 0.2,
                   rng.integers(-20, 21, size=(1, 64, 64)), 0)
    cut[0, 30, 40] = (1 << 17) + 3
    wide = np.where(rng.random((1, 64, 64)) < 0.03,
                    rng.integers(1, 1 << 23, size=(1, 64, 64)), 0)
    wide[0, 3, 3] = -((1 << 23) - 1)
    raw = rng.integers(-30000, 30001, size=(1, 64, 64))
    return {"random": (rand, 8), "borders": (borders, 8),
            "signs": (signs, 8), "cut": (cut, 16), "wide": (wide, 24),
            "raw": (raw, 16)}


CASES = _cases()


def test_transpose32_transposes():
    rng = np.random.default_rng(1)
    a = [rng.integers(0, 1 << 32, size=LANES, dtype=np.uint64)
         for _ in range(32)]
    t = transpose32(a)
    for i in range(32):
        for j in range(32):
            assert np.array_equal((t[j] >> i) & 1, (a[i] >> j) & 1)


def test_four_columns_reads_the_neighbour_columns():
    """Bit 4 (r + 1) + k of the windows is row r of column 2 lane, 2 lane
    + 1, 2 lane - 1, 2 lane + 2 (k = 0..3), zero off the block."""
    rng = np.random.default_rng(2)
    grid = rng.integers(0, 2, size=(64, 64)).astype(np.uint64)
    own = [sum(grid[16 * j + i, c::2] << (2 * i + c)
               for i in range(16) for c in (0, 1)) for j in range(4)]
    x = four_columns(own)
    bits = np.stack([(x[b // 32] >> (b % 32)) & 1 for b in range(288)])
    for lane in range(LANES):
        for r in range(64):
            for k, col in enumerate((2 * lane, 2 * lane + 1, 2 * lane - 1,
                                     2 * lane + 2)):
                want = grid[r, col] if 0 <= col < 64 else 0
                assert bits[4 * (r + 1) + k, lane] == want
        assert not bits[:4, lane].any() and not bits[260:, lane].any()


@pytest.mark.parametrize("case", list(CASES))
def test_mask_model_matches_plain(case):
    blocks, n_planes = CASES[case]
    n = blocks.shape[0]
    levels = (np.arange(n) % (WL + 1)).astype(np.int32)
    subbands = np.where(levels == WL, 0, np.arange(n) % 3).astype(np.int32)
    lut = neutral_lut(PARAMS, WL, 2, 1)
    lut = lut + (np.arange(lut.size, dtype=np.int32) * 7 % 41)
    meta = bpc._meta_args(levels, subbands, PARAMS, WL, 2, 0.0)
    args = [torch.from_numpy(np.asarray(a)) for a in (lut, *meta)]
    want_s, want_n = bpc.encode_blocks_plain(
        torch.from_numpy(blocks.astype(np.int32)), *args, params=PARAMS,
        wavelet_levels=WL, coding_passes=2, has_k=False, n_planes=n_planes)
    steps = skipped = 0
    for b in range(n):
        top = min(max(int(np.abs(blocks[b]).max()).bit_length() - 1, 0), 31)
        out, size, s, k = encode_block(
            blocks[b], _probs(lut, meta[0][b], meta[1][b], meta[2][b], top),
            n_planes, PARAMS.mult_precision)
        assert size == int(want_n[b])
        assert np.array_equal(out, want_s[b].numpy())
        steps, skipped = steps + s, skipped + k
    assert (steps, skipped) == step_counts(blocks, n_planes, want_n.numpy())
