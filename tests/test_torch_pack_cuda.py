"""X3, the codestream pack and unpack (`assembly/pack.py`), on the CPU: the
plain version the kernels of `csrc/pack.cu` are held to, against the JAX
package's device pack (`StagedBPC._pack_dense_impl` /
`_unpack_dense_impl`, on JAX's CPU); a NumPy model of the kernels' own
work split (a tile of codeblocks a CTA, its offsets by a look-back over
the tiles' status words; a warp a codeblock, its payload staged in
windows of shorts and moved as 16-byte chunks, 2-byte stores at a
block's partial ends, unpack's loads rounded out to 16-byte boundaries of
the allocation) against the plain version; and the wrapper's checks,
bound and C binding.

Every value is an integer: every comparison is exact (tolerance 0).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picsong_tpu.entropy.bpc_jax import StagedBPC
from picsong_tpu_torch import kernels
from picsong_tpu_torch.assembly import pack
from picsong_tpu_torch.core.header import CodecConfig, pack_header

WORDS = 4096
# the kernels' shapes (csrc/pack.cu kTileBlocks, kStage, kLookBack, kPad,
# kPackLoads, kUnpackLoads)
TILE_BLOCKS = pack.TILE_BLOCKS
STAGE = 1024
LOOK_BACK = 4
PAD = 16
PACK_LOADS = 9
UNPACK_LOADS = 5

def _sizes(kind: str, n: int, rng) -> np.ndarray:
    """Codeblock sizes: all empty (1), all raw copies (4096), random
    1..4096 with both ends, or small (1..40) with a few raw copies."""
    if kind == "empty":
        return np.ones(n, dtype=np.int32)
    if kind == "raw":
        return np.full(n, WORDS, dtype=np.int32)
    if kind == "small":
        sizes = rng.integers(1, 41, size=n).astype(np.int32)
        sizes[::997] = WORDS
        return sizes
    sizes = rng.integers(1, WORDS + 1, size=n).astype(np.int32)
    sizes[:3] = (1, WORDS, 2)[:n]
    return sizes


def _streams(seed: int, kind: str, n: int):
    """(N, 4096) int32 streams as the coder leaves them: word 0 the MSB
    word (32 for an empty block), 16-bit words up to the size (raw copies
    reach 0xFFFF), -1 after; and their int32 sizes."""
    rng = np.random.default_rng(seed)
    sizes = _sizes(kind, n, rng)
    streams = np.full((n, WORDS), -1, dtype=np.int32)
    keep = np.arange(WORDS)[None, :] < sizes[:, None]
    streams[keep] = rng.integers(0, 1 << 16, size=int(sizes.sum()),
                                 dtype=np.int32)
    streams[:, 0] = np.where(sizes == 1, 32, rng.integers(0, 16, size=n))
    return streams, sizes


def _pack(streams, sizes, header=None, payload=None) -> np.ndarray:
    got = pack.pack_streams(torch.from_numpy(streams),
                            torch.from_numpy(sizes), header, payload)
    return got.numpy().view(np.uint16)


def _unpack(shorts, n, payload):
    s, z = pack.unpack_streams(torch.from_numpy(shorts.view(np.int16)), n,
                               payload)
    return s.numpy(), z.numpy()


# --------------------------------------------------------------------------
# (a) the plain version against the JAX package's device pack
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,n", [("empty", 6), ("raw", 3), ("mixed", 40),
                                    ("mixed", 1), ("small", 4080)])
def test_plain_pack_equals_jax_dense_pack(kind, n):
    """The payload section and the MSB words of the plain pack, and its
    unpacked rows, equal StagedBPC's dense pack and unpack (both read no
    attribute of the instance, so they run unbound). The JAX pack fills a
    bucket longer than the payload, as the JAX package's buckets are, so
    that an empty payload still gives its unpack a word to index."""
    streams, sizes = _streams(n, kind, n)
    payload = int(sizes.sum()) - n
    shorts = _pack(streams, sizes, pack_header(CodecConfig(64, 64)))
    body = pack.HEADER_SHORTS + 2 * n
    j_sizes, j_msb, j_dense = StagedBPC._pack_dense_impl(
        None, jnp.asarray(streams), jnp.asarray(sizes), payload + 1)
    assert np.array_equal(shorts[body:body + payload],
                          np.asarray(j_dense)[:payload])
    assert np.array_equal(shorts[pack.HEADER_SHORTS:body:2],
                          np.asarray(j_msb).astype(np.uint16))
    assert np.array_equal(shorts[pack.HEADER_SHORTS + 1:body:2],
                          np.asarray(j_sizes).astype(np.uint16))
    got_s, got_z = _unpack(shorts, n, payload)
    want = StagedBPC._unpack_dense_impl(None, j_dense, jnp.asarray(sizes),
                                        j_msb)
    assert np.array_equal(got_s, np.asarray(want))
    assert np.array_equal(got_s, streams)
    assert np.array_equal(got_z, sizes)


# --------------------------------------------------------------------------
# (b) a model of the kernels against the plain version
# --------------------------------------------------------------------------

def _hillis_steele(v: np.ndarray) -> np.ndarray:
    """Inclusive scan along the last axis (32 lanes) as the kernel's
    `__shfl_up_sync` steps compute it: at distance d, lane l >= d adds the
    value lane l - d held before the step."""
    v = v.copy()
    d = 1
    while d < v.shape[-1]:
        prev = v.copy()
        v[..., d:] += prev[..., :-d]
        d <<= 1
    return v


AGGREGATE, PREFIX = 1, 2        # the status words' flags


def model_scan(sizes: np.ndarray, seed: int = 0) -> np.ndarray:
    """The kernels' offsets: a tile of TILE_BLOCKS codeblocks a CTA; its
    warp 0 scans the counts (lanes past the tile hold 0) and publishes the
    aggregate (tile 0 its inclusive prefix) as its CTA starts, in
    blockIdx order; then the tiles look back in the order of a random
    permutation (`seed`), each reading its predecessors' words 32 *
    LOOK_BACK a round (lane l, read r: the tile l + 32 r before the
    round's nearest), until it meets a prefix, and publishing its own.
    Returns the N + 1 int64 offsets, the last the total the last tile
    writes."""
    n = sizes.size
    counts = np.clip(sizes.astype(np.int64) - 1, 0, WORDS - 1)
    tiles = max(1, -(-n // TILE_BLOCKS))
    lanes = np.zeros((tiles, 32), dtype=np.int64)
    lanes[:, :TILE_BLOCKS] = np.pad(
        counts, (0, tiles * TILE_BLOCKS - n)).reshape(tiles, TILE_BLOCKS)
    incl = _hillis_steele(lanes)
    aggregate = incl[:, 31]
    flag = np.full(tiles, AGGREGATE)
    flag[0] = PREFIX
    value = aggregate.copy()
    base = np.zeros(tiles, dtype=np.int64)
    # distance from the round's nearest tile of lane l's read r: l + 32 r
    dist = (np.arange(32)[None, :] + 32 * np.arange(LOOK_BACK)[:, None])
    for t in 1 + np.random.default_rng(seed).permutation(tiles - 1):
        nearest = t - 1
        while True:
            j = nearest - dist
            f = np.where(j >= 0, flag[np.maximum(j, 0)], PREFIX)
            v = np.where(j >= 0, value[np.maximum(j, 0)], 0)
            assert (f != 0).all()          # every predecessor published
            ballots = (f == PREFIX)        # one ballot a read
            hit = ballots.any(axis=1)
            stop = (32 * int(np.argmax(hit))
                    + int(np.argmax(ballots[np.argmax(hit)]))
                    if hit.any() else 32 * LOOK_BACK)
            base[t] += v[dist <= stop].sum()
            if hit.any():
                break
            nearest -= 32 * LOOK_BACK
        flag[t], value[t] = PREFIX, base[t] + aggregate[t]
    offsets = (base[:, None] + incl - lanes)[:, :TILE_BLOCKS].reshape(-1)
    return np.append(offsets[:n], base[-1] + aggregate[-1])


SENTINEL = 0x12345              # a value no short of the layout holds
MODEL_BATCH = 2048              # codeblocks the models stage at once


def model_pack(streams, sizes, header, capacity, seed=0) -> np.ndarray:
    """pack_kernel over its grid, into a buffer of SENTINEL shorts whose
    base is 16-byte aligned: the header (tile 0), the filler at the total
    (the last tile), each block's (MSB, size) pair, and its payload a
    window of STAGE shorts at a time, in turn: the row's 16-byte words 4q..4q+3, q = STAGE / 4 * g - 2 + slot
    (PACK_LOADS slots a lane), all four words of a loaded slot staged at
    their place in the output's 16-byte chunks, in a buffer PAD shorts
    wider on each side; then a 16-byte store for every chunk inside the
    block's range and 2-byte stores for the shorts of the partial first
    and last chunks. Asserts that every short up to the filler is written
    once and none after it, that every staged write lies inside the
    buffer, that every store reads the payload word of its place (not a
    word staged past the block's ends), and that a block takes at most 14
    2-byte payload stores."""
    n = sizes.size
    offsets = model_scan(sizes, seed)
    body = pack.HEADER_SHORTS + 2 * n
    out = np.full(body + capacity + 1, SENTINEL, dtype=np.int64)
    writes = np.zeros(out.size, dtype=np.int64)

    def store(at, values):
        out[at] = values
        np.add.at(writes, at, 1)

    store(np.arange(pack.HEADER_SHORTS),
          0xFFFF if header is None else header)
    store(body + min(offsets[n], capacity), 0xFFFF)
    i = np.arange(n)
    store(pack.HEADER_SHORTS + 2 * i, streams[:, 0] & 0xFFFF)
    store(pack.HEADER_SHORTS + 2 * i + 1, sizes & 0xFFFF)
    slot = np.arange(32 * PACK_LOADS)         # lane + 32 * s
    chunk = np.arange(STAGE // 8)
    for b0 in range(0, n, MODEL_BATCH):
        rows = streams[b0:b0 + MODEL_BATCH]
        count = np.clip(sizes[b0:b0 + MODEL_BATCH].astype(np.int64) - 1, 0,
                        WORDS - 1)
        off = offsets[b0:b0 + rows.shape[0]]
        room = capacity - off
        c = np.where(room <= 0, 0, np.minimum(count, room))
        first = body + off
        shift = first & 7
        chunk0 = first - shift
        end = first + c
        windows = (shift + c + STAGE - 1) // STAGE
        scalar = np.zeros(rows.shape[0], dtype=np.int64)
        for g in range(int(windows.max(initial=0))):
            live = g < windows                     # the blocks with a window g
            q = STAGE // 4 * g - 2 + slot
            loaded = ((slot < STAGE // 4 + 3) & (q >= 0))[None, :] & (
                4 * q[None, :] <= count[:, None]) & (count[:, None] > 0)
            # the staged word of each buffer place (-1: none yet)
            word = np.full((rows.shape[0], STAGE + 2 * PAD), -1,
                           dtype=np.int64)
            for e in range(4):
                w = 4 * q + e
                at = w[None, :] - 1 + shift[:, None] - STAGE * g
                r, k = np.nonzero(loaded & live[:, None])
                assert ((at[r, k] >= -PAD) & (at[r, k] < STAGE + PAD)).all()
                word[r, PAD + at[r, k]] = w[k]
            lo = chunk0[:, None] + STAGE * g + 8 * chunk[None, :]
            skip = (lo + 8 <= first[:, None]) | (lo >= end[:, None]) | (
                ~live[:, None])
            whole = ~skip & (lo >= first[:, None]) & (lo + 8 <= end[:, None])
            assert (lo[whole] % 8 == 0).all()      # 16-byte aligned stores
            for t in range(8):
                pos = lo + t
                part = (~skip & ~whole & (pos >= first[:, None])
                        & (pos < end[:, None]))
                r, k = np.nonzero(whole | part)
                w = word[r, PAD + 8 * k + t]
                # the store reads the payload word of its place
                assert (w == pos[r, k] - first[r] + 1).all()
                assert ((w >= 1) & (w <= c[r])).all()
                store(pos[r, k], rows[r, w] & 0xFFFF)
                scalar += part.sum(axis=1)
        assert (scalar <= 14).all()
    used = body + min(offsets[n], capacity) + 1
    assert (writes[:used] == 1).all() and not writes[used:].any()
    return out


def model_unpack(shorts, n, payload, shift=0, seed=0):
    """The unpack's scan (sizes read from the pairs, unsigned) and
    unpack_kernel, the codestream `shift` shorts past a 16-byte boundary
    of its allocation: each warp reads the 16-byte chunks of that
    allocation that hold its payload's shorts (no other: rounded out, not
    over), UNPACK_LOADS slots a lane from the window's first chunk, stages
    them as they are, and writes its row a window at a time as 16-byte
    stores, each of its four words from the buffer at the block's shift:
    the MSB word, the payload words, then -1. The windows past the block's
    count hold no payload word whatever the offset: the warp writes them
    (the MSB word and -1) before the scan; the model asserts that the
    windows written after it are those the count reaches."""
    u = np.asarray(shorts).astype(np.int64)
    chunks = np.full(-(-(shift + u.size) // 8) * 8, -9, dtype=np.int64)
    chunks[shift:shift + u.size] = u
    chunks = chunks.reshape(-1, 8)
    sizes = u[pack.HEADER_SHORTS + 1:pack.HEADER_SHORTS + 2 * n:2]
    offsets = model_scan(sizes, seed)
    body = pack.HEADER_SHORTS + 2 * n
    out = np.full((n, WORDS), SENTINEL, dtype=np.int64)
    slot = np.arange(32 * UNPACK_LOADS)
    for b0 in range(0, n, MODEL_BATCH):
        m = min(MODEL_BATCH, n - b0)
        i = np.arange(b0, b0 + m)
        msb = u[pack.HEADER_SHORTS + 2 * i]
        count = np.clip(sizes[i] - 1, 0, WORDS - 1)
        room = payload - offsets[i]
        c = np.where(room <= 0, 0, np.minimum(count, room))
        s0 = body + offsets[i] + shift     # payload word w: short s0 + w - 1
        for g in range(WORDS // STAGE):
            base = (s0 + STAGE * g - 1) >> 3
            w_lo = max(1, STAGE * g)
            w_hi = np.minimum(c, STAGE * (g + 1) - 1)
            k = base[:, None] + slot[None, :]
            load = ((w_lo <= w_hi)[:, None] & (k >= ((s0 + w_lo - 1) >> 3)[:, None])
                    & (k <= ((s0 + w_hi - 1) >> 3)[:, None]))
            assert not load[:, STAGE // 8 + 1:].any()
            # a loaded chunk holds a short of the block's payload
            assert ((8 * k + 7 >= s0[:, None])
                    & (8 * k <= (s0 + c - 1)[:, None]))[load].all()
            buf = np.full((m, STAGE + 8), -7, dtype=np.int64)
            r, j = np.nonzero(load)
            buf[r[:, None], 8 * j[:, None] + np.arange(8)] = chunks[k[r, j]]
            # word STAGE * g + x of the row is buf[at + x]
            at = s0 - 1 + STAGE * g - 8 * base
            assert ((at >= 0) & (at < 8)).all()
            x = np.arange(STAGE)
            w = STAGE * g + x
            used = (w[None, :] >= 1) & (w[None, :] <= c[:, None])
            at = np.where(used, at[:, None] + x[None, :], 0)
            staged = np.take_along_axis(buf, at, axis=1)
            assert (staged[used] >= 0).all()       # the payload's own shorts
            row = np.where(w[None, :] == 0, msb[:, None],
                           np.where(used, staged, -1))
            # windows written before the scan: none of words 1..count
            early = g >= np.where(count > 0, count // STAGE + 1, 0)
            assert not used[early].any()
            assert ((w[None, :] < 1) | (w[None, :] > count[:, None]))[
                early].all()
            out[i, STAGE * g:STAGE * (g + 1)] = row
    return out, sizes


@pytest.mark.parametrize("n", [0, 1, 7, 1025, 1500, 4080, 16384])
def test_kernel_model_scan_equals_cumsum(n):
    """The look-back scan (tiles not full, N = 0, tiles resolving in two
    random orders, so that a tile walks past windows of 32 aggregates)
    gives the plain version's offsets and total."""
    sizes = _sizes("mixed" if n < 2000 else "small", n,
                   np.random.default_rng(n))
    counts = sizes.astype(np.int64) - 1
    want = np.concatenate([[0], np.cumsum(counts)])
    for seed in (0, 1):
        assert np.array_equal(model_scan(sizes, seed), want)


@pytest.mark.parametrize("kind,n", [("empty", 0), ("mixed", 1),
                                    ("mixed", 13), ("raw", 9),
                                    ("small", 1025), ("small", 16384)])
def test_kernel_model_equals_plain(kind, n):
    """The model of the kernels writes every short of the plain pack, with
    and without a header and with the payload given, and every word of the
    plain unpack."""
    streams, sizes = _streams(100 + n, kind, n)
    payload = int(sizes.sum()) - n
    hdr = pack_header(CodecConfig(128, 64))
    for h in (hdr, None):
        want = _pack(streams, sizes, h)
        got = model_pack(streams, sizes, h, payload)
        assert np.array_equal(got, want.astype(np.int64))
    # the worst-case buffer of a pack without `payload=`: its exact prefix
    worst = model_pack(streams, sizes, None, (WORDS - 1) * n, seed=1)
    assert np.array_equal(worst[:want.size], want.astype(np.int64))
    assert np.array_equal(_pack(streams, sizes, None, payload), want)
    got_s, got_z = model_unpack(want, n, payload)
    want_s, want_z = _unpack(want, n, payload)
    assert np.array_equal(got_s, want_s) and np.array_equal(got_z, want_z)


def _aligned_batch(count: int, tail: bool, seed: int):
    """Codeblocks whose payload starts at every residue 0..7 of the
    16-byte chunks: block 2r + 1 carries `count` words and starts at
    residue r, block 2r before it is sized to put it there; with `tail`
    one more block, so that the last tile is not full."""
    rng = np.random.default_rng(seed)
    n = 16 + tail
    body = pack.HEADER_SHORTS + 2 * n
    counts, off = [], 0
    for r in range(8):
        lead = (r - body - off) % 8 + 8 * int(rng.integers(0, 3))
        counts += [lead, count]
        off += lead + count
    counts += [int(rng.integers(0, 20))] * tail
    sizes = np.asarray(counts, dtype=np.int32) + 1
    streams = np.full((n, WORDS), -1, dtype=np.int32)
    keep = np.arange(WORDS)[None, :] < sizes[:, None]
    streams[keep] = rng.integers(0, 1 << 16, size=int(sizes.sum()),
                                 dtype=np.int32)
    streams[:, 0] = rng.integers(0, 16, size=n)
    return streams, sizes


@pytest.mark.parametrize("tail", [False, True], ids=["full", "partial"])
@pytest.mark.parametrize("count", [0, 1, 7, 8, 9, 15, 16, 4095])
def test_kernel_model_alignments(count, tail):
    """Every destination residue mod 8 with `count` payload words (heads
    and tails of 0-7 shorts, bodies of 0, 1 and 511 chunks, a block over
    five windows), full and partial tiles: the model's pack is the plain
    pack, and its unpack, from a codestream at every 2-byte offset mod 16
    of its allocation, the plain unpack."""
    streams, sizes = _aligned_batch(count, tail, 7 * count + tail)
    n = sizes.size
    payload = int(sizes.sum()) - n
    body = pack.HEADER_SHORTS + 2 * n
    starts = body + np.concatenate([[0], np.cumsum(sizes - 1)])[:-1]
    assert set(starts[1:16:2] % 8) == set(range(8))
    want = _pack(streams, sizes, None)
    assert np.array_equal(model_pack(streams, sizes, None, payload),
                          want.astype(np.int64))
    want_s, want_z = _unpack(want, n, payload)
    for shift in range(8):
        got_s, got_z = model_unpack(want, n, payload, shift, seed=shift)
        assert np.array_equal(got_s, want_s) and np.array_equal(got_z, want_z)


def test_kernel_model_unpack_reads_unsigned_words():
    """Payload words and MSB words at or above 0x8000 come back as
    0..65535, not sign-extended, from the plain version and the model."""
    streams, sizes = _streams(5, "raw", 2)
    streams[0, 1:5] = (0x8000, 0xFFFF, 0x7FFF, 0)
    streams[1, 0] = 0xFFFF
    payload = int(sizes.sum()) - 2
    shorts = _pack(streams, sizes)
    got_s, _ = _unpack(shorts, 2, payload)
    assert np.array_equal(got_s, streams)
    assert np.array_equal(model_unpack(shorts, 2, payload)[0], streams)


# --------------------------------------------------------------------------
# (c) the wrapper's checks, bound and binding
# --------------------------------------------------------------------------

def test_wrappers_reject_what_the_kernels_do_not_take():
    streams, sizes = (torch.from_numpy(a) for a in _streams(1, "mixed", 4))
    with pytest.raises(TypeError, match="int32"):
        pack.pack_streams(streams.long(), sizes, None)
    with pytest.raises(TypeError, match="int32"):
        pack.pack_streams(streams, sizes.long(), None)
    with pytest.raises(ValueError, match="shape"):
        pack.pack_streams(streams[:, :4095], sizes, None)
    with pytest.raises(ValueError, match="shape"):
        pack.pack_streams(streams, sizes[:3], None)
    with pytest.raises(ValueError, match="contiguous"):
        pack.pack_streams(streams.T.contiguous().T, sizes, None)
    with pytest.raises(ValueError, match="payload"):
        pack.pack_streams(streams, sizes, None, payload=-1)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no X3 implementation"):
        pack.pack_streams(streams.to(meta), sizes.to(meta), None)
    with pytest.raises(ValueError, match="several devices"):
        pack.pack_streams(streams, sizes.to(meta), None)
    shorts = pack.pack_streams(streams, sizes, None)
    payload = int(sizes.sum()) - 4
    with pytest.raises(TypeError, match="int16"):
        pack.unpack_streams(shorts.int(), 4, payload)
    with pytest.raises(ValueError, match="1-D"):
        pack.unpack_streams(shorts[None, :], 4, payload)
    with pytest.raises(ValueError, match="contiguous"):
        pack.unpack_streams(torch.stack([shorts, shorts], 1)[:, 0], 4,
                            payload)
    with pytest.raises(ValueError, match="shorter"):
        pack.unpack_streams(shorts[:-2], 4, payload)
    with pytest.raises(ValueError, match="payload"):
        pack.unpack_streams(shorts, 4, -1)
    with pytest.raises(ValueError, match="n_blocks"):
        pack.unpack_streams(shorts, -1, payload)
    with pytest.raises(ValueError, match="no X3 implementation"):
        pack.unpack_streams(shorts.to(meta), 4, payload)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the entry points are the plain version, and no kernel
    launch is counted."""
    streams, sizes = (torch.from_numpy(a) for a in _streams(2, "mixed", 9))
    pack.reset_launches()
    got = pack.pack_streams(streams, sizes, None)
    assert torch.equal(got, pack.pack_streams_plain(streams, sizes, None))
    payload = int(sizes.sum()) - 9
    s, z = pack.unpack_streams(got, 9, payload)
    s_p, z_p = pack.unpack_streams_plain(got, 9, payload)
    assert torch.equal(s, s_p) and torch.equal(z, z_p)
    assert (pack.PACK_LAUNCHES, pack.UNPACK_LAUNCHES) == (0, 0)


def test_bound_counts_the_bytes():
    """Pack: the sizes, MSB and payload words read as int32, the codestream
    written; unpack: the codestream read, the int32 rows and sizes
    written; over 3.35 TB/s. At the main path's 1024 blocks and a 3.17 MB
    codestream: about 2.8 and 6.0 us."""
    n, payload = 1024, 1_583_000
    shorts = pack.stream_length(n, payload)
    b = pack.bound_ms(n, payload)
    assert b["pack"][0] == pytest.approx(
        (4 * (2 * n + payload) + 2 * shorts) / 3.35e12 * 1e3, rel=1e-12)
    assert b["unpack"][0] == pytest.approx(
        (2 * shorts + 4 * n * 4097) / 3.35e12 * 1e3, rel=1e-12)
    assert b["pack"][1] == b["unpack"][1] == "bytes"
    assert 0.0027 < b["pack"][0] < 0.0029
    assert 0.0059 < b["unpack"][0] < 0.0061


def test_entry_points_are_bound():
    """Both C entry points of csrc/pack.cu are declared for ctypes, with as
    many arguments as the source takes."""
    with open(os.path.join(kernels.CSRC_DIR, "pack.cu")) as f:
        src = f.read()
    for name in ("picsong_pack", "picsong_unpack"):
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        assert m.group(1).count(",") + 1 == len(kernels._SIGNATURES[name])


@pytest.mark.parametrize("name,value", [("kTileBlocks", TILE_BLOCKS),
                                        ("kStage", STAGE),
                                        ("kLookBack", LOOK_BACK),
                                        ("kPad", PAD),
                                        ("kStatusStride",
                                         pack.STATUS_STRIDE)])
def test_model_shapes_are_the_kernels(name, value):
    """The model's tile and window are csrc/pack.cu's, and its load slots
    follow from them as the source computes them."""
    with open(os.path.join(kernels.CSRC_DIR, "pack.cu")) as f:
        src = f.read()
    m = re.search(r"constexpr int " + name + r" = (\d+);", src)
    assert m and int(m.group(1)) == value
    assert PACK_LOADS == -(-(STAGE // 4 + 3) // 32)
    assert UNPACK_LOADS == -(-(STAGE // 8 + 1) // 32)
    assert pack.status_words(0) == pack.STATUS_STRIDE + 1
    assert pack.status_words(16384) == (16384 // TILE_BLOCKS
                                        * pack.STATUS_STRIDE + 1)
