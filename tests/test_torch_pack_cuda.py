"""X3, the codestream pack and unpack (`assembly/pack.py`), on the CPU: the
plain version the kernels of `csrc/pack.cu` are held to, against the JAX
package's device pack (`StagedBPC._pack_dense_impl` /
`_unpack_dense_impl`, on JAX's CPU); a NumPy model of the kernels' own
scan (a chunk of blocks a thread, warp shuffles, one warp over the warp
totals) and relocation (a warp a codeblock, its lanes' words) against the
plain version; and the wrapper's checks, bound and C binding.

Every value is an integer: every comparison is exact (tolerance 0).
"""

import functools
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
# the kernels' shapes (csrc/pack.cu kScanThreads, kCopyWarps, kUnroll)
SCAN_THREADS = 1024
COPY_WARPS = 8
UNROLL = 4


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


def model_scan(sizes: np.ndarray) -> np.ndarray:
    """scan_kernel: thread t sums the counts of its chunk of blocks, each
    warp scans its 32 thread sums, warp 0 scans the 32 warp totals, and
    each thread writes the exclusive offsets of its chunk; the last thread
    writes the total. Returns the N + 1 int64 offsets."""
    n = sizes.size
    counts = np.clip(sizes.astype(np.int64) - 1, 0, WORDS - 1)
    chunk = -(-n // SCAN_THREADS)
    begin = np.minimum(np.arange(SCAN_THREADS) * chunk, n)
    end = np.minimum(begin + chunk, n)
    sums = np.array([counts[b:e].sum() for b, e in zip(begin, end)],
                    dtype=np.int64)
    incl = _hillis_steele(sums.reshape(32, 32))      # warps x lanes
    warps = _hillis_steele(incl[:, 31])
    run = (incl - sums.reshape(32, 32)
           + np.concatenate([[0], warps[:-1]])[:, None]).reshape(-1)
    offsets = np.full(n + 1, -7, dtype=np.int64)
    for t in range(SCAN_THREADS):
        for i in range(begin[t], end[t]):
            offsets[i] = run[t]
            run[t] += counts[i]
    offsets[n] = run[-1]
    return offsets


@functools.lru_cache(maxsize=None)
def _lane_words(c: int) -> np.ndarray:
    """The payload words of a block of `c`, in the order pack_kernel's
    lanes take them: lane l from j = l in steps of 32 * UNROLL, UNROLL
    words 32 apart each step."""
    ks = [j + 32 * u for lane in range(32)
          for j in range(lane, c, 32 * UNROLL) for u in range(UNROLL)]
    return np.array([k for k in ks if k < c], dtype=np.int64)


def model_pack(streams, sizes, header, capacity) -> np.ndarray:
    """pack_kernel over its grid (max(1, ceil(N / COPY_WARPS)) CTAs of
    COPY_WARPS warps), into a buffer of a sentinel that no short of the
    layout holds, so that a short no warp writes shows."""
    n = sizes.size
    offsets = model_scan(sizes)
    body = pack.HEADER_SHORTS + 2 * n
    out = np.full(body + capacity + 1, 0x12345, dtype=np.int64)
    for cta in range(max(1, -(-n // COPY_WARPS))):
        if cta == 0:
            out[:pack.HEADER_SHORTS] = (0xFFFF if header is None
                                        else header)
            out[body + min(offsets[n], capacity)] = 0xFFFF
        for w in range(COPY_WARPS):
            i = cta * COPY_WARPS + w
            if i >= n:
                break
            out[pack.HEADER_SHORTS + 2 * i] = streams[i, 0] & 0xFFFF
            out[pack.HEADER_SHORTS + 2 * i + 1] = sizes[i] & 0xFFFF
            off = offsets[i]
            c = int(max(0, min(offsets[i + 1] - off, capacity - off)))
            k = _lane_words(c)
            assert np.array_equal(np.sort(k), np.arange(c))
            out[body + off + k] = streams[i, 1 + k] & 0xFFFF
    return out


def model_unpack(shorts, n, payload):
    """The unpack's scan (sizes read from the pairs, unsigned) and
    unpack_kernel: warp i writes its row as 1024 int4 stores, lane l the
    stores l, l + 32, ..."""
    u = shorts.astype(np.int64)
    sizes = u[pack.HEADER_SHORTS + 1:pack.HEADER_SHORTS + 2 * n:2]
    offsets = model_scan(sizes)
    body = pack.HEADER_SHORTS + 2 * n
    out = np.full((n, WORDS), 0x12345, dtype=np.int32)
    stores = np.array([q for lane in range(32)
                       for q in range(lane, WORDS // 4, 32)])
    assert np.array_equal(np.sort(stores), np.arange(WORDS // 4))
    w = (4 * stores[:, None] + np.arange(4)[None, :]).reshape(-1)
    for i in range(n):
        off = offsets[i]
        c = int(max(0, min(offsets[i + 1] - off, payload - off)))
        src = u[body + off + np.clip(w - 1, 0, max(c - 1, 0))] if c else 0
        out[i, w] = np.where(w == 0, u[pack.HEADER_SHORTS + 2 * i],
                             np.where(w <= c, src, -1))
    return out, sizes


@pytest.mark.parametrize("n", [0, 1, 7, 1025, 1500, 4080, 16384])
def test_kernel_model_scan_equals_cumsum(n):
    """The scan's chunks (N not a multiple of the 1024 threads, empty
    chunks past the end, N = 0) give the plain version's offsets."""
    sizes = _sizes("mixed" if n < 2000 else "small", n,
                   np.random.default_rng(n))
    counts = sizes.astype(np.int64) - 1
    want = np.concatenate([[0], np.cumsum(counts)])
    assert np.array_equal(model_scan(sizes), want)


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
    worst = model_pack(streams, sizes, None, (WORDS - 1) * n)
    assert np.array_equal(worst[:want.size], want.astype(np.int64))
    assert np.array_equal(_pack(streams, sizes, None, payload), want)
    got_s, got_z = model_unpack(want, n, payload)
    want_s, want_z = _unpack(want, n, payload)
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
