"""The port's CUDA kernels on the card: byte-equal to their plain versions.

These tests need an NVIDIA GPU (sm_90a) and nvcc; elsewhere they skip.
On the card, where JAX is absent, run them without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Every value is an integer, so every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from picsong_tpu.assembly import pack as host_pack
from picsong_tpu.reference import codec as oracle
from picsong_tpu_torch.assembly import pack
from picsong_tpu_torch.core.header import CodecConfig, pack_header
from picsong_tpu_torch.core.image_io import mirror_pad
from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
from picsong_tpu_torch.dist.sharded import ShardedCodec
from picsong_tpu_torch.engine import video
from picsong_tpu_torch.engine.batch import BatchCodec
from picsong_tpu_torch.engine.pipeline import TorchCodec
from picsong_tpu_torch import kernels
from picsong_tpu_torch.entropy import bpc, bpc_cuda
from picsong_tpu_torch.tools import goldens, probe, probe2
from picsong_tpu_torch.transform import dwt_cuda
from bpc_steps import step_counts
from torch_twins import J

pytestmark = pytest.mark.cuda

PARAMS = LUTParams()
WL = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py`")
    return torch.device("cuda")


def _batch(seed, maxmag, n=64, cp=2, k=0.0):
    """Random blocks with an empty block (3), a raw-fallback block (5) and
    a block with MSB 0 (6); with k > 0 also a sparse block with MSB 15 (7),
    whose split plane reaches past the 15 group tables. Returns the blocks,
    the LUT and six per-block arrays, the mode keywords and n_planes."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(-maxmag, maxmag + 1, size=(n, 64, 64),
                          dtype=np.int32)
    blocks[rng.random(blocks.shape) < 0.7] = 0
    blocks[3] = 0
    blocks[5] = rng.integers(-30000, 30001, size=(64, 64), dtype=np.int32)
    blocks[6] = rng.integers(-1, 2, size=(64, 64), dtype=np.int32)
    if k > 0:
        blocks[7] = np.where(rng.random((64, 64)) < 0.02, 32768, 0)
        blocks[7, 0, 0] = -65535
    levels = (np.arange(n) % (WL + 1)).astype(np.int32)
    subbands = np.where(levels == WL, 0, np.arange(n) % 3).astype(np.int32)
    groups = PARAMS.n_bitplane_files if k > 0 else 1
    lut = neutral_lut(PARAMS, WL, cp, groups)
    lut = lut + (np.arange(lut.size, dtype=np.int32) * 7 % 41)
    meta = bpc._meta_args(levels, subbands, PARAMS, WL, cp, k)
    args = [torch.from_numpy(np.asarray(a)) for a in (lut, *meta)]
    kw = dict(params=PARAMS, wavelet_levels=WL, coding_passes=cp,
              has_k=k > 0)
    n_planes = bpc.planes_for_magnitude(int(np.abs(blocks).max()))
    return torch.from_numpy(blocks), args, kw, n_planes


def _check_kernels(cuda, blocks, args, kw, n_planes, exact=True):
    """Both kernels of the mode of `kw` against the plain versions, with
    one launch each, and with `exact` the decoded blocks against `blocks`
    but for the raw ones (not so where n_planes cuts a block's top planes);
    returns the sizes."""
    mode = bpc_cuda.mode_of(kw["coding_passes"], kw["has_k"])
    want_s, want_n = bpc.encode_blocks_plain(blocks, *args, **kw,
                                             n_planes=n_planes)
    dargs = [a.to(cuda) for a in args]
    before = (bpc_cuda.ENCODE_LAUNCHES[mode], bpc_cuda.DECODE_LAUNCHES[mode])
    got_s, got_n = bpc_cuda.encode_blocks(blocks.to(cuda), *dargs, **kw,
                                          n_planes=n_planes)
    out = bpc_cuda.decode_blocks(got_s, got_n, *dargs, **kw,
                                 n_planes=n_planes)
    torch.cuda.synchronize()
    assert (bpc_cuda.ENCODE_LAUNCHES[mode], bpc_cuda.DECODE_LAUNCHES[mode]) \
        == (before[0] + 1, before[1] + 1)
    assert torch.equal(got_n.cpu(), want_n)
    assert torch.equal(got_s.cpu(), want_s)
    assert torch.equal(out.cpu(), bpc.decode_blocks_plain(
        want_s, want_n, *args, **kw, n_planes=n_planes))
    raw = got_n.cpu() == 4096
    assert not exact or torch.equal(out.cpu()[~raw], blocks[~raw])
    return got_n.cpu()


@pytest.mark.parametrize("seed,maxmag", [(0, 200), (1, 7), (2, 30000)])
def test_kernels_match_plain(cuda, seed, maxmag):
    sizes = _check_kernels(cuda, *_batch(seed, maxmag))
    assert int(sizes[5]) == 4096 and int(sizes[3]) == 1


@pytest.mark.parametrize("cp,k,maxmag", [(3, 0.0, 200), (3, 0.0, 30000),
                                         (2, 1.0, 200), (2, 5.0, 900),
                                         (2, 8.0, 30000)])
def test_cp3_and_bulk_kernels_match_plain(cuda, cp, k, maxmag):
    blocks, args, kw, n_planes = _batch(4, maxmag, cp=cp, k=k)
    sizes = _check_kernels(cuda, blocks, args, kw, n_planes)
    assert int(sizes[5]) == 4096 and int(sizes[3]) == 1


def _edge_blocks():
    """Edge codeblocks: empty; MSB 0; MSB 15 with 16-bit magnitudes; a raw
    fallback; and the first 3739 and 3740 cells of one seeded block with
    magnitudes below 2^15, whose cp=2 streams end with the slot counter at
    exactly 4094 (size 4095) and 4095 (size 4096, the raw copy)."""
    rng = np.random.default_rng(21)
    order = rng.permutation(4096)
    vals = rng.integers(-32767, 32768, size=4096)
    vals[vals == 0] = 1
    vals[order[0]] = 32767
    blocks = np.zeros((8, 4096), dtype=np.int32)
    blocks[1, ::7] = rng.integers(-1, 2, size=blocks[1, ::7].shape)
    blocks[2, ::97] = 32768
    blocks[2, 5] = -65535
    blocks[3] = rng.integers(-65535, 65536, size=4096)
    for i, m in ((4, 3739), (5, 3740)):
        blocks[i, order[:m]] = vals[order[:m]]
    blocks[6] = 1
    blocks[7, 4095] = -32767
    return torch.from_numpy(blocks.reshape(8, 64, 64))


def _skip_blocks():
    """Blocks for the cp2 decoder's bitmask paths, none raw with
    `_skewed_lut`: every cell significant from plane 3 down (rows whose
    SPP codes nothing at planes 2-0); one cell at 2^12 above sparse small
    ones (MRP steps skipped but for its row in the top planes);
    significance only in lanes 0 and 31 (columns 0, 1, 62, 63: the lanes
    without a neighbour on one side), only in rows 0 and 63, and only on
    that frame; and a 16-bit block with MSB 15. Signs are random."""
    rng = np.random.default_rng(23)

    def signed(mag):
        return mag * np.where(rng.random(mag.shape) < 0.5, -1, 1)

    def some(p, hi):
        return np.where(rng.random((64, 64)) < p,
                        signed(rng.integers(1, hi, size=(64, 64))), 0)

    blocks = np.zeros((6, 64, 64), dtype=np.int32)
    blocks[0] = signed(rng.integers(8, 256, size=(64, 64)))
    blocks[1] = some(0.05, 4)
    blocks[1, 40, 35] = -4096
    lanes = np.zeros((64, 64), dtype=bool)
    lanes[:, [0, 1, 62, 63]] = True
    rows = np.zeros((64, 64), dtype=bool)
    rows[[0, 63], :] = True
    for i, where in ((2, lanes), (3, rows), (4, lanes | rows)):
        blocks[i] = np.where(where, some(0.7, 1000), 0)
    blocks[5] = some(0.1, 65536)
    blocks[5, 7, 7] = 65535
    return torch.from_numpy(blocks)


def _skewed_lut(cp, groups):
    """The neutral LUT with every significance probability at 120 / 128 for
    a 0: an insignificant cell costs a tenth of a bit, so a block of 16
    planes fits its stream (at 64 / 128 it is raw)."""
    lut = neutral_lut(PARAMS, WL, cp, groups)
    off = PARAMS.section_offsets(WL, cp)
    n_sig = PARAMS.section_size(PARAMS.ctx_significance, WL)
    group = PARAMS.size_per_group(WL, cp)
    for g in range(groups):
        for name in ("sig", "cp_sig"):
            if name in off:
                at = g * group + off[name]
                lut[at:at + n_sig] = 120
    return lut


def _mask_blocks(case):
    """Blocks for the cp2 encoder's bitmask edges, and their n_planes:
    `borders`, one significant cell alone at each corner (lanes 0 and 31,
    rows 0 and 63) and in columns 1 and 62 beside them, then all six in one
    block; `signs`, a column of negative cells, random signs at magnitudes
    1-3 (every sign context occurs) and stripes of alternating sign;
    `cut`, a block with MSB 17 among small cells, coded with 16 planes (its
    top planes cut); `raw`, a block whose stream reaches 4096 words;
    `wide`, magnitudes up to 2^23 - 1 (MSB 22, the words' last magnitude
    bit) with 24 planes."""
    rng = np.random.default_rng(29)
    if case == "borders":
        cells = ((0, 0, 5), (0, 63, -6), (63, 0, -7), (63, 63, 4),
                 (0, 1, 3), (63, 62, -2))
        blocks = np.zeros((len(cells) + 1, 64, 64), dtype=np.int32)
        for i, (r, c, v) in enumerate(cells):
            blocks[i, r, c] = blocks[-1, r, c] = v
        return torch.from_numpy(blocks), 16
    if case == "signs":
        blocks = np.zeros((3, 64, 64), dtype=np.int32)
        blocks[0, :, 10] = -7
        blocks[0, 5, 11] = 2
        blocks[1] = (rng.integers(1, 4, size=(64, 64))
                     * np.where(rng.random((64, 64)) < 0.5, -1, 1))
        blocks[2, :, ::2] = -9
        blocks[2, :, 1::2] = 9
        blocks[2, ::3] *= -1
        return torch.from_numpy(blocks), 16
    if case == "cut":
        blocks = np.where(rng.random((1, 64, 64)) < 0.2,
                          rng.integers(-20, 21, size=(1, 64, 64)), 0)
        blocks[0, 30, 40] = (1 << 17) + 3
        return torch.from_numpy(blocks.astype(np.int32)), 16
    if case == "raw":
        return torch.from_numpy(rng.integers(
            -30000, 30001, size=(1, 64, 64), dtype=np.int32)), 16
    blocks = np.where(rng.random((2, 64, 64)) < 0.05,
                      rng.integers(1, 1 << 23, size=(2, 64, 64)), 0)
    blocks[0, 3, 3] = (1 << 23) - 1
    blocks[1, 60, 2] = -((1 << 22) + 12345)
    blocks[1, 7, 9] = -(1 << 22)
    return torch.from_numpy(blocks.astype(np.int32)), 24


@pytest.mark.parametrize("case", ["edges", "skips", "borders", "signs", "cut",
                                  "raw", "wide"])
@pytest.mark.parametrize("cp,k", [(2, 0.0), (3, 0.0), (2, 5.0)])
def test_edge_blocks_match_plain(cuda, cp, k, case):
    n_planes = 16
    if case == "edges":
        blocks = _edge_blocks()
    elif case == "skips":
        blocks = _skip_blocks()
    else:
        blocks, n_planes = _mask_blocks(case)
    n = blocks.shape[0]
    levels = np.zeros(n, dtype=np.int32)
    subbands = np.zeros(n, dtype=np.int32)
    groups = PARAMS.n_bitplane_files if k > 0 else 1
    lut = (neutral_lut(PARAMS, WL, cp, groups) if case == "edges"
           else _skewed_lut(cp, groups))
    meta = bpc._meta_args(levels, subbands, PARAMS, WL, cp, k)
    args = [torch.from_numpy(np.asarray(a)) for a in (lut, *meta)]
    kw = dict(params=PARAMS, wavelet_levels=WL, coding_passes=cp,
              has_k=k > 0)
    sizes = _check_kernels(cuda, blocks, args, kw, n_planes,
                           exact=case != "cut")
    if case == "skips":
        # none raw for the cp2 decoder (the bulk pass's stream of the 16-bit
        # block is)
        assert (cp, k) != (2, 0.0) or bool((sizes < 4096).all())
        return
    if case != "edges":
        # with cp2 only the raw case's stream is raw
        assert (cp, k) != (2, 0.0) or bool((sizes < 4096).all()) == (
            case != "raw")
        return
    assert int(sizes[0]) == 1 and int(sizes[3]) == 4096
    if (cp, k) == (2, 0.0):
        assert (int(sizes[4]), int(sizes[5])) == (4095, 4096)


def test_encode_step_counts_match_the_coefficients(cuda):
    """The cp2 encoder's step counters over a random batch with an empty, a
    raw and an MSB-0 block and one whose MSB (17) lies above n_planes - 1
    read exactly the steps counted from its coefficients, the skipped ones
    included and the raw block left out, as the decoder's."""
    blocks, args, kw, n_planes = _batch(7, 200)
    blocks[8] = 0
    blocks[8, 12, 13] = -((1 << 17) + 3)
    blocks[8, 40, 2] = 9
    assert n_planes == 16
    want_s, want_n = bpc.encode_blocks_plain(blocks, *args, **kw,
                                             n_planes=n_planes)
    dargs = [a.to(cuda) for a in args]
    before = bpc_cuda.encode_step_counts()
    got_s, got_n = bpc_cuda.encode_blocks(blocks.to(cuda), *dargs, **kw,
                                          n_planes=n_planes)
    after = bpc_cuda.encode_step_counts()
    assert torch.equal(got_s.cpu(), want_s) and torch.equal(got_n.cpu(),
                                                           want_n)
    assert (int(want_n[3]), int(want_n[5])) == (1, 4096)
    want = step_counts(blocks.numpy(), n_planes, want_n.numpy())
    assert (after[0] - before[0], after[1] - before[1]) == want
    assert 0 < want[1] < want[0]


def test_decode_step_counts_match_the_coefficients(cuda):
    """The cp2 decoder's step counters over a 2048^2 plane (lossless,
    wl=5, neutral LUT) read exactly the steps counted from its
    coefficients, the skipped ones included."""
    cfg = CodecConfig(width=2048, height=2048, wavelet_levels=5)
    codec = TorchCodec(cfg, [neutral_lut(PARAMS, 5, 2)], PARAMS, cuda)
    img = torch.from_numpy(goldens.make_image(2048)).to(cuda)
    (blocks,), mx = dwt_cuda.forward([img], cfg)
    n_planes = bpc.planes_for_magnitude(int(mx))
    a, kw = codec._bpc_args(), dict(codec._bpc_kw, n_planes=n_planes)
    streams, sizes = bpc_cuda.encode_blocks(blocks, *a, **kw)
    before = bpc_cuda.decode_step_counts()
    out = bpc_cuda.decode_blocks(streams, sizes, *a, **kw)
    after = bpc_cuda.decode_step_counts()
    assert torch.equal(out, blocks)
    want = step_counts(blocks.cpu().numpy(), n_planes, sizes.cpu().numpy())
    assert (after[0] - before[0], after[1] - before[1]) == want
    assert 0 < want[1] < want[0]


def test_device_pack_matches_host_pack(cuda):
    """The codestream packed and unpacked on the card equals the host
    pack's, on the kernels' streams of random and edge blocks."""
    blocks, args, kw, n_planes = _batch(3, 200)
    blocks = torch.cat([blocks, _edge_blocks()])
    args = [args[0], *(torch.cat([a, a[:8]]) for a in args[1:])]
    dargs = [a.to(cuda) for a in args]
    streams, sizes = bpc_cuda.encode_blocks(blocks.to(cuda), *dargs, **kw,
                                            n_planes=16)
    hdr = pack_header(CodecConfig(width=64, height=64))
    got = pack.pack_streams(streams, sizes, hdr).cpu().numpy().view(np.uint16)
    want = host_pack.pack_streams(streams.cpu().numpy(),
                                  sizes.cpu().numpy(), hdr)
    assert np.array_equal(got, want)
    n = blocks.shape[0]
    payload = int(pack.block_fields(got, n)[1].sum()) - n
    s_back, z_back = pack.unpack_streams(
        torch.from_numpy(got.view(np.int16)).to(cuda), n, payload)
    want_s, want_z = host_pack.unpack_streams(want, n)
    assert np.array_equal(s_back.cpu().numpy(), want_s)
    assert np.array_equal(z_back.cpu().numpy(), want_z)


def test_torch_codec_on_cuda_matches_oracle(cuda):
    rng = np.random.default_rng(1)
    y, x = np.mgrid[0:128, 0:128]
    img = np.clip(96 + 64 * np.sin(x / 9.0) * np.cos(y / 13.0)
                  + rng.normal(0, 8, size=(128, 128)), 0, 255).astype(np.uint8)
    cfg = CodecConfig(width=128, height=128, wavelet_levels=2)
    luts = [neutral_lut(PARAMS, 2, 2)]
    codec = TorchCodec(cfg, luts, PARAMS, cuda)
    got = codec.encode(img)
    # the download is the packed codestream, not the stream buffers
    sizes = pack.block_fields(got[0], codec.ncb)[1]
    assert got[0].size == pack.stream_length(codec.ncb,
                                             int(sizes.sum()) - codec.ncb)
    assert np.array_equal(got[0], oracle.encode_image(img, J(cfg), luts,
                                                      J(PARAMS))[0])
    assert np.array_equal(codec.decode(got), img)


def test_kernel_wrappers_reject_bad_inputs(cuda):
    blocks, args, kw, n_planes = _batch(0, 7, n=8, k=2.0)
    dargs = [a.to(cuda) for a in args]
    b = blocks.to(cuda)
    with pytest.raises(TypeError, match="int32"):
        bpc_cuda.encode_blocks(b.long(), *dargs, **kw, n_planes=n_planes)
    with pytest.raises(ValueError, match="contiguous"):
        bpc_cuda.encode_blocks(b.transpose(1, 2), *dargs, **kw,
                               n_planes=n_planes)
    with pytest.raises(ValueError, match="n_planes"):
        bpc_cuda.encode_blocks(b, *dargs, **kw, n_planes=33)
    with pytest.raises(TypeError, match="k_over_l2"):
        bpc_cuda.encode_blocks(b, *dargs[:-1], dargs[-1].double(), **kw,
                               n_planes=n_planes)
    with pytest.raises(ValueError, match="coding_passes"):
        bpc_cuda.encode_blocks(b, *dargs, **dict(kw, coding_passes=4),
                               n_planes=n_planes)
    flat = torch.zeros(8 * 4096 + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        bpc_cuda.decode_blocks(flat[1:].view(8, 4096),
                               torch.ones(8, dtype=torch.int32, device=cuda),
                               *dargs, **kw, n_planes=n_planes)


@pytest.mark.parametrize("case", ["probe_inputs", "edges", "seed1",
                                  "seed2"])
def test_probe_kernels_match_plain(cuda, case):
    for module in (probe, probe2):
        args = (module.inputs(0) if case == "probe_inputs"
                else module.edge_inputs() if case == "edges"
                else module.inputs(int(case[4:])))
        cpu = [torch.from_numpy(a) for a in args]
        before = module.LAUNCHES
        got = module.run(*(a.to(cuda) for a in cpu))
        torch.cuda.synchronize()
        assert module.LAUNCHES == before + 1
        assert torch.equal(got.cpu(), module.plain(*cpu))


def test_lossy_512_on_cuda_matches_oracle(cuda):
    rng = np.random.default_rng(2)
    y, x = np.mgrid[0:512, 0:512]
    img = np.clip(120 + 70 * np.sin(x / 11.0) * np.cos(y / 17.0)
                  + rng.normal(0, 6, size=(512, 512)), 0, 255).astype(np.uint8)
    cfg = CodecConfig(width=512, height=512, wavelet_levels=3, is_lossy=True,
                      qs=1.0)
    luts = [neutral_lut(PARAMS, 3, 2)]
    codec = TorchCodec(cfg, luts, PARAMS, cuda)
    got = codec.encode(img)
    want = oracle.encode_image(img, J(cfg), luts, J(PARAMS))
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(codec.decode(got),
                          oracle.decode_image(want, J(cfg), luts, J(PARAMS)))


def _frames(seed, n, h=64, w=128):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    return [np.clip(96 + 64 * np.sin((x + 5 * i) / 9.0) * np.cos(y / 13.0)
                    + rng.normal(0, 8, size=(h, w)), 0, 255).astype(np.uint8)
            for i in range(n)]


@pytest.mark.parametrize("rgb,lossy", [(False, False), (True, True)])
def test_video_on_cuda_equals_cpu_port(cuda, tmp_path, rgb, lossy):
    """Five frames, batch 2 (a padded tail): the file and `_SIZE` sidecar
    the card writes equal the CPU port's, with one encode and one decode
    launch per component and batch; the lossless decode is bit-exact, the
    lossy one equal to the CPU port's."""
    n_comp = 3 if rgb else 1
    planes = _frames(6, 5 * n_comp)
    raw, enc, enc_cpu, dec, dec_cpu = (str(tmp_path / n) for n in (
        "v.raw", "g.enc", "c.enc", "g.raw", "c.raw"))
    with open(raw, "wb") as f:
        for p in planes:
            f.write(p.tobytes())
    cfg = CodecConfig(width=128, height=64, wavelet_levels=2, frames=5,
                      is_rgb=rgb, components=n_comp, is_lossy=lossy)
    luts = [neutral_lut(PARAMS, 2, 2)] * n_comp
    bpc_cuda.reset_launches()
    stats = video.encode_video(raw, enc, cfg, luts, PARAMS, frames=5,
                               batch=2, device=cuda)
    assert stats.batches == 3
    assert bpc_cuda.ENCODE_LAUNCHES["cp2"] == 3 * n_comp
    video.encode_video(raw, enc_cpu, cfg, luts, PARAMS, frames=5, batch=2,
                       device="cpu")
    for suffix in ("", "_SIZE"):
        assert open(enc + suffix, "rb").read() == \
            open(enc_cpu + suffix, "rb").read()
    video.decode_video(enc, dec, cfg, luts, PARAMS, batch=2, device=cuda)
    assert bpc_cuda.DECODE_LAUNCHES["cp2"] == 3 * n_comp
    if lossy:
        video.decode_video(enc, dec_cpu, cfg, luts, PARAMS, batch=2,
                           device="cpu")
        raw = dec_cpu
    assert open(dec, "rb").read() == open(raw, "rb").read()


def test_batch_pack_equals_per_frame_pack(cuda):
    """A batch of three frames coded in one launch on the card, packed once
    with its payload length given: cut per frame, it is `pack_streams` of
    each frame's own blocks; joined again and unpacked on the card, it is
    the kernel's streams and sizes."""
    frames = _frames(7, 3)
    cfg = CodecConfig(width=128, height=64, wavelet_levels=2)
    bc = BatchCodec(cfg, [neutral_lut(PARAMS, 2, 2)], PARAMS, 3, cuda)
    padded = torch.from_numpy(np.stack([mirror_pad(f, bc.aw, bc.ah)
                                        for f in frames])).to(cuda)
    blocks, max_mag = bc.prep_batch(padded)
    (streams, sizes), = bc.encode_blocks(
        blocks, bpc.planes_for_magnitude(int(max_mag)))
    n = streams.shape[0]
    payload = int(sizes.sum()) - n
    shorts = pack.pack_streams(streams, sizes, None, payload=payload)
    shorts = shorts.cpu().numpy().view(np.uint16)
    hdr = pack_header(cfg)
    per_frame = pack.split_frames(shorts, 3, bc.ncb, hdr)
    for f, got in enumerate(per_frame):
        rows = slice(f * bc.ncb, (f + 1) * bc.ncb)
        want = pack.pack_streams(streams[rows], sizes[rows], hdr)
        assert np.array_equal(got, want.cpu().numpy().view(np.uint16))
    joined, _, _ = pack.join_frames(per_frame, bc.ncb)
    assert np.array_equal(joined, shorts)
    s_back, z_back = pack.unpack_streams(
        torch.from_numpy(joined.view(np.int16)).to(cuda), n, payload)
    assert torch.equal(s_back, streams) and torch.equal(z_back, sizes)


def test_sharded_codec_on_cuda_equals_torch_codec(cuda):
    """ShardedCodec on two shares of the card (every halo, gather and
    tiling copy, one BPC launch a shard and component): TorchCodec's
    codestreams on the card, and decodes equal to its own."""
    frames = _frames(8, 3, h=320, w=128)
    for cfg, pixels in (
            (CodecConfig(width=128, height=320, wavelet_levels=5), frames[0]),
            (CodecConfig(width=128, height=320, wavelet_levels=5,
                         is_lossy=True, qs=1.0), frames[0]),
            (CodecConfig(width=128, height=320, wavelet_levels=2, is_rgb=True,
                         components=3), frames)):
        n_comp = 3 if cfg.is_rgb else 1
        luts = [neutral_lut(PARAMS, cfg.wavelet_levels, 2)] * n_comp
        single = TorchCodec(cfg, luts, PARAMS, cuda)
        codec = ShardedCodec(cfg, luts, PARAMS, ["cuda:0"] * 2)
        want = single.encode(pixels)
        bpc_cuda.reset_launches()
        got = codec.encode(pixels)
        assert bpc_cuda.ENCODE_LAUNCHES["cp2"] == 2 * n_comp
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        out = codec.decode(got)
        assert bpc_cuda.DECODE_LAUNCHES["cp2"] == 2 * n_comp
        back = single.decode(want)
        assert all(np.array_equal(o, b) for o, b in
                   zip(out if cfg.is_rgb else [out],
                       back if cfg.is_rgb else [back]))


def test_frame_parallel_video_on_cuda_equals_one_device(cuda, tmp_path):
    """Five frames, batch 3 over two shares of the card (rounded up to 4,
    2 frames a share): the file and `_SIZE` of devices=1, one launch per
    share and batch, and a bit-exact decode over the two shares."""
    raw, one, two, dec = (str(tmp_path / n) for n in
                          ("v.raw", "1.enc", "2.enc", "d.raw"))
    with open(raw, "wb") as f:
        for p in _frames(9, 5):
            f.write(p.tobytes())
    cfg = CodecConfig(width=128, height=64, wavelet_levels=2, frames=5)
    luts = [neutral_lut(PARAMS, 2, 2)]
    video.encode_video(raw, one, cfg, luts, PARAMS, frames=5, batch=3,
                       device=cuda)
    bpc_cuda.reset_launches()
    stats = video.encode_video(raw, two, cfg, luts, PARAMS, frames=5,
                               batch=3, devices=["cuda:0"] * 2)
    assert stats.batch == 4 and stats.batches == 2
    assert bpc_cuda.ENCODE_LAUNCHES["cp2"] == 2 * 2
    for suffix in ("", "_SIZE"):
        assert open(two + suffix, "rb").read() == \
            open(one + suffix, "rb").read()
    video.decode_video(two, dec, cfg, luts, PARAMS, batch=3,
                       devices=["cuda:0"] * 2)
    assert bpc_cuda.DECODE_LAUNCHES["cp2"] == 2 * 2
    assert open(dec, "rb").read() == open(raw, "rb").read()


class _Spy:
    """The kernel library, recording each launch's stream argument and the
    device current while it launches, for the entry points named
    `prefix`*; a test puts it in place of `kernels.library`."""

    def __init__(self, prefix):
        self.lib = kernels.library()
        self.prefix = prefix
        self.calls = []
        self.names = []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.startswith(self.prefix):
            return fn

        def launch(*args):
            self.calls.append((args[-1], torch.cuda.current_device()))
            self.names.append(name)
            return fn(*args)
        return launch


@pytest.mark.parametrize("skip", [1, 2, 3])
def test_probe_kernels_on_misaligned_views(cuda, skip):
    """Tape and its second argument as views `skip` words off 16-byte
    alignment: K3 takes its word variant, and both probes still equal
    their plain versions."""
    for module in (probe, probe2):
        cpu = [torch.from_numpy(a) for a in module.inputs(2)]
        views = [_offset_view(a.to(cuda), skip) for a in cpu]
        assert all(v.data_ptr() % 16 for v in views)
        before = module.LAUNCHES
        got = module.run(*views)
        assert module.LAUNCHES == before + 1
        assert torch.equal(got.cpu(), module.plain(*cpu))


# -- X2 / X4: the transform kernels ------------------------------------------

def _dwt_cfg(h, w, rgb=False, lossy=False, qs=1.0, wl=3, bits=8,
             signed=False):
    return CodecConfig(width=w, height=h, wavelet_levels=wl, is_lossy=lossy,
                       qs=qs, is_rgb=rgb, components=3 if rgb else 1,
                       bit_depth=bits, bps=bits, is_signed=signed)


def _dwt_samples(cfg, frames=0, seed=5):
    """Sample planes of the configuration on the CPU: (frames, 3, h, w)
    RGB batches as strided views of one tensor."""
    peak = (1 << cfg.bit_depth) - 1
    n = max(frames, 1) * (3 if cfg.is_rgb else 1)
    planes = np.stack([goldens.make_image(cfg.height, seed=seed + k,
                                          width=cfg.width, peak=peak)
                       for k in range(n)])
    if cfg.is_signed:
        planes = (planes.astype(np.int32) - (peak + 1) // 2).astype(
            np.int8 if cfg.bit_depth <= 8 else np.int16)
    t = torch.from_numpy(planes).reshape(
        *((frames,) if frames else ()), *((3,) if cfg.is_rgb else ()),
        cfg.height, cfg.width)
    return list(t.unbind(-3)) if cfg.is_rgb else [t]


DWT_CASES = [
    # (h, w, frames, rgb, lossy, qs, wl, bits, signed)
    *[(256, 384, 0, False, False, 1.0, wl, 8, False) for wl in range(1, 6)],
    *[(256, 384, 0, False, True, qs, 3, 8, False) for qs in (1.0, 0.5, 0.7)],
    (512, 512, 0, False, True, 1.0, 5, 8, False),
    (192, 320, 0, False, False, 1.0, 2, 12, False),
    (256, 256, 0, False, True, 1.0, 4, 16, False),
    (256, 256, 0, False, True, 0.5, 3, 16, True),
    (256, 256, 0, False, False, 1.0, 5, 8, True),
    (256, 320, 0, True, False, 1.0, 5, 8, False),
    (256, 320, 0, True, True, 1.0, 3, 8, False),
    (256, 320, 0, True, True, 0.7, 2, 16, False),
    (192, 256, 3, False, False, 1.0, 3, 8, False),
    (192, 256, 2, True, True, 0.5, 4, 8, False),
    # six levels: the level-5 LL plane is 6 wide, read a value at a time,
    # and its bands 2 wide, stored a coefficient at a time
    (128, 192, 0, False, False, 1.0, 6, 8, False),
    (128, 192, 0, False, True, 1.0, 6, 8, False),
]


@pytest.mark.parametrize("h,w,frames,rgb,lossy,qs,wl,bits,signed",
                         DWT_CASES)
def test_dwt_kernels_match_plain(cuda, h, w, frames, rgb, lossy, qs, wl,
                                 bits, signed):
    """X2 and X4 on the card == their plain versions on the CPU: the
    codeblocks, the maximum and the samples, one launch a call."""
    cfg = _dwt_cfg(h, w, rgb, lossy, qs, wl, bits, signed)
    samples = _dwt_samples(cfg, frames)
    want, want_top = dwt_cuda.forward(samples, cfg)
    before = (dwt_cuda.FORWARD_LAUNCHES, dwt_cuda.REVERSE_LAUNCHES)
    blocks, top = dwt_cuda.forward([s.to(cuda) for s in samples], cfg)
    back = dwt_cuda.reverse(blocks, cfg)
    torch.cuda.synchronize()
    assert (dwt_cuda.FORWARD_LAUNCHES, dwt_cuda.REVERSE_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert int(top) == int(want_top)
    for b, w_ in zip(blocks, want):
        assert torch.equal(b.cpu(), w_)
    for b, w_ in zip(back, dwt_cuda.reverse(want, cfg)):
        assert b.dtype == w_.dtype and torch.equal(b.cpu(), w_)
    if not lossy:
        for b, s_ in zip(back, samples):
            assert torch.equal(b.cpu(), s_)


def test_codecs_run_the_dwt_kernels(cuda):
    """TorchCodec and BatchCodec on the card launch X2 and X4, with the
    CPU codec's results; the wrapper refuses a CUDA tensor of another
    type instead of falling back."""
    cfg = _dwt_cfg(192, 256, rgb=True, lossy=True, wl=3)
    luts = [neutral_lut(PARAMS, 3, 2)]
    samples = _dwt_samples(cfg)
    dwt_cuda.reset_launches()
    codec = TorchCodec(cfg, luts, PARAMS, cuda)
    coded, n_planes = codec.encode_planes([s.to(cuda) for s in samples])
    back = codec.decode_planes([(st, z, n_planes) for st, z in coded])
    assert (dwt_cuda.FORWARD_LAUNCHES, dwt_cuda.REVERSE_LAUNCHES) == (1, 1)
    host = TorchCodec(cfg, luts, PARAMS, "cpu")
    want, n_host = host.encode_planes(samples)
    assert n_planes == n_host
    for (st, z), (ws, wz) in zip(coded, want):
        assert torch.equal(st.cpu(), ws) and torch.equal(z.cpu(), wz)
    for b, w_ in zip(back, host.decode_planes(
            [(st, z, n_host) for st, z in want])):
        assert torch.equal(b.cpu(), w_)
    frames = torch.stack([torch.stack(_dwt_samples(cfg, seed=s))
                          for s in (1, 2)])
    batch = BatchCodec(cfg, luts, PARAMS, 2, cuda)
    blocks, top = batch.prep_batch(frames.to(cuda))
    out = batch.decode_batch(batch.encode_blocks(
        blocks, bpc.planes_for_magnitude(int(top))),
        bpc.planes_for_magnitude(int(top)))
    assert (dwt_cuda.FORWARD_LAUNCHES, dwt_cuda.REVERSE_LAUNCHES) == (2, 2)
    cpu = BatchCodec(cfg, luts, PARAMS, 2, "cpu")
    blocks_h, top_h = cpu.prep_batch(frames)
    assert int(top) == int(top_h)
    for b, w_ in zip(blocks, blocks_h):
        assert torch.equal(b.cpu(), w_)
    n_h = bpc.planes_for_magnitude(int(top_h))
    assert torch.equal(out.cpu(), cpu.decode_batch(
        cpu.encode_blocks(blocks_h, n_h), n_h))
    with pytest.raises(TypeError, match="uint8"):
        dwt_cuda.forward([s.to(cuda).int() for s in samples], cfg)


def _offset_view(t: torch.Tensor, skip: int) -> torch.Tensor:
    """`t`'s values in a view `skip` elements into a larger buffer."""
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
    buf[skip:skip + t.numel()] = t.reshape(-1)
    return buf[skip:skip + t.numel()].view(t.shape)


@pytest.mark.parametrize("skip", [0, 1, 8])
@pytest.mark.parametrize("lossy,bits", [(False, 8), (True, 16)])
def test_dwt_forward_on_offset_views(cuda, skip, lossy, bits):
    """X2 on an aligned view (skip 0: 16-byte loads) and on views whose
    first sample is not 16-byte aligned (the scalar-load variant) ==
    forward_plain on the CPU, one launch a call."""
    cfg = _dwt_cfg(192, 320, lossy=lossy, wl=4, bits=bits)
    (plane,) = _dwt_samples(cfg)
    view = _offset_view(plane.to(cuda), skip)
    assert dwt_cuda.vector_loads([view]) == (skip * view.element_size()
                                             % 16 == 0)
    before = dwt_cuda.FORWARD_LAUNCHES
    blocks, top = dwt_cuda.forward([view], cfg)
    torch.cuda.synchronize()
    assert dwt_cuda.FORWARD_LAUNCHES == before + 1
    want, want_top = dwt_cuda.forward([plane], cfg)
    assert int(top) == int(want_top) and torch.equal(blocks[0].cpu(),
                                                     want[0])


@pytest.mark.parametrize("skip", [0, 1, 4])
@pytest.mark.parametrize("rgb,lossy,wl", [(False, False, 4), (False, True, 5),
                                          (True, True, 3)])
def test_dwt_reverse_on_offset_views(cuda, skip, rgb, lossy, wl):
    """X4 on codeblocks in views whose first word is 16-byte aligned (skip
    0 and 4 words: 16-byte loads) and in one that is not (the word-load
    variant) == reverse_plain on the CPU, one launch a call (at wl=5 the
    deepest bands are 10 words wide: words at every base)."""
    cfg = _dwt_cfg(192, 320, rgb=rgb, lossy=lossy, wl=wl)
    blocks, _ = dwt_cuda.forward(_dwt_samples(cfg), cfg)
    views = [_offset_view(b.to(cuda), skip) for b in blocks]
    assert dwt_cuda.vector_block_loads(views) == (skip * 4 % 16 == 0)
    before = dwt_cuda.REVERSE_LAUNCHES
    back = dwt_cuda.reverse(views, cfg)
    torch.cuda.synchronize()
    assert dwt_cuda.REVERSE_LAUNCHES == before + 1
    for b, w_ in zip(back, dwt_cuda.reverse(blocks, cfg)):
        assert b.dtype == w_.dtype and torch.equal(b.cpu(), w_)


@pytest.mark.parametrize("rgb", [False, True])
def test_dwt_forward_on_a_frame_stride_off_16_bytes(cuda, rgb):
    """A frame batch whose frames lie 8 bytes further apart than their
    planes (a frame stride that is not a multiple of 16 bytes): the
    wrapper takes it, X2 reads it a sample at a time, == forward_plain."""
    cfg = _dwt_cfg(128, 192, rgb=rgb, lossy=rgb, wl=3)
    frames = torch.stack([torch.stack(_dwt_samples(cfg, seed=s))
                          for s in (1, 2, 3)])          # (3, comps, h, w)
    per = frames[0].numel() + 8
    buf = torch.zeros(3 * per, dtype=torch.uint8, device=cuda)
    strided = buf.as_strided(frames.shape, (per, *frames.stride()[1:]))
    strided.copy_(frames.to(cuda))
    samples = list(strided.unbind(1))
    assert samples[0].stride(0) == per and not dwt_cuda.vector_loads(samples)
    before = dwt_cuda.FORWARD_LAUNCHES
    blocks, top = dwt_cuda.forward(samples, cfg)
    torch.cuda.synchronize()
    assert dwt_cuda.FORWARD_LAUNCHES == before + 1
    want, want_top = dwt_cuda.forward(list(frames.unbind(1)), cfg)
    assert int(top) == int(want_top)
    for b, w_ in zip(blocks, want):
        assert torch.equal(b.cpu(), w_)


def test_dwt_forward_counts_one_launch_a_call(cuda):
    """FORWARD_LAUNCHES counts a call (its levels' launches are one) and
    nothing else: not a refused input, not the CPU's plain version."""
    cfg = _dwt_cfg(256, 256, wl=5)
    (plane,) = _dwt_samples(cfg)
    dwt_cuda.reset_launches()
    for _ in range(3):
        dwt_cuda.forward([plane.to(cuda)], cfg)
    dwt_cuda.forward([plane], cfg)
    with pytest.raises(TypeError):
        dwt_cuda.forward([plane.to(cuda).int()], cfg)
    torch.cuda.synchronize()
    assert dwt_cuda.FORWARD_LAUNCHES == 3


@pytest.mark.parametrize("rgb,lossy,n", [(False, False, 3), (True, True, 2),
                                         (False, True, 4)])
def test_sharded_codec_runs_the_shard_modes(cuda, rgb, lossy, n):
    """ShardedCodec on n shares of the card: one launch of X2's and one of
    X4's shard mode a shard and level (the lossy 4-shard plan gathers from
    level 4), the unsharded card codestream and decode, and the codestream
    of the same codec on CPU shards (the plain version)."""
    cfg = _dwt_cfg(256, 256, rgb=rgb, lossy=lossy, wl=5)
    samples = [s.numpy() for s in _dwt_samples(cfg)]
    pixels = samples if rgb else samples[0]
    luts = [neutral_lut(PARAMS, 5, 2)] * len(samples)
    codec = ShardedCodec(cfg, luts, PARAMS, [cuda] * n)
    launches = sum(len(spans) for spans in codec._plan)
    dwt_cuda.reset_launches()
    got = codec.encode(pixels)
    assert dwt_cuda.FORWARD_LAUNCHES == launches
    back = codec.decode(got)
    assert dwt_cuda.REVERSE_LAUNCHES == launches
    single = TorchCodec(cfg, luts, PARAMS, cuda)
    want = single.encode(pixels)
    cpu = ShardedCodec(cfg, luts, PARAMS, ["cpu"] * n).encode(pixels)
    for g, w_, c in zip(got, want, cpu):
        assert np.array_equal(g, w_) and np.array_equal(g, c)
    for b, w_ in zip(back if rgb else [back],
                     single.decode(want) if rgb else [single.decode(want)]):
        assert np.array_equal(b, w_)


@pytest.mark.parametrize("lossy", [False, True])
def test_sharded_codec_on_several_cards(cuda, lossy, monkeypatch):
    """ShardedCodec with shard i on cuda:(i mod card count), up to 4 cards:
    the unsharded codestream and decode, and each shard mode's launch on
    its shard's card (level by level, deepest last forward and first
    back) and that card's current stream."""
    cards = min(torch.cuda.device_count(), 4)
    if cards < 2:
        pytest.skip("needs two or more cards")
    cfg = _dwt_cfg(512, 256, lossy=lossy, wl=5)
    pixels = _dwt_samples(cfg)[0].numpy()
    luts = [neutral_lut(PARAMS, 5, 2)]
    spy = _Spy("picsong_dwt_")
    monkeypatch.setattr(kernels, "library", lambda *a, **k: spy)
    codec = ShardedCodec(cfg, luts, PARAMS, cards)
    got = codec.encode(pixels)
    back = codec.decode(got)
    calls = list(spy.calls)
    single = TorchCodec(cfg, luts, PARAMS, cuda)
    want = single.encode(pixels)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(back, single.decode(want))
    order = [codec.devices[s].index for spans in codec._plan
             for s, _, _ in spans]
    want_cards = order + [codec.devices[s].index
                          for spans in reversed(codec._plan)
                          for s, _, _ in spans]
    assert [d for _, d in calls] == want_cards
    assert {d for _, d in calls} == set(range(cards))
    for stream, d in calls:
        assert stream == torch.cuda.current_stream(d).cuda_stream


# -- X3: the codestream pack and unpack kernels -------------------------------

def _pack_batch(seed, kind, n):
    """(N, 4096) int32 streams as the coder leaves them (-1 past the size;
    raw copies with words up to 0xFFFF) and their int32 sizes: all empty,
    all raw, or mixed with both ends."""
    rng = np.random.default_rng(seed)
    sizes = {"empty": np.ones(n), "raw": np.full(n, 4096),
             "mixed": rng.integers(1, 4097, size=n)}[kind].astype(np.int32)
    if kind == "mixed":
        sizes[:3] = (1, 4096, 2)[:n]
    streams = np.full((n, 4096), -1, dtype=np.int32)
    keep = np.arange(4096)[None, :] < sizes[:, None]
    streams[keep] = rng.integers(0, 1 << 16, size=int(sizes.sum()),
                                 dtype=np.int32)
    streams[:, 0] = np.where(sizes == 1, 32, rng.integers(0, 16, size=n))
    return torch.from_numpy(streams), torch.from_numpy(sizes)


@pytest.mark.parametrize("kind,n", [("empty", 0), ("empty", 9), ("raw", 5),
                                    ("mixed", 1), ("mixed", 1500),
                                    ("mixed", 4080)])
def test_pack_kernels_match_plain(cuda, kind, n):
    """The kernels' codestream and unpacked streams and sizes == the plain
    version's on the CPU, with and without a header and with the payload
    given; one launch a call (none for an empty unpack)."""
    streams, sizes = _pack_batch(n, kind, n)
    s_d, z_d = streams.to(cuda), sizes.to(cuda)
    payload = int(sizes.sum()) - n
    hdr = pack_header(CodecConfig(width=64, height=64))
    for h, p in ((hdr, None), (None, None), (hdr, payload)):
        want = pack.pack_streams_plain(streams, sizes, h, p)
        before = pack.PACK_LAUNCHES
        got = pack.pack_streams(s_d, z_d, h, payload=p)
        assert pack.PACK_LAUNCHES == before + 1
        assert got.shape == want.shape and torch.equal(got.cpu(), want)
    before = pack.UNPACK_LAUNCHES
    s_back, z_back = pack.unpack_streams(got, n, payload)
    assert pack.UNPACK_LAUNCHES == before + (n > 0)
    assert s_back.shape == (n, 4096) and z_back.shape == (n,)
    assert torch.equal(s_back.cpu(), streams)
    assert torch.equal(z_back.cpu(), sizes)


def _aligned_batch():
    """Streams whose blocks with counts 0-17 and 4095 each start their
    payload at every residue mod 8 of the 16-byte chunks
    (`goldens.aligned_counts`, 304 blocks)."""
    sizes = np.asarray(goldens.aligned_counts(), dtype=np.int32) + 1
    n = sizes.size
    rng = np.random.default_rng(12)
    streams = np.full((n, 4096), -1, dtype=np.int32)
    keep = np.arange(4096)[None, :] < sizes[:, None]
    streams[keep] = rng.integers(0, 1 << 16, size=int(sizes.sum()),
                                 dtype=np.int32)
    return torch.from_numpy(streams), torch.from_numpy(sizes)


def test_pack_kernels_at_every_alignment(cuda):
    """Payloads starting at every 2-byte place of a 16-byte chunk, with
    heads, bodies and tails of every length: the kernels' codestream and
    unpack == the plain version's."""
    streams, sizes = _aligned_batch()
    n = sizes.numel()
    payload = int(sizes.sum()) - n
    want = pack.pack_streams_plain(streams, sizes, None)
    got = pack.pack_streams(streams.to(cuda), sizes.to(cuda), None)
    assert torch.equal(got.cpu(), want)
    s_back, z_back = pack.unpack_streams(got, n, payload)
    assert torch.equal(s_back.cpu(), streams)
    assert torch.equal(z_back.cpu(), sizes)


def test_unpack_kernel_reads_misaligned_views(cuda):
    """A codestream held in a view 1..7 shorts past a 16-byte boundary
    (as `join_frames` and the sharded uploads may hand it over) unpacks to
    the plain version's streams and sizes."""
    streams, sizes = _aligned_batch()
    n = sizes.numel()
    payload = int(sizes.sum()) - n
    code = pack.pack_streams_plain(streams, sizes, None)
    for k in range(1, 8):
        held = torch.empty(code.numel() + 8, dtype=torch.int16,
                           device=cuda)[k:k + code.numel()]
        held.copy_(code.to(cuda))
        assert held.data_ptr() % 16 == 2 * k
        s_back, z_back = pack.unpack_streams(held, n, payload)
        assert torch.equal(s_back.cpu(), streams)
        assert torch.equal(z_back.cpu(), sizes)


def test_codecs_run_the_pack_kernels(cuda):
    """TorchCodec.encode / decode on the card launch the pack and unpack
    kernels once a component, and the wrapper refuses a CUDA tensor it
    does not take instead of falling back."""
    frames = _frames(4, 1)
    cfg = CodecConfig(width=128, height=64, wavelet_levels=2)
    codec = TorchCodec(cfg, [neutral_lut(PARAMS, 2, 2)], PARAMS, cuda)
    pack.reset_launches()
    got = codec.encode(frames[0])
    assert np.array_equal(codec.decode(got), frames[0])
    assert (pack.PACK_LAUNCHES, pack.UNPACK_LAUNCHES) == (1, 1)
    streams, sizes = _pack_batch(1, "mixed", 4)
    with pytest.raises(TypeError, match="int32"):
        pack.pack_streams(streams.to(cuda).long(), sizes.to(cuda), None)
    with pytest.raises(ValueError, match="several devices"):
        pack.pack_streams(streams.to(cuda), sizes, None)
    flat = torch.zeros(4 * 4096 + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pack.pack_streams(flat[1:].view(4, 4096), sizes.to(cuda), None)


# -- every entry point: the current stream of the tensors' device -----------

def _case_bpc(device, decode):
    blocks, args, kw, n_planes = _batch(5, 200)
    kw = dict(kw, n_planes=n_planes)
    dargs = [a.to(device) for a in args]
    streams, sizes = bpc.encode_blocks_plain(blocks, *args, **kw)
    if not decode:
        got = bpc_cuda.encode_blocks(blocks.to(device), *dargs, **kw)
        return lambda: (torch.equal(got[0].cpu(), streams)
                        and torch.equal(got[1].cpu(), sizes))
    got = bpc_cuda.decode_blocks(streams.to(device), sizes.to(device),
                                 *dargs, **kw)
    coded = sizes != 4096
    return lambda: torch.equal(got.cpu()[coded], blocks[coded])


def _case_dwt(device, reverse):
    cfg = _dwt_cfg(256, 256, lossy=True, wl=4)
    samples = _dwt_samples(cfg)
    blocks, top = dwt_cuda.forward_plain(samples, cfg)
    if not reverse:
        got, got_top = dwt_cuda.forward([s.to(device) for s in samples], cfg)
        return lambda: (int(got_top) == int(top)
                        and torch.equal(got[0].cpu(), blocks[0]))
    got = dwt_cuda.reverse([b.to(device) for b in blocks], cfg)
    want = dwt_cuda.reverse_plain(blocks, cfg)
    return lambda: torch.equal(got[0].cpu(), want[0])


def _case_shard(device, reverse):
    cfg = _dwt_cfg(256, 256, lossy=True, wl=3)
    rows = _dwt_samples(cfg)[0][56:140]   # rows 60..136, the 9/7 halo of 4
    bands, top = dwt_cuda.forward_shard_plain([rows], cfg, 0, 56, 60, 136)
    if not reverse:
        got, got_top = dwt_cuda.forward_shard([rows.to(device)], cfg, 0, 56,
                                              60, 136)
        return lambda: int(got_top) == int(top) and all(
            torch.equal(g.cpu(), w) for g, w in zip(got, bands))
    # band rows 30..68: rows 64..128 with the band halo of 2
    got = dwt_cuda.reverse_shard([b.to(device) for b in bands], cfg, 0, 30,
                                 64, 128)
    want = dwt_cuda.reverse_shard_plain(bands, cfg, 0, 30, 64, 128)
    return lambda: torch.equal(got.cpu(), want)


def _case_pack(device, unpack):
    streams, sizes = _pack_batch(3, "mixed", 300)
    code = pack.pack_streams_plain(streams, sizes, None)
    if not unpack:
        got = pack.pack_streams(streams.to(device), sizes.to(device), None)
        return lambda: torch.equal(got.cpu(), code)
    got = pack.unpack_streams(code.to(device), 300, int(sizes.sum()) - 300)
    return lambda: (torch.equal(got[0].cpu(), streams)
                    and torch.equal(got[1].cpu(), sizes))


def _case_probe(device, module):
    cpu = [torch.from_numpy(a) for a in module.inputs(1)]
    dargs = [a.to(device) for a in cpu]
    got = module.launch(*dargs)
    return lambda: (got.device == dargs[0].device
                    and torch.equal(got.cpu(), module.plain(*cpu)))


# each C entry point: a call of its wrapper on CUDA tensors, the inputs
# made on the current stream just before it, and then its check against
# the plain version
_ENTRY_CASES = {
    "picsong_bpc_encode": lambda d: _case_bpc(d, False),
    "picsong_bpc_decode": lambda d: _case_bpc(d, True),
    "picsong_dwt_forward": lambda d: _case_dwt(d, False),
    "picsong_dwt_reverse": lambda d: _case_dwt(d, True),
    "picsong_dwt_forward_shard": lambda d: _case_shard(d, False),
    "picsong_dwt_reverse_shard": lambda d: _case_shard(d, True),
    "picsong_pack": lambda d: _case_pack(d, False),
    "picsong_unpack": lambda d: _case_pack(d, True),
    "picsong_probe": lambda d: _case_probe(d, probe),
    "picsong_probe2": lambda d: _case_probe(d, probe2),
}


def test_entry_cases_cover_every_entry_point():
    assert set(_ENTRY_CASES) == set(kernels._SIGNATURES)


@pytest.mark.parametrize("where", ["side stream", "second card"])
@pytest.mark.parametrize("entry", sorted(_ENTRY_CASES))
def test_launch_goes_to_the_current_stream(cuda, monkeypatch, entry, where):
    """Each wrapper launches its entry point once, through
    `kernels.launch`, on the current stream of its tensors' device: under
    a non-default current stream on that stream; with its tensors on
    cuda:1 while cuda:0 is current, under cuda:1 on cuda:1's current
    stream. Its results are the plain version's."""
    spy = _Spy(entry)
    monkeypatch.setattr(kernels, "library", lambda *a, **k: spy)
    if where == "side stream":
        device = cuda
        side = torch.cuda.Stream(device)
        with torch.cuda.stream(side):
            check = _ENTRY_CASES[entry](device)
        want = [(side.cuda_stream, torch.cuda.current_device())]
    else:
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two CUDA devices; this machine has "
                        f"{torch.cuda.device_count()}")
        device = torch.device("cuda", 1)
        with torch.cuda.device(0):
            check = _ENTRY_CASES[entry](device)
        want = [(torch.cuda.current_stream(device).cuda_stream, 1)]
    torch.cuda.synchronize(device)
    assert spy.names == [entry] and spy.calls == want
    assert check()
