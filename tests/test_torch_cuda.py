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
from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
from picsong_tpu_torch.engine.pipeline import TorchCodec
from picsong_tpu_torch.entropy import bpc, bpc_cuda
from picsong_tpu_torch.tools import probe, probe2
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


def _check_kernels(cuda, blocks, args, kw, n_planes):
    """Both kernels of the mode of `kw` against the plain versions, with
    one launch each; returns the sizes."""
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
    assert torch.equal(out.cpu()[~raw], blocks[~raw])
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


@pytest.mark.parametrize("cp,k", [(2, 0.0), (3, 0.0), (2, 5.0)])
def test_edge_blocks_match_plain(cuda, cp, k):
    blocks = _edge_blocks()
    levels = np.zeros(8, dtype=np.int32)
    subbands = np.zeros(8, dtype=np.int32)
    groups = PARAMS.n_bitplane_files if k > 0 else 1
    lut = neutral_lut(PARAMS, WL, cp, groups)
    meta = bpc._meta_args(levels, subbands, PARAMS, WL, cp, k)
    args = [torch.from_numpy(np.asarray(a)) for a in (lut, *meta)]
    kw = dict(params=PARAMS, wavelet_levels=WL, coding_passes=cp,
              has_k=k > 0)
    sizes = _check_kernels(cuda, blocks, args, kw, 16)
    assert int(sizes[0]) == 1 and int(sizes[3]) == 4096
    if (cp, k) == (2, 0.0):
        assert (int(sizes[4]), int(sizes[5])) == (4095, 4096)


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


@pytest.mark.parametrize("case", ["probe_inputs", "edges"])
def test_probe_kernels_match_plain(cuda, case):
    for module in (probe, probe2):
        args = (module.inputs(0) if case == "probe_inputs"
                else module.edge_inputs())
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
