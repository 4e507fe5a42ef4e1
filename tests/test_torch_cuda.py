"""The port's CUDA kernels on the card: byte-equal to their plain versions.

These tests need an NVIDIA GPU (sm_90a) and nvcc; elsewhere they skip.
On the card, where JAX is absent, run them without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Every value is an integer, so every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from picsong_tpu.core.header import CodecConfig
from picsong_tpu.core.lut import LUTParams, neutral_lut
from picsong_tpu.reference import codec as oracle
from picsong_tpu_torch.engine.pipeline import TorchCodec
from picsong_tpu_torch.entropy import bpc, bpc_cuda
from picsong_tpu_torch.tools import probe, probe2

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


def _batch(seed, maxmag, n=64):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(-maxmag, maxmag + 1, size=(n, 64, 64),
                          dtype=np.int32)
    blocks[rng.random(blocks.shape) < 0.7] = 0
    blocks[3] = 0
    blocks[5] = rng.integers(-30000, 30001, size=(64, 64), dtype=np.int32)
    levels = (np.arange(n) % (WL + 1)).astype(np.int32)
    subbands = np.where(levels == WL, 0, np.arange(n) % 3).astype(np.int32)
    lut = neutral_lut(PARAMS, WL, 2)
    lut = lut + (np.arange(lut.size, dtype=np.int32) % 41)
    meta = bpc.block_metadata(levels, subbands, PARAMS, WL, 2, 0.0)
    args = [torch.from_numpy(a) for a in (lut, meta["ref"], meta["sig"],
                                          meta["sign"])]
    n_planes = bpc.planes_for_magnitude(int(np.abs(blocks).max()))
    return torch.from_numpy(blocks), args, n_planes


@pytest.mark.parametrize("seed,maxmag", [(0, 200), (1, 7), (2, 30000)])
def test_kernels_match_plain(cuda, seed, maxmag):
    blocks, args, n_planes = _batch(seed, maxmag)
    want_s, want_n = bpc.encode_blocks_plain(blocks, *args, params=PARAMS,
                                             n_planes=n_planes)
    dargs = [a.to(cuda) for a in args]
    before = (bpc_cuda.ENCODE_LAUNCHES, bpc_cuda.DECODE_LAUNCHES)
    got_s, got_n = bpc_cuda.encode_blocks(blocks.to(cuda), *dargs,
                                          params=PARAMS, n_planes=n_planes)
    out = bpc_cuda.decode_blocks(got_s, got_n, *dargs, params=PARAMS,
                                 n_planes=n_planes)
    torch.cuda.synchronize()
    assert (bpc_cuda.ENCODE_LAUNCHES, bpc_cuda.DECODE_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got_n.cpu(), want_n)
    assert torch.equal(got_s.cpu(), want_s)
    assert int(got_n[5]) == 4096 and int(got_n[3]) == 1
    assert torch.equal(out.cpu(), blocks)


def test_torch_codec_on_cuda_matches_oracle(cuda):
    rng = np.random.default_rng(1)
    y, x = np.mgrid[0:128, 0:128]
    img = np.clip(96 + 64 * np.sin(x / 9.0) * np.cos(y / 13.0)
                  + rng.normal(0, 8, size=(128, 128)), 0, 255).astype(np.uint8)
    cfg = CodecConfig(width=128, height=128, wavelet_levels=2)
    luts = [neutral_lut(PARAMS, 2, 2)]
    codec = TorchCodec(cfg, luts, PARAMS, cuda)
    got = codec.encode(img)
    assert np.array_equal(got[0], oracle.encode_image(img, cfg, luts,
                                                      PARAMS)[0])
    assert np.array_equal(codec.decode(got), img)


def test_kernel_wrappers_reject_bad_inputs(cuda):
    blocks, args, n_planes = _batch(0, 7, n=8)
    dargs = [a.to(cuda) for a in args]
    b = blocks.to(cuda)
    with pytest.raises(TypeError, match="int32"):
        bpc_cuda.encode_blocks(b.long(), *dargs, params=PARAMS,
                               n_planes=n_planes)
    with pytest.raises(ValueError, match="contiguous"):
        bpc_cuda.encode_blocks(b.transpose(1, 2), *dargs, params=PARAMS,
                               n_planes=n_planes)
    with pytest.raises(ValueError, match="n_planes"):
        bpc_cuda.encode_blocks(b, *dargs, params=PARAMS, n_planes=33)
    flat = torch.zeros(8 * 4096 + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        bpc_cuda.decode_blocks(flat[1:].view(8, 4096),
                               torch.ones(8, dtype=torch.int32, device=cuda),
                               *dargs, params=PARAMS, n_planes=n_planes)


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
    want = oracle.encode_image(img, cfg, luts, PARAMS)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(codec.decode(got),
                          oracle.decode_image(want, cfg, luts, PARAMS))
