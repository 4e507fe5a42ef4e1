"""The plain reference against the program's plain PyTorch versions on the
CPU at small sizes, byte for byte: the LUT parser on the frozen folders,
the header, and the codestreams and decoded samples of each kind of
configuration; and the control one step coarser, which must differ."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import images
from benchmark.reference import codec as ref
from benchmark.reference.lut import load_luts
from picsong_tpu_torch.core import lut as prog_lut
from picsong_tpu_torch.core.header import CodecConfig, pack_header
from picsong_tpu_torch.engine.pipeline import TorchCodec

ROOT = Path(__file__).resolve().parents[2]

FIELDS = ("width", "height", "components", "is_rgb", "bit_depth", "bps",
          "is_signed", "endianess", "is_lossy", "qs", "wavelet_levels",
          "coding_passes", "k_factor", "cb_height", "cb_width", "frames")


def _configs():
    for name in ("rgb8_2048x2560_lossless53", "gray8_8192_lossy97"):
        yield name, json.loads(
            (ROOT / f"benchmark/configs/{name}.json").read_text())


@pytest.mark.parametrize("name,cfg", list(_configs()))
def test_luts_and_header_as_the_program_reads_them(name, cfg):
    folder = ROOT / "benchmark/configs" / cfg["lut_folder"]
    luts, params = load_luts(str(folder), cfg["wavelet_levels"])
    want, want_params = prog_lut.load_luts(str(folder), cfg["wavelet_levels"],
                                           2, 0.0)
    assert vars(params) == vars(want_params)
    assert len(luts) == len(want) == 3
    assert all(np.array_equal(a, b) for a, b in zip(luts, want))
    fields = {k: cfg[k] for k in FIELDS}
    assert np.array_equal(ref.header(ref.Config(**fields)),
                          pack_header(CodecConfig(**fields)))


CASES = {
    "gray lossless": ("rgb8_2048x2560_lossless53",
                      dict(is_rgb=False, width=192, height=128)),
    "gray lossy": ("gray8_8192_lossy97", dict(width=128, height=192,
                                              wavelet_levels=2)),
    "rgb lossless": ("rgb8_2048x2560_lossless53",
                     dict(width=64, height=128, wavelet_levels=3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_equals_the_program(case):
    base, change = CASES[case]
    cfg = dict(json.loads(
        (ROOT / f"benchmark/configs/{base}.json").read_text()), **change)
    luts, params = load_luts(
        str(ROOT / "benchmark/configs" / cfg["lut_folder"]),
        cfg["wavelet_levels"])
    config = ref.Config(**{k: cfg[k] for k in FIELDS})
    planes = config.n_planes_in
    content = {"base": 120, "amplitude": 70, "periods": [69, 107],
               "noise": 10}
    pool = images.make_pool(2 ** 40 + 3, 2, planes, config.height,
                            config.width, 255, content, "cpu")
    coded = ref.ReferenceCodec(config, luts, params, "cpu").run(
        pool, torch.uint8)
    program = TorchCodec(CodecConfig(**{k: cfg[k] for k in FIELDS}), luts,
                         prog_lut.LUTParams(**vars(params)), "cpu")
    for image, want in zip(pool, coded):
        host = [p.numpy() for p in image]
        got = program.encode(host if config.is_rgb else host[0])
        assert all(np.array_equal(a, b)
                   for a, b in zip(got, want.codestreams))
        back = program.decode(got)
        back = back if config.is_rgb else [back]
        assert all(np.array_equal(a, b) for a, b in zip(back, want.decoded))
        if not config.is_lossy:
            assert all(np.array_equal(a, b) for a, b in zip(host, back))
        # the counts the roofline reads: one entry a block and component
        assert [m.size for m in want.msb] == [config.n_blocks] * planes
        assert all(int(w.sum()) + w.size + 10 == c.size
                   for w, c in zip(want.words, want.codestreams))
    control = ref.ReferenceCodec(config, luts, params, "cpu",
                                 control=True).run(pool, torch.uint8)
    for got, want in zip(control, coded):
        assert any(a.shape != b.shape or not np.array_equal(a, b)
                   for a, b in zip(got.codestreams, want.codestreams))
        assert any(not np.array_equal(a, b)
                   for a, b in zip(got.decoded, want.decoded))


def test_pool_is_the_seed():
    content = {"base": 120, "amplitude": 70, "periods": [69, 107],
               "noise": 10}
    a = images.make_pool(2 ** 33 + 1, 2, 3, 64, 80, 255, content, "cpu")
    b = images.make_pool(2 ** 33 + 1, 2, 3, 64, 80, 255, content, "cpu")
    c = images.make_pool(2 ** 33 + 2, 2, 3, 64, 80, 255, content, "cpu")
    assert all(torch.equal(x, y) for i, j in zip(a, b) for x, y in zip(i, j))
    assert not torch.equal(a[0][0], c[0][0])
    assert a[0][0].dtype == torch.uint8 and a[0][0].shape == (64, 80)
    assert images.pool_size(64 * 80, 3, {"min_images": 2,
                                         "min_bytes": 60000000}) == 3907
