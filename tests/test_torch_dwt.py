"""The port's 5/3 DWT and tiling against the JAX package and the NumPy
oracle. Integer lifting: every comparison is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from picsong_tpu.core import geometry as jgeom
from picsong_tpu.reference import dwt as odwt
from picsong_tpu.transform import dwt as jdwt
from picsong_tpu_torch.core import geometry as tgeom
from picsong_tpu_torch.transform import dwt as tdwt


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("shape", [(128, 128), (256, 64)])
@pytest.mark.parametrize("amp", [255, 32767])
def test_53_forward_reverse_match_jax_and_oracle(levels, shape, amp):
    rng = np.random.default_rng(levels * 7 + shape[1])
    plane = rng.integers(-amp, amp + 1, size=shape, dtype=np.int32)
    plane[0, :] = amp                     # the int extremes themselves
    plane[-1, :] = -amp
    got = tdwt.dwt_forward(torch.from_numpy(plane), levels)
    assert got.dtype == torch.int32
    want = np.asarray(jdwt.dwt_forward(plane, levels, lossy=False))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(),
                          odwt.dwt_forward(plane, levels, lossy=False, qs=1.0))
    back = tdwt.dwt_reverse(got, levels)
    assert np.array_equal(back.numpy(),
                          np.asarray(jdwt.dwt_reverse(want, levels,
                                                      lossy=False)))
    assert np.array_equal(back.numpy(), plane)


def test_53_reverse_of_arbitrary_mosaic_matches_oracle():
    rng = np.random.default_rng(9)
    mallat = rng.integers(-300, 300, size=(128, 128), dtype=np.int32)
    got = tdwt.dwt_reverse(torch.from_numpy(mallat), 2)
    assert np.array_equal(got.numpy(),
                          odwt.dwt_reverse(mallat, 2, lossy=False, qs=1.0))


def test_lossy_and_bad_levels_raise():
    plane = torch.zeros((64, 64), dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        tdwt.dwt_forward(plane, 2, lossy=True)
    with pytest.raises(ValueError, match="multiples of 128"):
        tdwt.dwt_reverse(plane, 7, lossy=True)
    with pytest.raises(ValueError, match="multiples of 128"):
        tdwt.dwt_forward(plane, 7)


@pytest.mark.parametrize("shape", [(64, 64), (128, 192), (256, 64)])
def test_tiling_matches_jax_and_round_trips(shape):
    rng = np.random.default_rng(shape[1])
    plane = rng.integers(-1000, 1000, size=shape, dtype=np.int32)
    blocks = tgeom.plane_to_codeblocks(torch.from_numpy(plane))
    assert np.array_equal(blocks.numpy(), jgeom.plane_to_codeblocks(plane))
    back = tgeom.codeblocks_to_plane(blocks, *shape)
    assert np.array_equal(back.numpy(), plane)
