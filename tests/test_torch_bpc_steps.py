"""`bpc_steps.step_counts`, the cp2 decoder's steps counted from the
coefficients, on hand-made blocks whose counts are worked out by hand.
The card test holds the kernel's own counters to it
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest

from bpc_steps import step_counts


def _block(cells=()):
    block = np.zeros((64, 64), dtype=np.int32)
    for (r, c), v in cells:
        block[r, c] = v
    return block


def _lane0_column():
    block = _block()
    block[:, 0] = -2
    return block


# (block, n_planes, sizes, (steps, skipped)); a plane has 256 steps
CASES = {
    "empty": (_block(), 16, None, (0, 0)),
    # MSB 0: no cell is significant before plane 0, every MRP step skipped
    "one": (_block([((0, 0), 1)]), 16, None, (256, 128)),
    # plane 1: 128 MRP steps; plane 0: all but the step of (5, odd)
    "one_at_plane_1": (_block([((5, 9), -2)]), 16, None, (512, 255)),
    # every cell significant before plane 0: all its MRP steps run
    "all_at_plane_1": (np.full((64, 64), 3, np.int32), 16, None, (512, 128)),
    # lane 0's even column: plane 0 refines a cell of every even step
    "lane_0_column": (_lane0_column(), 16, None, (512, 128 + 64)),
    # the top plane is cut to n_planes - 1 = 1: bit 3 is never coded
    "cut": (_block([((0, 0), 8), ((1, 1), 2)]), 2, None, (512, 128 + 127)),
    # a raw block codes no plane
    "raw": (_block([((0, 0), 1)]), 16, [4096], (0, 0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_step_counts_by_hand(case):
    block, n_planes, sizes, want = CASES[case]
    assert step_counts(block[None], n_planes, sizes) == want


def test_step_counts_add_over_a_batch():
    blocks = np.stack([CASES[c][0] for c in ("one", "one_at_plane_1",
                                             "all_at_plane_1")])
    assert step_counts(blocks, 16) == (1280, 128 + 255 + 128)
    sizes = [4096, 7, 7]
    assert step_counts(blocks, 16, sizes) == (1024, 255 + 128)
