"""The cp2 decoder's coder steps, counted from a batch's coefficients alone.

A coded plane of a block has 256 steps in scope: SPP and MRP, each 64 rows
by 2 phases (the even and the odd column of each of the 32 lanes), from
the block's top plane, min(MSB, n_planes - 1), down to 0. The decode
kernel skips the MRP steps at which no lane codes: those whose 32 cells
were all insignificant before the plane's SPP. Before plane p a cell is
significant when its magnitude has a bit above p, up to the top plane.
Raw blocks (size 4096) and empty blocks code no plane.
"""

import numpy as np

ROWS = 64
STEPS_A_PLANE = 4 * ROWS


def step_counts(blocks, n_planes: int, sizes=None) -> tuple[int, int]:
    """(steps in scope, steps skipped) of decoding (N, 64, 64) coefficients
    with cp=2 at `n_planes`; `sizes`, the streams' sizes, leave out the
    raw blocks."""
    mag = np.abs(np.asarray(blocks, dtype=np.int64)).reshape(-1, ROWS, ROWS)
    if sizes is not None:
        mag = mag[np.asarray(sizes) != ROWS * ROWS]
    steps = skipped = 0
    for m in mag:
        top = min(int(m.max()).bit_length() - 1, n_planes - 1)
        for plane in range(top, -1, -1):
            sig = (m >> (plane + 1)) & ((1 << (top - plane)) - 1) != 0
            for phase in (0, 1):
                skipped += int((~sig[:, phase::2].any(axis=1)).sum())
            steps += STEPS_A_PLANE
    return steps, skipped
