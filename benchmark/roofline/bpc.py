"""The work of BPC-PaCo on one component's codeblocks (K1 encodes, K2
decodes; the same work each way), counted from the reference's coding of
the inputs and not from the program's outputs.

A coded symbol is every cell of every bitplane from each block's MSB
down, plus one sign a nonzero coefficient; a coding step of a lane is 12
int32 operations (the interval's multiply, shift, add, compare and
selects). Bytes: the int32 coefficients once and the coded 16-bit words
(a block's size, its MSB word included) once.
"""

import numpy as np

from . import peaks

OPS_PER_SYMBOL = 12
CELLS = 64 * 64


def least_seconds(msb: np.ndarray, nonzero: np.ndarray,
                  words: np.ndarray) -> float:
    symbols = float(np.clip(msb + 1, 0, None).sum()) * CELLS \
        + float(nonzero.sum())
    nbytes = 4 * CELLS * msb.size + 2 * float(words.sum())
    return peaks.least_seconds(OPS_PER_SYMBOL * symbols, nbytes,
                               peaks.INT32_OPS_PER_S)
