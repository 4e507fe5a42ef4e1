"""The work of the codestream pack and unpack of one component (X3): a
copy, counted in the format's 16-bit words whatever buffers the program
keeps them in. Pack reads each block's MSB word, size and payload words
and writes the codestream (9 header shorts, the pairs, the payload, one
filler); unpack reads the codestream and writes the MSB words, sizes and
payload words. No operation count comes near the bytes."""

import numpy as np

from . import peaks

HEADER_SHORTS = 9


def least_seconds(words: np.ndarray) -> float:
    n = words.size
    payload = float(words.sum()) - n
    fields = 2 * n + payload
    codestream = HEADER_SHORTS + fields + 1
    return peaks.least_seconds(0.0, 2 * (fields + codestream),
                               peaks.INT32_OPS_PER_S)
