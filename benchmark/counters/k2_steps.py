"""K2's coder steps in scope, the cp2 decoder's (256 a coded plane of a
block; `bpc_cuda.decode_step_counts`): NaN from a program without the
counter, which stays NaN through the window's difference."""

import math

from picsong_tpu_torch.entropy import bpc_cuda


def launches() -> float:
    counts = getattr(bpc_cuda, "decode_step_counts", None)
    return counts()[0] if counts else math.nan
