"""K2's skipped coder steps, the cp2 decoder's (the steps at which no lane
codes; `bpc_cuda.decode_step_counts`): NaN from a program without the
counter, which stays NaN through the window's difference."""

import math

from picsong_tpu_torch.entropy import bpc_cuda


def launches() -> float:
    counts = getattr(bpc_cuda, "decode_step_counts", None)
    return counts()[1] if counts else math.nan
