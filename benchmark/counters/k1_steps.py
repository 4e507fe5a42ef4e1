"""K1's coder steps in scope, the cp2 encoder's (256 a coded plane of a
block whose stream is not a raw copy; `bpc_cuda.encode_step_counts`): NaN
from a program without the counter, which stays NaN through the window's
difference."""

import math

from picsong_tpu_torch.entropy import bpc_cuda


def launches() -> float:
    counts = getattr(bpc_cuda, "encode_step_counts", None)
    return counts()[0] if counts else math.nan
