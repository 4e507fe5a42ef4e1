"""The program's read-backs, `obs/trace.py` `READBACKS`: NaN from a
program without the counter, which stays NaN through the window's
difference, and the metric then reads nothing."""

import math

from picsong_tpu_torch.obs import trace


def launches() -> float:
    return getattr(trace, "READBACKS", math.nan)
