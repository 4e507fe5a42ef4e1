"""K1's coder steps skipped as a share of its steps in scope over the
window (`counters/k1_steps.py`, `counters/k1_steps_skipped.py`); nothing
from a program without the counters or a window that encoded nothing."""

import math


def read(run):
    steps = run.launches.get("k1_steps", math.nan)
    skipped = run.launches.get("k1_steps_skipped", math.nan)
    if math.isnan(steps) or math.isnan(skipped) or steps <= 0:
        return None
    return 100.0 * skipped / steps
