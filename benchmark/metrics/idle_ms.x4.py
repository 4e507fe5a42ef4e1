"""The card's idle ms a request while the host is in X4's wrapper
(`transform/dwt_cuda.py` `reverse`): its `picsong/` span innermost
over the idle time."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, "x4")
