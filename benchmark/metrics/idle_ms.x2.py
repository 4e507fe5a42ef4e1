"""The card's idle ms a request while the host is in X2's wrapper
(`transform/dwt_cuda.py` `forward`), its maximum's read included: its
`picsong/` span innermost over the idle time."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, "x2")
