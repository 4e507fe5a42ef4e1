"""The host us a call of X4's wrapper (`transform/dwt_cuda.py`
`reverse`), from its `picsong/` span."""

from benchmark.harness.spans import host_us


def read(run):
    return host_us(run, "x4")
