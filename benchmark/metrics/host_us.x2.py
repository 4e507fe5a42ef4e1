"""The host us a call of X2's wrapper (`transform/dwt_cuda.py`
`forward`), from its `picsong/` span."""

from benchmark.harness.spans import host_us


def read(run):
    return host_us(run, "x2")
