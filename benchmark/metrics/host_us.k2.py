"""The host us a call of K2's wrapper (`entropy/bpc_cuda.py`
`decode_blocks`), from its `picsong/` span."""

from benchmark.harness.spans import host_us


def read(run):
    return host_us(run, "k2")
