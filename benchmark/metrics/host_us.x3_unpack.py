"""The host us a call of X3's unpack wrapper (`assembly/pack.py`
`unpack_streams`), from its `picsong/` span."""

from benchmark.harness.spans import host_us


def read(run):
    return host_us(run, "x3_unpack")
