"""The host us a call of X3's pack wrapper (`assembly/pack.py`
`pack_streams`), less its payload total's read, from its `picsong/`
span."""

from benchmark.harness.spans import host_us


def read(run):
    return host_us(run, "x3_pack")
