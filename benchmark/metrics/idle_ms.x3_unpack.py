"""The card's idle ms a request while the host is in X3's unpack wrapper
(`assembly/pack.py` `unpack_streams`): its `picsong/` span innermost
over the idle time."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, "x3_unpack")
