"""The card's idle ms a request while the host is in X3's pack wrapper
(`assembly/pack.py` `pack_streams`), its payload total's read
included: its `picsong/` span innermost over the idle time."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, "x3_pack")
