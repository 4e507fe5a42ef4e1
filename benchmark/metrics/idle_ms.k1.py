"""The card's idle ms a request while the host is in K1's wrapper
(`entropy/bpc_cuda.py` `encode_blocks`): its `picsong/` span innermost
over the idle time."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, "k1")
