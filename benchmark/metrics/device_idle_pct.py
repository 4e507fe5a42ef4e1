"""The device's idle share of the traced window: 100 % less the union
of its kernel, memcpy and memset spans over the window."""

from benchmark.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
