"""The program's reads that block the host on a device value, a request
(`obs/trace.py` `READBACKS`: the coefficient maximum, each payload
total, the host path's downloads)."""

from benchmark.harness.spans import readbacks


def read(run):
    return readbacks(run)
