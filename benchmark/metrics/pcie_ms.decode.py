"""The PCIe copies of a request's decode (the codestreams up, the
samples down), ms a request, from the memcpy spans."""

from benchmark.harness.readers import copies_ms


def read(run):
    return copies_ms(run, 1)
