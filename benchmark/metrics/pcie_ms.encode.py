"""The PCIe copies of a request's encode (the samples up, the
codestreams down), ms a request, from the memcpy spans."""

from benchmark.harness.readers import copies_ms


def read(run):
    return copies_ms(run, 0)
