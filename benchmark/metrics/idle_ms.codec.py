"""The card's idle ms a request while the host is in the codec's own code
(`engine/pipeline.py`: `encode_planes`, `decode_planes`, `encode`,
`decode`), outside every kernel wrapper."""

from benchmark.harness.spans import CODEC, idle_ms


def read(run):
    return idle_ms(run, CODEC)
