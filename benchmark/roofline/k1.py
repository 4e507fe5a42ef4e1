"""K1, the BPC-PaCo encode kernel: one launch a component."""

from . import bpc


def least_seconds(coded, cfg) -> float:
    """The least time of K1's work on one frame, its components."""
    return sum(bpc.least_seconds(m, z, w)
               for m, z, w in zip(coded.msb, coded.nonzero, coded.words))
