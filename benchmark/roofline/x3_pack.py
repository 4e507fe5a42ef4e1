"""X3's pack: one launch a component."""

from . import pack


def least_seconds(coded, cfg) -> float:
    return sum(pack.least_seconds(w) for w in coded.words)
