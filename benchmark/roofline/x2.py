"""X2, the forward transform: one call an image."""

from . import dwt


def least_seconds(coded, cfg) -> float:
    return dwt.least_seconds(cfg)
