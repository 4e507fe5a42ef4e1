"""K2, the BPC-PaCo decode kernel: one launch a component, the work of
K1 in reverse."""

from .k1 import least_seconds  # noqa: F401
