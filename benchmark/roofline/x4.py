"""X4, the reverse transform: one call an image, the work of X2 in
reverse."""

from .x2 import least_seconds  # noqa: F401
