"""X3's unpack: one launch a component, the words of the pack moved
back."""

from .x3_pack import least_seconds  # noqa: F401
