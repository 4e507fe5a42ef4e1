"""X3's unpack (csrc/pack.cu): its share of the roofline
over the window."""

from benchmark.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "x3_unpack", r"\bunpack_kernel\b")
