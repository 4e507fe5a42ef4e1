"""X2, the forward transform (csrc/dwt_forward.cu), its
launches of every level: its share of the roofline over the window."""

from benchmark.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "x2", r"\bdwt_forward_kernel\b")
