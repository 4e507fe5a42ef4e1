"""X4, the reverse transform (csrc/dwt_reverse.cu), its
launches of every level: its share of the roofline over the window."""

from benchmark.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "x4", r"\bdwt_reverse_kernel\b")
