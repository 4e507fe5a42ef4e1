"""X3's pack (csrc/pack.cu): its share of the roofline over
the window."""

from benchmark.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "x3_pack", r"\bpack_kernel\b")
