"""K1, the BPC-PaCo encode kernel (csrc/bpc_encode.cu):
its share of the roofline over the window."""

from benchmark.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k1", r"\bbpc_encode_kernel\b")
