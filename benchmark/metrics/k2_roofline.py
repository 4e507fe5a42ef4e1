"""K2, the BPC-PaCo decode kernel (csrc/bpc_decode.cu):
its share of the roofline over the window."""

from benchmark.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k2", r"\bbpc_decode_kernel\b")
