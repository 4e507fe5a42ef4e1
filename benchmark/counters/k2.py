"""K2's launches: the BPC decode kernel's, every mode."""

from picsong_tpu_torch.entropy import bpc_cuda


def launches() -> int:
    return sum(bpc_cuda.DECODE_LAUNCHES.values())
