"""K1's launches: the BPC encode kernel's, every mode."""

from picsong_tpu_torch.entropy import bpc_cuda


def launches() -> int:
    return sum(bpc_cuda.ENCODE_LAUNCHES.values())
