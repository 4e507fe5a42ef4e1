"""X4's calls: the reverse transform's, a launch a level each."""

from picsong_tpu_torch.transform import dwt_cuda


def launches() -> int:
    return dwt_cuda.REVERSE_LAUNCHES
