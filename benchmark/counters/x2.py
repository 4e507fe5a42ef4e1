"""X2's calls: the forward transform's, a launch a level each."""

from picsong_tpu_torch.transform import dwt_cuda


def launches() -> int:
    return dwt_cuda.FORWARD_LAUNCHES
