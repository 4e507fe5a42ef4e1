"""X3 unpack's launches: the codestream unpack's."""

from picsong_tpu_torch.assembly import pack


def launches() -> int:
    return pack.UNPACK_LAUNCHES
