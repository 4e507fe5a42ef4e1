"""X3 pack's launches: the codestream pack's."""

from picsong_tpu_torch.assembly import pack


def launches() -> int:
    return pack.PACK_LAUNCHES
