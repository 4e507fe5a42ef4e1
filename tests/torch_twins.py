"""The JAX package's twin of a port object: the same dataclass fields, the
JAX package's type. The port's tests build the port's own CodecConfig and
LUTParams and hand the JAX package and the NumPy oracle these twins."""

import dataclasses

from picsong_tpu.core import header as jheader
from picsong_tpu.core import lut as jlut
from picsong_tpu_torch.core import header, lut

_TWINS = {header.CodecConfig: jheader.CodecConfig,
          lut.LUTParams: jlut.LUTParams}


def J(obj):
    """The JAX package's object of the same numbers (other objects pass)."""
    twin = _TWINS.get(type(obj))
    return twin(**dataclasses.asdict(obj)) if twin else obj
