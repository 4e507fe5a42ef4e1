"""The system under test: the port, `picsong_tpu_torch`, behind the entries
a traffic mix can name. This and the files it finds by name are the
benchmark's whole contract with the program:

- an entry is `benchmark/entries/<name>.py`, the name a mix gives under
  `"entry"`: its `Entry(config, luts, params, device, inputs)` codes a
  request's list of pool images, the mix's `frames_per_request` of them
  (`encode(images)`, `decode(images, encoded)`), hands over the request's
  outputs a frame at a time, each with its pool image (`frames(images,
  encoded, decoded)` -> [(image, parts)]; an entry that codes one frame a
  request may list them as one `parts(encoded, decoded)` instead), and
  turns a frame's parts into NumPy codestreams and planes (`to_host`);
- a kernel's launch counter is `benchmark/counters/<kernel>.py`, whose
  `launches()` reads the program's own count.

Besides these the benchmark reads only, in a trace, the program's kernel
names and its stage labels. A new entry point or kernel comes as new files.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import torch

from picsong_tpu_torch.core.header import CodecConfig
from picsong_tpu_torch.core.lut import LUTParams
from picsong_tpu_torch.engine.pipeline import TorchCodec

from .cells import by_name

BENCH_DIR = Path(__file__).resolve().parents[1]
HEADER_SHORTS = 9
_CONFIG_FIELDS = ("width", "height", "components", "coding_passes",
                  "cb_height", "cb_width", "wavelet_levels", "bit_depth",
                  "is_lossy", "qs", "is_rgb", "endianess", "bps",
                  "is_signed", "frames", "k_factor")


@dataclass
class Inputs:
    """What an entry may take from the harness: the pool's sample planes
    on the run's device, as made and padded to the codeblock grid, and the
    configuration's header."""
    pool: list
    padded: list
    header: object


def counters() -> dict[str, int]:
    """The program's launch counts, by the benchmark's kernel names."""
    return {path.stem: by_name(BENCH_DIR / "counters", path.stem).launches()
            for path in sorted((BENCH_DIR / "counters").glob("*.py"))}


def entry(kind: str, config, luts, params, device, inputs: Inputs):
    path = BENCH_DIR / "entries" / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"unknown traffic entry {kind!r}: no {path}")
    return by_name(BENCH_DIR / "entries", kind).Entry(
        config, luts, params, device, inputs)


def codec(config: dict, luts, params, device) -> TorchCodec:
    cfg = CodecConfig(**{k: config[k] for k in _CONFIG_FIELDS})
    return TorchCodec(cfg, luts, LUTParams(**vars(params)), device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
