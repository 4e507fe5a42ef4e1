"""The LUT folder parser of the plain reference.

Reads a reference-format LUT folder (header.txt, then one text file per
section, channel and bitplane group, `{ref,sig,sign}[R|G|B].txt_<s>`, of
records "wLevel subband bitplane : p ...") into flat int32 tables laid
out as the BPC-PaCo coder indexes them:

  per bitplane group:  [ ref | sig | sign ]
  each section:        [level][subband][bitplane][ctx], level-major,
                       then one [bitplane][ctx] block for the residual LL

Bitplanes absent from a file keep the neutral probability 64 (0.5 at 7-bit
precision). Only what the benchmark's configurations use is here: two
coding passes and k = 0, so one bitplane group, the `_0` files.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np

NEUTRAL_PROBABILITY = 64


@dataclass(frozen=True)
class LUTParams:
    """The table dimensions of header.txt."""

    n_bitplanes: int = 15
    n_subbands: int = 3
    ctx_refinement: int = 1
    ctx_sign: int = 4
    ctx_significance: int = 9
    mult_precision: int = 7
    n_files: int = 3                 # 1 = shared, 3 = one per R, G, B
    n_bitplane_files: int = 15

    def section_size(self, n_ctx: int, wavelet_levels: int) -> int:
        """Ints in one section: every (level, subband) group and the LL."""
        return (self.n_subbands * self.n_bitplanes * n_ctx * wavelet_levels
                + self.n_bitplanes * n_ctx)

    def section_offsets(self, wavelet_levels: int) -> dict[str, int]:
        sig = self.section_size(self.ctx_refinement, wavelet_levels)
        sign = sig + self.section_size(self.ctx_significance, wavelet_levels)
        return {"ref": 0, "sig": sig, "sign": sign}


_HEADER_KEYS = {
    "LUT_N_BITPLANES": "n_bitplanes",
    "LUT_N_SUBBANDS": "n_subbands",
    "N_CONTEXT_REFINEMENT": "ctx_refinement",
    "N_CONTEXT_SIGN": "ctx_sign",
    "N_CONTEXT_SIGNIFICANCE": "ctx_significance",
    "MULT_PRECISION": "mult_precision",
    "LUT_N_FILES": "n_files",
    "AMOUNT_OF_BITPLANE_FILES": "n_bitplane_files",
}

_RECORD = re.compile(r"^\s*(\d+)\s+(\d+)\s+(\d+)\s*:\s*(.*)$")
_SUFFIX = {0: ".txt_0", 1: "R.txt_0", 2: "G.txt_0", 3: "B.txt_0"}


def parse_header(path: str) -> LUTParams:
    """header.txt's KEY;VALUE lines; the bitplane-file count is capped
    at 32."""
    values = {}
    with open(path) as f:
        for line in f:
            key, sep, val = line.strip().partition(";")
            if sep and key in _HEADER_KEYS:
                values[_HEADER_KEYS[key]] = int(val)
    if values.get("n_bitplane_files", 0) > 32:
        values["n_bitplane_files"] = 32
    return LUTParams(**values)


def _section(path: str, params: LUTParams, levels: int,
             n_ctx: int) -> np.ndarray:
    """One section file as its dense table. Groups are (level, subband)
    pairs in file order, ending with the residual LL (levels, 0); reading
    stops at a record past that group. A missing file is all neutral."""
    out = np.full((levels * params.n_subbands + 1, params.n_bitplanes, n_ctx),
                  NEUTRAL_PROBABILITY, dtype=np.int32)
    if not os.path.exists(path):
        return out.reshape(-1)
    with open(path) as f:
        for line in f:
            m = _RECORD.match(line)
            if not m:
                continue
            level, subband, plane = (int(m.group(i)) for i in (1, 2, 3))
            if level + 1 > levels and subband > 0:
                break
            if level == levels and subband == 0:
                group = levels * params.n_subbands
            elif level < levels and subband < params.n_subbands:
                group = level * params.n_subbands + subband
            else:
                continue
            if plane >= params.n_bitplanes:
                continue
            vals = [int(v) for v in m.group(4).split()][:n_ctx]
            out[group, plane, :len(vals)] = vals
    return out.reshape(-1)


def load_luts(folder: str, levels: int) -> tuple[list[np.ndarray], LUTParams]:
    """One flat int32 table a channel (one shared table when LUT_N_FILES
    is 1), for two coding passes and k = 0."""
    params = parse_header(os.path.join(folder, "header.txt"))
    channels = [0] if params.n_files == 1 else [1, 2, 3]
    stems = (("ref", params.ctx_refinement), ("sig", params.ctx_significance),
             ("sign", params.ctx_sign))
    luts = [np.concatenate([
        _section(os.path.join(folder, stem + _SUFFIX[ch]), params, levels, n)
        for stem, n in stems]) for ch in channels]
    return luts, params


def group_base(params: LUTParams, level: int, subband: int,
               n_ctx: int) -> int:
    """Offset of a (level, subband) group within a section; the residual
    LL (level == wavelet_levels, subband 0) lands on the trailing block."""
    return (level * params.n_subbands * params.n_bitplanes * n_ctx
            + subband * params.n_bitplanes * n_ctx)
