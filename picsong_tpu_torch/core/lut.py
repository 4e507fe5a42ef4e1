"""Stationary context-probability LUTs for BPC-PaCo.

Parses the reference's on-disk LUT folders (IO/IOManager.ipp:363-386,
404-612; Engines/Engine.cu:8-210) into flat int32 arrays with the layout
the coder indexes (BPC/BPCEngine.cu:329-358):

  per bitplane-group s:  [ ref | sig | sign (| cp_sig | cp_sign) ]
  each section:          [level][subband][bitplane][ctx]  (level-major)
                         + one trailing [bitplane][ctx] block for the
                           residual LL band (level == wavelet_levels)

A folder holds `header.txt` (KEY;VALUE lines) and one text file per
section, channel and bitplane group, `{ref,sig,sign}[R|G|B].txt_<s>` (and
`cp_{sig,sign}...` for three coding passes), of records
"wLevel subband bitplane : p ...". Bitplanes absent from a file keep the
neutral probability 64 (0.5 at 7-bit precision, IOManager.ipp:457,482,517).
The shipped tables are the data files under `luts/` at the repository
root.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np

NEUTRAL_PROBABILITY = 64


@dataclass(frozen=True)
class LUTParams:
    """LUT dimensions from header.txt plus the derived section geometry."""

    n_bitplanes: int = 15
    n_subbands: int = 3
    ctx_refinement: int = 1
    ctx_sign: int = 4
    ctx_significance: int = 9
    mult_precision: int = 7
    n_files: int = 3                 # 1 = shared, 3 = per-channel R/G/B
    n_bitplane_files: int = 15       # bitplane-group files for -k

    def section_size(self, n_ctx: int, wavelet_levels: int) -> int:
        """Ints in one section: all (level, subband) groups + the LL block."""
        return (self.n_subbands * self.n_bitplanes * n_ctx * wavelet_levels
                + self.n_bitplanes * n_ctx)

    def size_per_group(self, wavelet_levels: int, coding_passes: int) -> int:
        """Ints per bitplane group (BPCEngine.cu:1959), the two cleanup-pass
        sections included with three coding passes (Engine.cu:65-67)."""
        base = self.stride_per_group(wavelet_levels)
        if coding_passes == 3:
            base += (self.section_size(self.ctx_significance, wavelet_levels)
                     + self.section_size(self.ctx_sign, wavelet_levels))
        return base

    def stride_per_group(self, wavelet_levels: int) -> int:
        """The group stride of the coder's addressing: three sections only,
        whatever the coding passes (BPCEngine.cu:1744-1748)."""
        return (self.section_size(self.ctx_refinement, wavelet_levels)
                + self.section_size(self.ctx_significance, wavelet_levels)
                + self.section_size(self.ctx_sign, wavelet_levels))

    def section_offsets(self, wavelet_levels: int, coding_passes: int):
        """Start offsets of the (ref, sig, sign[, cp_sig, cp_sign])
        sections."""
        ref = 0
        sig = ref + self.section_size(self.ctx_refinement, wavelet_levels)
        sign = sig + self.section_size(self.ctx_significance, wavelet_levels)
        out = {"ref": ref, "sig": sig, "sign": sign}
        if coding_passes == 3:
            out["cp_sig"] = sign + self.section_size(self.ctx_sign,
                                                     wavelet_levels)
            out["cp_sign"] = out["cp_sig"] + self.section_size(
                self.ctx_significance, wavelet_levels)
        return out


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


def parse_lut_header(path: str) -> LUTParams:
    """header.txt's KEY;VALUE lines (IOManager.ipp:363-386); the
    bitplane-file count is capped at 32 (Engine.cu:204-208)."""
    values = {}
    with open(path, "r") as f:
        for line in f:
            key, sep, val = line.strip().partition(";")
            if sep and key in _HEADER_KEYS:
                values[_HEADER_KEYS[key]] = int(val)
    if values.get("n_bitplane_files", 0) > 32:
        values["n_bitplane_files"] = 32
    return LUTParams(**values)


_RECORD_RE = re.compile(r"^\s*(\d+)\s+(\d+)\s+(\d+)\s*:\s*(.*)$")


def _parse_section_file(path: str, params: LUTParams, wavelet_levels: int,
                        n_ctx: int) -> np.ndarray:
    """One ref/sig/sign file as its dense section. Groups are (level,
    subband) pairs in file order, ending with the residual LL (wavelet_levels,
    0); reading stops at a record beyond that group (IOManager.ipp:460-461).
    A missing file is all neutral."""
    n_groups = wavelet_levels * params.n_subbands + 1
    out = np.full((n_groups, params.n_bitplanes, n_ctx),
                  NEUTRAL_PROBABILITY, dtype=np.int32)
    if not os.path.exists(path):
        return out.reshape(-1)
    with open(path, "r") as f:
        for line in f:
            m = _RECORD_RE.match(line)
            if not m:
                continue
            level, subband, bitplane = (int(m.group(i)) for i in (1, 2, 3))
            if (level + 1) > wavelet_levels and subband > 0:
                break
            if level == wavelet_levels and subband == 0:
                group = wavelet_levels * params.n_subbands
            elif level < wavelet_levels and subband < params.n_subbands:
                group = level * params.n_subbands + subband
            else:
                continue
            if bitplane >= params.n_bitplanes:
                continue
            vals = [int(v) for v in m.group(4).split()][:n_ctx]
            out[group, bitplane, :len(vals)] = vals
    return out.reshape(-1)


_CHANNEL_SUFFIX = {0: ".txt_", 1: "R.txt_", 2: "G.txt_", 3: "B.txt_"}


def load_lut_channel(folder: str, params: LUTParams, wavelet_levels: int,
                     coding_passes: int, channel: int, s_index: int) -> np.ndarray:
    """One channel's table for one bitplane-group file index; `channel` 0
    is the shared suffix ".txt_", 1/2/3 are R/G/B (IOManager.ipp:433-444)."""
    suffix = _CHANNEL_SUFFIX[channel] + str(s_index)
    stems = [("ref", params.ctx_refinement), ("sig", params.ctx_significance),
             ("sign", params.ctx_sign)]
    if coding_passes == 3:
        stems += [("cp_sig", params.ctx_significance),
                  ("cp_sign", params.ctx_sign)]
    return np.concatenate([
        _parse_section_file(os.path.join(folder, stem + suffix), params,
                            wavelet_levels, n_ctx)
        for stem, n_ctx in stems])


def load_luts(folder: str, wavelet_levels: int, coding_passes: int,
              k_factor: float) -> tuple[list[np.ndarray], LUTParams]:
    """The LUT set of a run (Engine::initLUT, Engine.cu:8-185): one flat
    int32 array per channel (a single shared one when LUT_N_FILES is 1).
    With k > 0 every bitplane-group file is loaded, group-major; with
    k == 0 only the _0 files."""
    params = parse_lut_header(os.path.join(folder, "header.txt"))
    n_groups = params.n_bitplane_files if k_factor > 0 else 1
    channels = [0] if params.n_files == 1 else [1, 2, 3]
    luts = [np.concatenate([
        load_lut_channel(folder, params, wavelet_levels, coding_passes, ch, j)
        for j in range(n_groups)]) for ch in channels]
    return luts, params


def neutral_lut(params: LUTParams, wavelet_levels: int, coding_passes: int,
                n_groups: int = 1) -> np.ndarray:
    """An all-neutral table (p = 0.5): valid for coding, no context
    modelling."""
    size = params.size_per_group(wavelet_levels, coding_passes)
    return np.full(size * n_groups, NEUTRAL_PROBABILITY, dtype=np.int32)


def group_base(params: LUTParams, wavelet_levels: int, level: int,
               subband: int, n_ctx: int) -> int:
    """Offset of a (level, subband) group within a section
    (initializeLUTPointers, BPCEngine.cu:329-350); the residual LL
    (level == wavelet_levels, subband 0) lands on the trailing block."""
    return (level * params.n_subbands * params.n_bitplanes * n_ctx
            + subband * params.n_bitplanes * n_ctx)
