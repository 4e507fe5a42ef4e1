"""Codeblock geometry: the per-codeblock bands (host NumPy) and the tiling
of a plane (torch reshapes).

Codeblocks are in row-major warpID order (warpID = y_block * nWarpsX +
x_block, BPCEngine.cu:1974-1979): codeblock i sits at block row
i // nWarpsX, block column i % nWarpsX. Each codeblock's decomposition
level and subband follow findSubband (BPCEngine.cu:143-170).
"""

from __future__ import annotations

import numpy as np
import torch

from . import spec

_CH, _CW = spec.CBLOCK_LENGTH, spec.CBLOCK_WIDTH


def find_subband(cb_x: int, cb_y: int, width: int, height: int,
                 wavelet_levels: int) -> tuple[int, int]:
    """Level and subband (HL 0, LH 1, HH 2) of the codeblock at pixel
    (cb_x, cb_y); the residual LL is (wavelet_levels, 0)."""
    for aux in range(1, wavelet_levels + 1):
        in_right = cb_x >= (width >> aux)
        in_bottom = cb_y >= (height >> aux)
        if in_right:
            return aux - 1, spec.SUBBAND_HH if in_bottom else spec.SUBBAND_HL
        if in_bottom:
            return aux - 1, spec.SUBBAND_LH
    return wavelet_levels, 0


def codeblock_bands(adapted_w: int, adapted_h: int,
                    wavelet_levels: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-codeblock (level, subband) int32 vectors in warpID order."""
    by, bx = adapted_h // _CH, adapted_w // _CW
    bands = [find_subband(xb * _CW, yb * _CH, adapted_w, adapted_h,
                          wavelet_levels)
             for yb in range(by) for xb in range(bx)]
    arr = np.array(bands, dtype=np.int32).reshape(by * bx, 2)
    return arr[:, 0].copy(), arr[:, 1].copy()


def plane_to_codeblocks(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., ncb, 64, 64) in warpID order."""
    *lead, h, w = plane.shape
    by, bx = h // _CH, w // _CW
    return (plane.reshape(*lead, by, _CH, bx, _CW).transpose(-3, -2)
            .reshape(*lead, by * bx, _CH, _CW))


def codeblocks_to_plane(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., ncb, 64, 64) in warpID order -> (..., H, W)."""
    lead = blocks.shape[:-3]
    by, bx = h // _CH, w // _CW
    return (blocks.reshape(*lead, by, bx, _CH, _CW).transpose(-3, -2)
            .reshape(*lead, h, w))
