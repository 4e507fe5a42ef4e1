"""The codestream header: 9 x 16-bit words, bit-exact layout.

The encoder packs 16 configuration fields into 9 unsigned shorts at the
head of the codestream (BitStreamBuilder.cpp:35-94); the decoder recovers
them without any command-line input (DecodingEngine.cu:567-585). The wire
layout keeps the reference's representational limits: wavelet_levels is
recoverable for 0..7 only, components for 0..127 only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HEADER_SHORTS = 9


@dataclass(frozen=True)
class CodecConfig:
    """All side information carried by the codestream header."""

    width: int                  # image width (pre-padding)
    height: int                 # image height (pre-padding)
    components: int = 1
    coding_passes: int = 2      # 2 (SPP+MRP) or 3 (CP+SPP+MRP)
    cb_height: int = 18         # DWT warp-work height knob (format-carried)
    cb_width: int = 64          # DWT tile width knob (format-carried)
    wavelet_levels: int = 5
    bit_depth: int = 8
    is_lossy: bool = False      # False = 5/3 reversible, True = 9/7
    qs: float = 1.0             # quantization size in [0, 1]
    is_rgb: bool = False
    endianess: int = 0
    bps: int = 8                # bits per sample
    is_signed: bool = False
    frames: int = 0
    k_factor: float = 0.0       # complexity-scalability knob

    # The reference truncates ((int)(qs*10000), BitStreamBuilder.cpp:66);
    # rounding to nearest makes pack/unpack a stable fixed point.
    @property
    def qs_int(self) -> int:
        return int(round(self.qs * 10000))

    @property
    def k_int(self) -> int:
        return int(round(self.k_factor * 1000))


def pack_header(cfg: CodecConfig) -> np.ndarray:
    """A CodecConfig as the 9-short wire header (setExtraInformation,
    BitStreamBuilder.cpp:35-94). The size stored is width * height *
    components; the height is stored too, so the decoder recovers the
    width as size / height."""
    size = cfg.width * cfg.height * cfg.components
    qs_int = cfg.qs_int

    h = np.zeros(HEADER_SHORTS, dtype=np.uint16)
    h[0] = size & 0xFFFF
    h[1] = (size >> 16) & 0xFFFF

    w2 = 1 if cfg.coding_passes == 3 else 0
    w2 |= (cfg.cb_height & 0x7F) << 1
    w2 |= (cfg.cb_width & 0x7F) << 8
    w2 |= (cfg.wavelet_levels & 1) << 15
    h[2] = w2

    w3 = (cfg.wavelet_levels & 7) >> 1
    w3 |= (cfg.bit_depth & 0x7F) << 3
    w3 |= (1 if cfg.is_lossy else 0) << 10
    w3 |= (qs_int & 31) << 11
    h[3] = w3

    w4 = (qs_int >> 5) & 0x1FF
    w4 |= (cfg.components & 0x7F) << 9
    h[4] = w4

    w5 = (cfg.components >> 7) & 0x7F
    w5 |= (1 if cfg.is_rgb else 0) << 7
    w5 |= (cfg.height & 0xFF) << 8
    h[5] = w5

    w6 = (cfg.height >> 8) & 0xFF
    w6 |= (cfg.endianess & 1) << 8
    w6 |= (cfg.bps & 0x1F) << 9
    w6 |= (1 if cfg.is_signed else 0) << 14
    w6 |= (cfg.frames & 1) << 15
    h[6] = w6

    h[7] = (cfg.frames >> 1) & 0xFFFF
    h[8] = cfg.k_int & 0xFFFF
    return h


def unpack_header(shorts: np.ndarray) -> CodecConfig:
    """A CodecConfig from the wire header (getExtraInformation,
    DecodingEngine.cu:567-585, and the geometry of DecodingEngine::initMemory,
    :38-57, 146-160)."""
    s = [int(x) for x in np.asarray(shorts, dtype=np.uint16)[:HEADER_SHORTS]]

    size = s[0] | (s[1] << 16)
    coding_passes = 3 if (s[2] & 1) == 1 else 2
    cb_height = (s[2] >> 1) & 0x7F
    cb_width = (s[2] >> 8) & 0x7F
    wavelet_levels = ((s[2] >> 15) & 1) | ((s[3] & 7) << 1)
    bit_depth = (s[3] >> 3) & 0x7F
    is_lossy = ((s[3] >> 10) & 1) == 1
    qs_int = ((s[3] >> 11) & 31) | ((s[4] & 0x1FF) << 5)
    components = ((s[4] >> 9) & 0x7F) | ((s[5] & 0x7F) << 9)
    is_rgb = ((s[5] >> 7) & 1) == 1
    height = ((s[5] >> 8) & 0xFF) | ((s[6] & 0xFF) << 8)
    endianess = (s[6] >> 8) & 1
    bps = (s[6] >> 9) & 0x1F
    is_signed = ((s[6] >> 14) & 1) == 1
    frames = ((s[6] >> 15) & 1) | (s[7] << 1)
    k_int = s[8]

    # width = size / height, then the component count divided out
    # (DecodingEngine.cu:146)
    wc = size // height if height else 0
    components = max(components, 1)
    width = wc // components

    return CodecConfig(
        width=width,
        height=height,
        components=components,
        coding_passes=coding_passes,
        cb_height=cb_height,
        cb_width=cb_width,
        wavelet_levels=wavelet_levels,
        bit_depth=bit_depth,
        is_lossy=is_lossy,
        qs=qs_int / 10000.0,
        is_rgb=is_rgb,
        endianess=endianess,
        bps=bps,
        is_signed=is_signed,
        frames=frames,
        k_factor=k_int / 1000.0,
    )
