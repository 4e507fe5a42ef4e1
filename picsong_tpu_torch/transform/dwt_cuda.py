"""The device path's transform layers, X2 and X4: CPU tensors take the
plain PyTorch version, CUDA tensors take the hand-written kernels,
anything else raises.

X2, `forward`: sample planes -> per component the quantized 64x64
codeblocks (int32, in warpID order) and their coefficient maximum. DC
shift, then the RCT (int32) or ICT (float32) of RGB samples, the
multi-level lifting DWT (5/3 int32 or 9/7 float32, `transform/dwt.py`),
each 9/7 subband times its gain * qs truncated to int32 (the final LL too,
the intermediate ones not), the Mallat mosaic cut into codeblocks.
Counterpart of `picsong_tpu.engine.pipeline.TPUCodec._prep_gray_impl` /
`_prep_rgb_impl` + `_dwt_tile_impl` (`picsong_tpu/transform/dwt.py:157`
`dwt_forward`, `core/geometry.py:48`).

X4, `reverse`: the codeblocks -> sample planes. Untiling, midpoint
dequantization, inverse lifting, the inverse RCT or ICT, rounding, DC
shift and clamp to the sample type. Counterpart of `_untile_idwt_impl` +
`_finish_gray_impl` / `_finish_rgb_impl` (`picsong_tpu/transform/dwt.py:187`
`dwt_reverse`, `core/geometry.py:57`).

Samples are one gray or three RGB (..., ah, aw) planes (ah, aw the
adapted size of the configuration), with no leading dimension (an image)
or one (a batch of frames); three planes of one (B, 3, ah, aw) tensor are
taken as they lie, with their strides. On CUDA the kernels
(`csrc/dwt_forward.cu`, `csrc/dwt_reverse.cu`) launch one grid per level on
the current stream of the tensors' device, under that device, without
synchronising; there is no path from a CUDA tensor to the plain version.
`FORWARD_LAUNCHES` / `REVERSE_LAUNCHES` count the calls that launched them.

The plain version is the arithmetic contract: the 9/7 lifting rounds once
per JAX op, and the ICT is the oracle's FMA chain (`fma_row`); the kernels
compute the same with explicit round-to-nearest intrinsics, and divide by
a constant exactly through its float32 `reciprocal` (csrc/dwt_common.cuh
`div_rn`), so both give the same bytes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from ..core import spec
from ..core.geometry import codeblocks_to_plane, plane_to_codeblocks
from ..core.header import CodecConfig
from ..entropy.bpc_cuda import BYTES_PER_S, INT32_OPS_PER_S
from . import dwt

FORWARD_LAUNCHES = 0
REVERSE_LAUNCHES = 0

# the kernels' tiling (csrc/dwt_common.cuh kTile, Tile<lossy>::kHalo): a
# CTA lifts a TILE x TILE tile of a level's plane with HALO[lossy]
# neighbouring samples on each side
TILE = 64
HALO = {False: 2, True: 4}
# the kernels' work split (csrc/dwt_common.cuh kStrip): a thread lifts
# STRIP positions of a column, then of a row (X2; X4 a row, then a
# column), plus HALO each side. X2's tile arrays in shared memory start
# X2_PAD rows and columns before the tile (dwt_forward.cu kPad); X4 reads
# a tile's band rows in chunks of 4 words from X4_LEAD words before the
# tile's band columns and stages X4_STAGE_COLS of them from 2 before
# (dwt_reverse.cu kLead, kStageCols)
STRIP = 16
X2_PAD = 4
X4_LEAD = 4
X4_STAGE_COLS = 36
# the bytes of a vector load: X2 reads level 0 in 16-byte chunks where the
# sample planes allow it (`vector_loads`), X4 its codeblocks where their
# bases allow it (`vector_block_loads`)
VECTOR_BYTES = 16

# the H100 SXM's float32 rate outside the tensor cores
FLOAT32_OPS_PER_S = 67e12
# operations of the lifting a sample costs at one level, both passes (the
# kernels' own arithmetic): 5/3 a predict (3 int32 ops) or an update (4)
# per pass; 9/7 four steps of 3 float32 ops on half the samples and one
# scaling per pass
OPS_PER_SAMPLE_LEVEL = {False: 7, True: 14}

# the kernels' sample types, as the C entry points take them
_SAMPLE_TYPES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2,
                 torch.int16: 3}

# the reference's float -> int reconstruction, __float2int_rn(x + 0.01f)
# (DecodingEngine.cu:640-642, 706-715)
_ROUND_BIAS = float(np.float32(0.01))


def reset_launches() -> None:
    global FORWARD_LAUNCHES, REVERSE_LAUNCHES
    FORWARD_LAUNCHES = REVERSE_LAUNCHES = 0


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------

def offset(cfg: CodecConfig) -> int:
    """The DC shift of unsigned samples."""
    return 0 if cfg.is_signed else (1 << (cfg.bit_depth - 1))


def sample_range(cfg: CodecConfig) -> tuple[int, int]:
    """Reconstruction clamp range from bit depth and signedness."""
    if cfg.is_signed:
        return -(1 << (cfg.bit_depth - 1)), (1 << (cfg.bit_depth - 1)) - 1
    return 0, (1 << cfg.bit_depth) - 1


def sample_dtype(cfg: CodecConfig) -> torch.dtype:
    """Decoded sample type (TPUCodec's _jnp_sample_dtype)."""
    if cfg.bps <= 8:
        return torch.int8 if cfg.is_signed else torch.uint8
    return torch.int16 if cfg.is_signed else torch.uint16


def _add_round_to_odd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y (float64) rounded to odd: the exact sum when it is a float64,
    else its neighbour whose last bit is 1. TwoSum gives the rounding
    error; where it is nonzero and the nearest sum's last bit is 0, step
    one ulp toward the error. A later rounding to float32 (24 bits, 29
    fewer) then rounds the exact sum once."""
    s = x + y
    v = s - x
    err = (x - (s - v)) + (y - v)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s)


def fma_row(m_row, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """fma(m2, c, fma(m1, b, m0 * a)) in float32, each fma rounded once:
    the NumPy oracle's color transform (`reference/codec.py` ict_forward /
    ict_inverse, a float32 `tensordot` that an FMA-contracting BLAS such as
    OpenBLAS's sgemm computes as this chain; a BLAS that does not contract
    gives other bytes), and the kernels' `__fmaf_rn` chain. The product of
    two float32 values is exact in float64, and the float64 sum rounded to
    odd rounds to the fused result when cast to float32."""
    acc = a * float(m_row[0])
    for m, x in ((m_row[1], b), (m_row[2], c)):
        acc = _add_round_to_odd(x.double() * float(m), acc.double()).float()
    return acc


def prep(samples: list[torch.Tensor], cfg: CodecConfig) -> list[torch.Tensor]:
    """Sample planes (one gray or [R, G, B]) -> component planes: DC level
    shift (offsetImage, CodingEngine.cu:581-588), then RCT in int32 or ICT
    in float32 as the oracle rounds it (CodingEngine.cu:357-403); float32
    for the 9/7 path."""
    shifted = [x.to(torch.int32) - offset(cfg) for x in samples]
    if not cfg.is_rgb:
        return [shifted[0].to(torch.float32) if cfg.is_lossy else shifted[0]]
    ri, gi, bi = shifted
    if cfg.is_lossy:
        rf, gf, bf = (x.to(torch.float32) for x in (ri, gi, bi))
        return [fma_row(row, rf, gf, bf) for row in spec.ICT_FORWARD]
    return [(ri + 2 * gi + bi) >> 2, bi - gi, ri - gi]


def finish(comps: list[torch.Tensor], cfg: CodecConfig) -> list[torch.Tensor]:
    """Reconstructed component planes -> sample planes: inverse color
    transform, DC shift and clamp (removeOffsetAndApplyMaxMin[Lossy],
    DecodingEngine.cu:599-650, 706-729); torch.round is half-to-even like
    jnp.rint. Gray lossy rounds after the shift, RGB lossy before it."""
    mn, mx = sample_range(cfg)
    out = sample_dtype(cfg)
    off = offset(cfg)
    if not cfg.is_rgb:
        plane = comps[0]
        if cfg.is_lossy:
            vals = torch.round(plane + float(off) + _ROUND_BIAS)
        else:
            vals = plane + off
        return [torch.clamp(vals, mn, mx).to(out)]
    if cfg.is_lossy:
        r, g, b = (torch.round(fma_row(row, *comps) + _ROUND_BIAS)
                   .to(torch.int32) for row in spec.ICT_BACKWARD)
    else:
        y, u, v = (c.to(torch.int32) for c in comps)
        g = y - ((u + v) >> 2)
        r, b = v + g, u + g
    return [torch.clamp(c + off, mn, mx).to(out) for c in (r, g, b)]


def forward_plain(samples: list[torch.Tensor], cfg: CodecConfig):
    """X2 as torch ops: prep, DWT (+ quantization, truncated to int32),
    codeblock tiling -> ([blocks (..., ncb, 64, 64) int32 per component],
    0-dim int32 maximum of |coefficient| over all of them)."""
    blocks = [plane_to_codeblocks(dwt.dwt_forward(
        c, cfg.wavelet_levels, cfg.is_lossy, cfg.qs).to(torch.int32))
        .contiguous() for c in prep(samples, cfg)]
    return blocks, torch.stack([b.abs().amax() for b in blocks]).amax()


def reverse_plain(blocks: list[torch.Tensor],
                  cfg: CodecConfig) -> list[torch.Tensor]:
    """X4 as torch ops: per component (..., ncb, 64, 64) int32 codeblocks
    -> untiling, inverse DWT, finish -> the (..., ah, aw) sample planes."""
    aw, ah = spec.adapted_size(cfg.width, cfg.height)
    return finish([dwt.dwt_reverse(codeblocks_to_plane(b, ah, aw),
                                   cfg.wavelet_levels, cfg.is_lossy, cfg.qs)
                   for b in blocks], cfg)


# --------------------------------------------------------------------------
# The kernels
# --------------------------------------------------------------------------

def _device_type(tensors: list[torch.Tensor], what: str) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what} inputs are on several devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} implementation for device {dev}")
    return dev.type


def _n_components(cfg: CodecConfig, got: int, what: str) -> int:
    want = 3 if cfg.is_rgb else 1
    if got != want:
        raise ValueError(f"expected {want} {what}, got {got}")
    return want


def _geometry(cfg: CodecConfig) -> tuple[int, int]:
    """The adapted plane (ah, aw), checked against the levels."""
    aw, ah = spec.adapted_size(cfg.width, cfg.height)
    dwt._check((ah, aw), cfg.wavelet_levels)
    if cfg.wavelet_levels > len(spec.WAVELET_QSTEPS):
        raise ValueError(f"at most {len(spec.WAVELET_QSTEPS)} wavelet "
                         f"levels, got {cfg.wavelet_levels}")
    return ah, aw


def reciprocal(x) -> np.float32:
    """1 / x in float32, rounded once: the kernels' `div_rn` divides by x
    through it."""
    return np.float32(1) / np.float32(x)


@functools.lru_cache(maxsize=None)
def _constants(levels: int, qs: float, forward: bool):
    """The float32 constants the kernels read, bit for bit from
    `core/spec.py`: the lifting steps, the reconstruction factor, the
    rounding bias, qs, the reciprocals of K1, K2 and qs, the ICT matrix of
    the direction and per level the four gains (LL, HL, LH, HH) -- times
    qs on the way forward, a numpy float32 product as in
    `dwt.quantize_level` -- and their reciprocals. The C entry points copy
    them into each launch's arguments (csrc/dwt_common.cuh
    level_consts)."""
    qs32 = np.float32(qs)
    gains = spec.WAVELET_QSTEPS[:levels].astype(np.float32)
    gains = gains * qs32 if forward else gains
    vals = np.concatenate([
        [spec.I97_ALPHA, spec.I97_BETA, spec.I97_GAMMA, spec.I97_DELTA,
         spec.I97_K1, spec.I97_K2, spec.RECONSTRUCTION_FACTOR,
         np.float32(_ROUND_BIAS), qs32, reciprocal(spec.I97_K1),
         reciprocal(spec.I97_K2), reciprocal(qs32)],
        (spec.ICT_FORWARD if forward else spec.ICT_BACKWARD).ravel(),
        np.concatenate([gains, reciprocal(1) / gains], axis=1).ravel(),
    ]).astype(np.float32)
    return (ctypes.c_float * vals.size)(*vals.tolist())


def _scratch(planes: int, ah: int, aw: int, levels: int,
             device) -> torch.Tensor:
    """The intermediate LL planes of both directions: two buffers used in
    turn, the first a quarter of the plane, the second a sixteenth."""
    n = planes * (ah * aw // 4 + ah * aw // 16) if levels > 1 else 1
    return torch.empty(n, dtype=torch.int32, device=device)


def _lead(shape, tail: tuple, what: str) -> tuple:
    """The leading dimensions of `shape` before `tail`: none or one."""
    shape = tuple(shape)
    if len(shape) not in (len(tail), len(tail) + 1) or \
            shape[len(shape) - len(tail):] != tail:
        raise ValueError(f"{what} must have shape {tail} or (B, *{tail}), "
                         f"got {shape}")
    return shape[:len(shape) - len(tail)]


def _check_samples(samples: list[torch.Tensor], cfg: CodecConfig):
    """The sample planes' (leading shape, ah, aw); raises on what the
    kernels do not take."""
    ah, aw = _geometry(cfg)
    first = samples[0]
    lead = _lead(first.shape, (ah, aw), "samples")
    for s in samples:
        if s.dtype not in _SAMPLE_TYPES:
            raise TypeError(f"samples must be uint8, int8, uint16 or int16, "
                            f"got {s.dtype}")
        if (s.dtype, s.shape, s.stride()) != (first.dtype, first.shape,
                                              first.stride()):
            raise ValueError("the sample planes differ in type, shape or "
                             "strides")
    if first.stride(-1) != 1 or first.stride(-2) < aw:
        raise ValueError(f"sample rows must be contiguous, got strides "
                         f"{first.stride()}")
    return lead, ah, aw


def vector_loads(samples: list[torch.Tensor]) -> bool:
    """Whether X2 may read these sample planes in 16-byte chunks: every
    plane's first sample, its row stride and its frame stride (a batch)
    fall on multiples of VECTOR_BYTES. Otherwise (an offset view, an odd
    stride) the same kernel reads a sample at a time."""
    first = samples[0]
    size = first.element_size()
    strides = first.stride()[:-1]
    return (all(s.data_ptr() % VECTOR_BYTES == 0 for s in samples)
            and all(st * size % VECTOR_BYTES == 0 for st in strides))


def vector_block_loads(blocks: list[torch.Tensor]) -> bool:
    """Whether X4 may read these (contiguous) codeblocks in 16-byte chunks:
    every component's first word falls on a multiple of VECTOR_BYTES (a
    frame's codeblocks are 4096 words apart). Otherwise (an offset view)
    the same kernel reads a word at a time; it does so too at a level whose
    bands are not a multiple of 4 words wide."""
    return all(b.data_ptr() % VECTOR_BYTES == 0 for b in blocks)


def forward(samples: list[torch.Tensor], cfg: CodecConfig, lib=None):
    """X2: one gray or [R, G, B] (..., ah, aw) sample planes -> ([blocks
    (..., ncb, 64, 64) int32 per component], 0-dim int32 maximum of
    |coefficient| over all components). `lib` is the kernel library to
    launch (default: the package's own)."""
    global FORWARD_LAUNCHES
    nc = _n_components(cfg, len(samples), "sample planes")
    device = _device_type(samples, "X2")
    lead, ah, aw = _check_samples(samples, cfg)
    if device == "cpu":
        return forward_plain(samples, cfg)
    first = samples[0]
    batch = lead[0] if lead else 1
    ncb = (ah // spec.CBLOCK_LENGTH) * (aw // spec.CBLOCK_WIDTH)
    dev = first.device
    blocks = torch.empty((nc, *lead, ncb, spec.CBLOCK_LENGTH,
                          spec.CBLOCK_WIDTH), dtype=torch.int32, device=dev)
    top = torch.empty((), dtype=torch.int32, device=dev)
    scratch = _scratch(nc * batch, ah, aw, cfg.wavelet_levels, dev)
    consts = _constants(cfg.wavelet_levels, cfg.qs, True)
    ptrs = [s.data_ptr() for s in samples] + [None] * (3 - nc)
    lib = lib or kernels.library()
    with torch.cuda.device(dev):
        rc = lib.picsong_dwt_forward(
            *ptrs, _SAMPLE_TYPES[first.dtype], int(vector_loads(samples)),
            first.stride(0) if lead else 0, first.stride(-2), batch, nc, ah,
            aw, cfg.wavelet_levels, int(cfg.is_lossy), offset(cfg),
            ctypes.addressof(consts), scratch.data_ptr(), blocks.data_ptr(),
            top.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    FORWARD_LAUNCHES += 1
    kernels.check(lib, rc, "dwt_forward launch")
    return list(blocks.unbind(0)), top


def _check_blocks(blocks: list[torch.Tensor], cfg: CodecConfig):
    """The codeblocks' (leading shape, ah, aw); raises on what the kernels
    do not take."""
    ah, aw = _geometry(cfg)
    ncb = (ah // spec.CBLOCK_LENGTH) * (aw // spec.CBLOCK_WIDTH)
    lead = _lead(blocks[0].shape, (ncb, spec.CBLOCK_LENGTH,
                                   spec.CBLOCK_WIDTH), "codeblocks")
    for b in blocks:
        if b.dtype != torch.int32:
            raise TypeError(f"codeblocks must be int32, got {b.dtype}")
        if b.shape != blocks[0].shape:
            raise ValueError("the components' codeblocks differ in shape")
        if not b.is_contiguous():
            raise ValueError("codeblocks must be contiguous")
    return lead, ah, aw


def reverse(blocks: list[torch.Tensor], cfg: CodecConfig,
            lib=None) -> list[torch.Tensor]:
    """X4: per component the (..., ncb, 64, 64) int32 codeblocks -> one gray
    or [R, G, B] (..., ah, aw) sample planes of the configuration's sample
    type. `lib` as in `forward`."""
    global REVERSE_LAUNCHES
    nc = _n_components(cfg, len(blocks), "codeblock tensors")
    device = _device_type(blocks, "X4")
    lead, ah, aw = _check_blocks(blocks, cfg)
    if device == "cpu":
        return reverse_plain(blocks, cfg)
    batch = lead[0] if lead else 1
    dev = blocks[0].device
    out = torch.empty((*lead, nc, ah, aw), dtype=sample_dtype(cfg),
                      device=dev)
    scratch = _scratch(nc * batch, ah, aw, cfg.wavelet_levels, dev)
    consts = _constants(cfg.wavelet_levels, cfg.qs, False)
    mn, mx = sample_range(cfg)
    ptrs = [b.data_ptr() for b in blocks] + [None] * (3 - nc)
    lib = lib or kernels.library()
    with torch.cuda.device(dev):
        rc = lib.picsong_dwt_reverse(
            *ptrs, int(vector_block_loads(blocks)), batch, nc, ah, aw,
            cfg.wavelet_levels, int(cfg.is_lossy), offset(cfg), mn, mx,
            _SAMPLE_TYPES[out.dtype],
            ctypes.addressof(consts), scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    REVERSE_LAUNCHES += 1
    kernels.check(lib, rc, "dwt_reverse launch")
    return list(out.unbind(-3))


def bound_ms(samples: list[torch.Tensor], cfg: CodecConfig) -> tuple[float, str]:
    """The least time an H100 could take for X2 (or X4) on these sample
    planes, and what bounds it: the larger of the bytes (the samples read
    once, the int32 codeblocks written once; the reverse for X4) over the
    memory rate and the lifting's operations (OPS_PER_SAMPLE_LEVEL on each
    level's plane) over the int32 (5/3) or float32 (9/7) rate. The kernels'
    traffic of the intermediate LL planes and the tiles' halos is their
    design's cost, not part of the bound."""
    n = sum(s.numel() for s in samples)
    bytes_s = sum(s.numel() * (s.element_size() + 4)
                  for s in samples) / BYTES_PER_S
    planes = sum(n / 4 ** level for level in range(cfg.wavelet_levels))
    rate = FLOAT32_OPS_PER_S if cfg.is_lossy else INT32_OPS_PER_S
    ops_s = planes * OPS_PER_SAMPLE_LEVEL[cfg.is_lossy] / rate
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s > bytes_s else "bytes")
