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

Their shard mode, `forward_shard` / `reverse_shard` (`dist/sharded.py`):
one level of one shard's rows of a taller plane, the same kernels' kShard
variants, one launch a call. X2 takes the shard's rows plus the halo rows
its neighbours lend it (the samples at level 0, with the prep; HALO rows a
side, none past the plane's top or bottom) and gives the level's four
bands as row-major band rows of the shard's interior; X4 takes the band
rows plus HALO / 2 rows a side and gives the interior rows of the next
level's plane (at level 0 the finish's samples). The edge rule fires only
at the plane's first and last row; the rows in between are counted from
the plane's top. Their plain version is the torch-op step of a level
(`transform/dwt.py` lift_vertical, lift_horizontal, quantize_level /
dequantize, unlift_horizontal, unlift_vertical) on the buffer, which keeps
the interior.

Samples are one gray or three RGB (..., ah, aw) planes (ah, aw the
adapted size of the configuration), with no leading dimension (an image)
or one (a batch of frames); three planes of one (B, 3, ah, aw) tensor are
taken as they lie, with their strides. On CUDA the kernels
(`csrc/dwt_forward.cu`, `csrc/dwt_reverse.cu`) launch one grid per level
through `kernels.launch`, on the current stream of the tensors' device,
without synchronising; there is no path from a CUDA tensor to the plain
version. `FORWARD_LAUNCHES` / `REVERSE_LAUNCHES` count the calls that
launched them (a shard-mode call is one).

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
from ..obs.trace import spanned
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

# operations of the lifting a sample costs at one level, both passes (the
# kernels' own arithmetic): 5/3 a predict (3 int32 ops) or an update (4)
# per pass; 9/7 four steps of 3 float32 ops on half the samples and one
# scaling per pass
OPS_PER_SAMPLE_LEVEL = {False: 7, True: 14}

# the kernels' sample types, as the C entry points take them; the shard
# mode's X2 also takes int32 (5/3) or float32 (9/7) values, with no prep
_SAMPLE_TYPES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2,
                 torch.int16: 3}
_VALUES = 4

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


@spanned("picsong/x2")
def forward(samples: list[torch.Tensor], cfg: CodecConfig):
    """X2: one gray or [R, G, B] (..., ah, aw) sample planes -> ([blocks
    (..., ncb, 64, 64) int32 per component], 0-dim int32 maximum of
    |coefficient| over all components)."""
    global FORWARD_LAUNCHES
    nc = _n_components(cfg, len(samples), "sample planes")
    device = kernels.device_type(samples, "X2")
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
    kernels.launch(
        "picsong_dwt_forward", dev, *ptrs, _SAMPLE_TYPES[first.dtype],
        int(vector_loads(samples)), first.stride(0) if lead else 0,
        first.stride(-2), batch, nc, ah, aw, cfg.wavelet_levels,
        int(cfg.is_lossy), offset(cfg), ctypes.addressof(consts),
        scratch.data_ptr(), blocks.data_ptr(), top.data_ptr(),
        what="dwt_forward launch")
    FORWARD_LAUNCHES += 1
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


@spanned("picsong/x4")
def reverse(blocks: list[torch.Tensor],
            cfg: CodecConfig) -> list[torch.Tensor]:
    """X4: per component the (..., ncb, 64, 64) int32 codeblocks -> one gray
    or [R, G, B] (..., ah, aw) sample planes of the configuration's sample
    type."""
    global REVERSE_LAUNCHES
    nc = _n_components(cfg, len(blocks), "codeblock tensors")
    device = kernels.device_type(blocks, "X4")
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
    kernels.launch(
        "picsong_dwt_reverse", dev, *ptrs, int(vector_block_loads(blocks)),
        batch, nc, ah, aw, cfg.wavelet_levels, int(cfg.is_lossy),
        offset(cfg), mn, mx, _SAMPLE_TYPES[out.dtype],
        ctypes.addressof(consts), scratch.data_ptr(), out.data_ptr(),
        what="dwt_reverse launch")
    REVERSE_LAUNCHES += 1
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
                  for s in samples) / kernels.BYTES_PER_S
    planes = sum(n / 4 ** level for level in range(cfg.wavelet_levels))
    rate = (kernels.FLOAT32_OPS_PER_S if cfg.is_lossy
            else kernels.INT32_OPS_PER_S)
    ops_s = planes * OPS_PER_SAMPLE_LEVEL[cfg.is_lossy] / rate
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s > bytes_s else "bytes")


# --------------------------------------------------------------------------
# The shard mode: one level of one shard's rows (dist/sharded.py)
# --------------------------------------------------------------------------

def _value_dtype(cfg: CodecConfig) -> torch.dtype:
    return torch.float32 if cfg.is_lossy else torch.int32


def _check_rows(what: str, held: tuple[int, int], rows: tuple[int, int],
                height: int) -> None:
    """A buffer holding rows [in0, in1) of a plane `height` rows high, of
    which the rows [r0, r1) are to be stored: every bound even, the rows
    inside the buffer, the buffer inside the plane."""
    (in0, in1), (r0, r1) = held, rows
    if any(v % 2 for v in (in0, in1, r0, r1)) or not (
            0 <= in0 <= r0 < r1 <= in1 <= height):
        raise ValueError(f"{what}: rows [{r0}, {r1}) of a buffer holding "
                         f"[{in0}, {in1}) of {height}: need even bounds, "
                         f"0 <= in0 <= r0 < r1 <= in1 <= {height}")


def _check_shard_planes(planes: list[torch.Tensor], cfg: CodecConfig,
                        level: int, first: int, r0: int, r1: int) -> bool:
    """X2's shard-mode input: whether it is samples (else int32 / float32
    values); raises on what the kernels do not take."""
    ah, aw = _geometry(cfg)
    h, w = ah >> level, aw >> level
    if not 0 <= level < cfg.wavelet_levels:
        raise ValueError(f"level {level} of {cfg.wavelet_levels}")
    if not 1 <= len(planes) <= 3:
        raise ValueError(f"expected 1 to 3 planes, got {len(planes)}")
    first_p = planes[0]
    samples = first_p.dtype in _SAMPLE_TYPES
    if samples:
        if level:
            raise TypeError(f"level {level} takes {_value_dtype(cfg)} "
                            f"values, got {first_p.dtype} samples")
        _n_components(cfg, len(planes), "sample planes")
    elif first_p.dtype != _value_dtype(cfg):
        raise TypeError(f"the shard's planes must be samples or "
                        f"{_value_dtype(cfg)}, got {first_p.dtype}")
    if first_p.dim() != 2 or first_p.shape[1] != w:
        raise ValueError(f"the shard's planes must have shape (rows, {w}), "
                         f"got {tuple(first_p.shape)}")
    for p in planes:
        if (p.dtype, p.shape, p.stride()) != (first_p.dtype, first_p.shape,
                                              first_p.stride()):
            raise ValueError("the planes differ in type, shape or strides")
    if first_p.stride(-1) != 1 or first_p.stride(0) < w:
        raise ValueError(f"plane rows must be contiguous, got strides "
                         f"{first_p.stride()}")
    _check_rows("X2 shard", (first, first + first_p.shape[0]), (r0, r1), h)
    return samples


def forward_shard_plain(planes: list[torch.Tensor], cfg: CodecConfig,
                        level: int, first: int, r0: int, r1: int,
                        top: torch.Tensor | None = None):
    """X2's shard mode as torch ops: `forward_shard`'s arguments and
    results. The prep (samples only), then the vertical lifting of the
    whole buffer (`_nxt` / `_prv` replicate at its ends: the plane's own
    edge rule where they are the plane's top or bottom, elsewhere garbage
    that stays in the halo), the interior's horizontal lifting and, for
    9/7, the quantization, truncated to int32 (the intermediate LL kept as
    it is)."""
    lossy, levels = cfg.is_lossy, cfg.wavelet_levels
    if planes[0].dtype in _SAMPLE_TYPES:
        planes = prep(planes, cfg)
    lo, hi = dwt.lift_vertical(torch.stack(planes), lossy)
    a, b = (r0 - first) // 2, (r1 - first) // 2
    ll, hl, lh, hh = dwt.lift_horizontal(lo[..., a:b, :], hi[..., a:b, :],
                                         lossy)
    if lossy:
        ll, hl, lh, hh = dwt.quantize_level(ll, hl, lh, hh, level, levels,
                                            cfg.qs)
    last = level == levels - 1
    hl, lh, hh = (t.to(torch.int32) for t in (hl, lh, hh))
    if last:
        ll = ll.to(torch.int32)
    coded = (ll, hl, lh, hh) if last else (hl, lh, hh)
    m = torch.stack([t.abs().amax() for t in coded]).amax()
    return (ll, hl, lh, hh), (m if top is None else torch.maximum(top, m))


@spanned("picsong/x2")
def forward_shard(planes: list[torch.Tensor], cfg: CodecConfig, level: int,
                  first: int, r0: int, r1: int,
                  top: torch.Tensor | None = None):
    """X2's shard mode: level `level` of the plane rows [r0, r1) (even) of
    `planes`, which hold the rows from `first` on of the level's plane
    (ah >> level, aw >> level): the shard's rows and its neighbours' halo,
    HALO[lossy] rows a side where the plane has them. At level 0 the
    component's sample planes (one gray or [R, G, B]; the prep runs on
    them), or at any level 1 to 3 planes of int32 (5/3) or float32 (9/7)
    values. -> ((ll, hl, lh, hh), top): each band's rows (comps, (r1 - r0) /
    2, w / 2), int32 (the intermediate LL of 9/7 float32), and the 0-dim
    int32 maximum magnitude of the quantized bands (HL, LH, HH; the LL at
    the last level), taken with `top` when given (on a card the kernel
    raises `top` in place)."""
    global FORWARD_LAUNCHES
    device = kernels.device_type(planes, "X2")
    samples = _check_shard_planes(planes, cfg, level, first, r0, r1)
    if device == "cpu":
        return forward_shard_plain(planes, cfg, level, first, r0, r1, top)
    nc, dev = len(planes), planes[0].device
    ah, aw = _geometry(cfg)
    h, w = ah >> level, aw >> level
    bands = torch.empty((4, nc, (r1 - r0) // 2, w // 2), dtype=torch.int32,
                        device=dev)
    if top is None:
        top = torch.zeros((), dtype=torch.int32, device=dev)
    consts = _constants(cfg.wavelet_levels, cfg.qs, True)
    ptrs = [p.data_ptr() for p in planes] + [None] * (3 - nc)
    kernels.launch(
        "picsong_dwt_forward_shard", dev, *ptrs,
        _SAMPLE_TYPES[planes[0].dtype] if samples else _VALUES,
        int(vector_loads(planes)), planes[0].stride(0), nc, h, w, level,
        cfg.wavelet_levels, int(cfg.is_lossy), offset(cfg), first,
        first + planes[0].shape[0], r0, r1, ctypes.addressof(consts),
        bands.data_ptr(), top.data_ptr(), what="dwt_forward_shard launch")
    FORWARD_LAUNCHES += 1
    ll = bands[0]
    if cfg.is_lossy and level < cfg.wavelet_levels - 1:
        ll = ll.view(torch.float32)
    return (ll, bands[1], bands[2], bands[3]), top


def _check_shard_bands(bands, cfg: CodecConfig, level: int, first: int,
                       r0: int, r1: int, to_samples: bool) -> int:
    """X4's shard-mode input: the component count; raises on what the
    kernels do not take."""
    ah, aw = _geometry(cfg)
    if not 0 <= level < cfg.wavelet_levels:
        raise ValueError(f"level {level} of {cfg.wavelet_levels}")
    if len(bands) != 4:
        raise ValueError(f"expected the LL, HL, LH and HH band rows, got "
                         f"{len(bands)} tensors")
    h2, w2 = ah >> (level + 1), aw >> (level + 1)
    shape = bands[0].shape
    if len(shape) != 3 or not 1 <= shape[0] <= 3 or shape[2] != w2:
        raise ValueError(f"band rows must have shape (comps, rows, {w2}), "
                         f"got {tuple(shape)}")
    ll_type = (torch.float32 if cfg.is_lossy
               and level < cfg.wavelet_levels - 1 else torch.int32)
    for b, want in zip(bands, (ll_type, torch.int32, torch.int32,
                               torch.int32)):
        if b.dtype != want:
            raise TypeError(f"band rows must be {want}, got {b.dtype}")
        if b.shape != shape:
            raise ValueError("the bands' rows differ in shape")
        if not b.is_contiguous():
            raise ValueError("band rows must be contiguous")
    if level == 0 and to_samples:
        _n_components(cfg, shape[0], "components")
    _check_rows("X4 shard", (2 * first, 2 * (first + shape[1])), (r0, r1),
                2 * h2)
    return shape[0]


def reverse_shard_plain(bands, cfg: CodecConfig, level: int, first: int,
                        r0: int, r1: int, to_samples: bool = True):
    """X4's shard mode as torch ops: `reverse_shard`'s arguments and
    result. 9/7's midpoint dequantization (the LL only at the deepest
    level), the horizontal and then the vertical synthesis of the whole
    buffer (garbage at its ends stays in the halo), the interior rows, and
    at level 0 with `to_samples` the finish."""
    lossy, levels = cfg.is_lossy, cfg.wavelet_levels
    ll, hl, lh, hh = bands
    if lossy:
        if level == levels - 1:
            ll = dwt.dequantize(ll, level, spec.QS_LL, cfg.qs)
        hl, lh, hh = (dwt.dequantize(b, level, band, cfg.qs)
                      for b, band in ((hl, spec.QS_HL), (lh, spec.QS_LH),
                                      (hh, spec.QS_HH)))
    x = dwt.unlift_vertical(*dwt.unlift_horizontal(ll, hl, lh, hh, lossy),
                            lossy)[..., r0 - 2 * first:r1 - 2 * first, :]
    if level == 0 and to_samples:
        return torch.stack(finish(list(x.unbind(0)), cfg))
    return x


@spanned("picsong/x4")
def reverse_shard(bands, cfg: CodecConfig, level: int, first: int, r0: int,
                  r1: int, to_samples: bool = True) -> torch.Tensor:
    """X4's shard mode: level `level` from the (comps, rows, w / 2) band
    rows (LL, HL, LH, HH: the LL's values above the deepest level, float32
    for 9/7, else quantized int32) that hold the band rows from `first` on:
    the shard's and its neighbours' halo, HALO[lossy] / 2 rows a side where
    the band has them. -> the plane rows [r0, r1) (even) of the level's
    plane, (comps, r1 - r0, aw >> level) int32 (5/3) or float32 (9/7); at
    level 0 with `to_samples` the finish's sample planes of the
    configuration's type."""
    global REVERSE_LAUNCHES
    bands = tuple(bands)
    device = kernels.device_type(bands, "X4")
    nc = _check_shard_bands(bands, cfg, level, first, r0, r1, to_samples)
    if device == "cpu":
        return reverse_shard_plain(bands, cfg, level, first, r0, r1,
                                   to_samples)
    dev = bands[0].device
    ah, aw = _geometry(cfg)
    h, w = ah >> level, aw >> level
    final = level == 0 and to_samples
    out = torch.empty((nc, r1 - r0, w),
                      dtype=sample_dtype(cfg) if final else torch.int32,
                      device=dev)
    consts = _constants(cfg.wavelet_levels, cfg.qs, False)
    mn, mx = sample_range(cfg)
    kernels.launch(
        "picsong_dwt_reverse_shard", dev, *(b.data_ptr() for b in bands),
        int(vector_block_loads(bands)), nc, h, w, level, cfg.wavelet_levels,
        int(cfg.is_lossy), int(final), offset(cfg), mn, mx,
        _SAMPLE_TYPES[out.dtype] if final else _VALUES,
        ctypes.addressof(consts), first, first + bands[0].shape[1], r0, r1,
        out.data_ptr(), what="dwt_reverse_shard launch")
    REVERSE_LAUNCHES += 1
    return out.view(torch.float32) if cfg.is_lossy and not final else out
