"""The plain reference codec: what the benchmark holds the program to.

Plain PyTorch and NumPy, written from the codec's format and arithmetic,
with no kernels: the DC shift and the RCT, the lifting DWT (5/3 in int32,
9/7 in float32 with one rounding a torch op and the subbands quantized by
gain * qs), the 64x64 codeblock tiling, BPC-PaCo (`bpc.py`), and the
packed codestream of one component: 9 header shorts (real on the first
component, 0xFFFF on the others), each codeblock's (MSB word, size), the
payload words, one 0xFFFF. It runs on whatever device its inputs are on,
over every image of a pool in one batch, and gives per image the
codestreams, the decoded samples and the counts the roofline needs.

`control=True` computes one step coarser than the configuration states,
the step a faster program would be tempted by: the 9/7 lifting in
bfloat16, and for 5/3 lossless (exact integers, nothing coarser that
still computes the same) each coefficient with its lowest magnitude bit
dropped, one bitplane fewer. Its answers must fail the comparison.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import bpc
from .lut import LUTParams, group_base

CB = 64
HEADER_SHORTS = 9

# lifting constants and the quantization gains, rows = level 0..9, columns
# = LL, HL, LH, HH
ALPHA, BETA, GAMMA, DELTA = (float(np.float32(c)) for c in (
    -1.586134342059924, -0.052980118572961, 0.882911075530934,
    0.443506852043971))
K1, K2 = float(np.float32(1.230174104914001)), float(np.float32(0.812893066))
QSTEPS = np.array([
    [1.965908, 1.0112865, 1.0112865, 0.52021784],
    [4.1224113, 1.9968134, 1.9968134, 0.96721643],
    [8.416739, 4.1833673, 4.1833673, 2.0792568],
    [16.935543, 8.534108, 8.534108, 4.3004827],
    [33.924816, 17.166693, 17.166693, 8.686718],
    [67.87687, 34.385098, 34.385098, 17.41882],
    [135.76744, 68.7964, 68.7964, 34.860676],
    [271.5416, 137.60588, 137.60588, 69.73287],
    [543.0866, 275.21814, 275.21814, 139.47136],
    [1086.1624, 550.43286, 550.43286, 278.94202],
], dtype=np.float32)
RECONSTRUCTION = 0.5
# the decoder's float -> int rounding bias, float32(0.01)
ROUND_BIAS = float(np.float32(0.01))


@dataclass(frozen=True)
class Config:
    """The codestream's configuration, as a configuration file states it."""

    width: int
    height: int
    components: int
    is_rgb: bool
    bit_depth: int
    bps: int
    is_signed: bool
    endianess: int
    is_lossy: bool
    qs: float
    wavelet_levels: int
    coding_passes: int
    k_factor: float
    cb_height: int
    cb_width: int
    frames: int = 0

    @property
    def padded(self) -> tuple[int, int]:
        """(height, width) rounded up to codeblock multiples."""
        return -(-self.height // CB) * CB, -(-self.width // CB) * CB

    @property
    def n_planes_in(self) -> int:
        return 3 if self.is_rgb else 1

    @property
    def n_blocks(self) -> int:
        ah, aw = self.padded
        return (ah // CB) * (aw // CB)


def header(cfg: Config) -> np.ndarray:
    """The 9-short wire header."""
    size = cfg.width * cfg.height * cfg.components
    qs = int(round(cfg.qs * 10000))
    k = int(round(cfg.k_factor * 1000))
    wl = cfg.wavelet_levels
    h = [size & 0xFFFF, (size >> 16) & 0xFFFF,
         (1 if cfg.coding_passes == 3 else 0) | (cfg.cb_height & 0x7F) << 1
         | (cfg.cb_width & 0x7F) << 8 | (wl & 1) << 15,
         (wl & 7) >> 1 | (cfg.bit_depth & 0x7F) << 3 | int(cfg.is_lossy) << 10
         | (qs & 31) << 11,
         (qs >> 5) & 0x1FF | (cfg.components & 0x7F) << 9,
         (cfg.components >> 7) & 0x7F | int(cfg.is_rgb) << 7
         | (cfg.height & 0xFF) << 8,
         (cfg.height >> 8) & 0xFF | (cfg.endianess & 1) << 8
         | (cfg.bps & 0x1F) << 9 | int(cfg.is_signed) << 14
         | (cfg.frames & 1) << 15,
         (cfg.frames >> 1) & 0xFFFF, k & 0xFFFF]
    return np.array(h, dtype=np.uint16)


# --------------------------------------------------------------------------
# Geometry
# --------------------------------------------------------------------------

def _band(x: int, y: int, w: int, h: int, levels: int) -> tuple[int, int]:
    """Level and subband (HL 0, LH 1, HH 2) of the codeblock at pixel
    (x, y); the residual LL is (levels, 0)."""
    for aux in range(1, levels + 1):
        right, bottom = x >= (w >> aux), y >= (h >> aux)
        if right:
            return aux - 1, 2 if bottom else 0
        if bottom:
            return aux - 1, 1
    return levels, 0


def block_bands(cfg: Config) -> tuple[np.ndarray, np.ndarray]:
    """Each codeblock's (level, subband), blocks in row-major order."""
    ah, aw = cfg.padded
    bands = [_band(x * CB, y * CB, aw, ah, cfg.wavelet_levels)
             for y in range(ah // CB) for x in range(aw // CB)]
    arr = np.array(bands, dtype=np.int64).reshape(-1, 2)
    return arr[:, 0], arr[:, 1]


def to_blocks(plane: torch.Tensor) -> torch.Tensor:
    h, w = plane.shape
    return (plane.reshape(h // CB, CB, w // CB, CB).transpose(1, 2)
            .reshape(-1, CB, CB))


def from_blocks(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return (blocks.reshape(h // CB, w // CB, CB, CB).transpose(1, 2)
            .reshape(h, w))


# --------------------------------------------------------------------------
# Lifting: vertical then horizontal forward, the reverse backward; the
# boundary repeats the edge sample (symmetric extension)
# --------------------------------------------------------------------------

def _split(x, axis):
    return (x[:, 0::2], x[:, 1::2]) if axis else (x[0::2], x[1::2])


def _merge(even, odd, axis):
    return torch.stack([even, odd], dim=axis + 1).reshape(
        *even.shape[:axis], 2 * even.shape[axis], *even.shape[axis + 1:])


def _nxt(a, axis):
    return torch.cat([a[:, 1:], a[:, -1:]], 1) if axis else torch.cat(
        [a[1:], a[-1:]], 0)


def _prv(a, axis):
    return torch.cat([a[:, :1], a[:, :-1]], 1) if axis else torch.cat(
        [a[:1], a[:-1]], 0)


def _div(x, c):
    """x / c rounded once, the divisor a tensor on x's device."""
    return x / torch.full((), float(c), dtype=x.dtype, device=x.device)


def _fwd(x, axis, lossy):
    even, odd = _split(x, axis)
    if not lossy:
        d = odd - ((even + _nxt(even, axis)) >> 1)
        return even + ((_prv(d, axis) + d + 2) >> 2), d
    odd = odd + (even + _nxt(even, axis)) * ALPHA
    even = even + (_prv(odd, axis) + odd) * BETA
    odd = odd + (even + _nxt(even, axis)) * GAMMA
    even = (even + (_prv(odd, axis) + odd) * DELTA) * K2
    return even, odd * K1


def _inv(s, d, axis, lossy):
    if not lossy:
        even = s - ((_prv(d, axis) + d + 2) >> 2)
        return _merge(even, d + ((even + _nxt(even, axis)) >> 1), axis)
    odd = _div(d, K1)
    even = _div(s, K2) - (_prv(odd, axis) + odd) * DELTA
    odd = odd - (even + _nxt(even, axis)) * GAMMA
    even = even - (_prv(odd, axis) + odd) * BETA
    odd = odd - (even + _nxt(even, axis)) * ALPHA
    return _merge(even, odd, axis)


def dwt_forward(plane: torch.Tensor, cfg: Config) -> torch.Tensor:
    """One component plane -> the int32 Mallat mosaic; 9/7 subbands times
    gain * qs (the last LL too, the intermediate ones not), truncated."""
    lossy, levels = cfg.is_lossy, cfg.wavelet_levels
    qs = np.float32(cfg.qs)
    cur, quads = plane, []
    for level in range(levels):
        lo, hi = _fwd(cur, 0, lossy)
        ll, hl = _fwd(lo, 1, lossy)
        lh, hh = _fwd(hi, 1, lossy)
        if lossy:
            g = QSTEPS[level]
            hl, lh, hh = (b * float(g[i] * qs) for i, b in
                          ((1, hl), (2, lh), (3, hh)))
            if level == levels - 1:
                ll = ll * float(g[0] * qs)
        quads.append((hl, lh, hh))
        cur = ll
    out = cur
    for hl, lh, hh in reversed(quads):
        out = torch.cat([torch.cat([out, hl], 1), torch.cat([lh, hh], 1)], 0)
    return out.to(torch.int32)


def _dequantize(q, level, band, qs, dtype):
    mag = q.abs().to(dtype) + RECONSTRUCTION
    val = _div(_div(torch.where(q < 0, -mag, mag), QSTEPS[level][band]),
               np.float32(qs))
    return torch.where(q == 0, torch.zeros_like(val), val)


def dwt_reverse(mallat: torch.Tensor, cfg: Config, dtype) -> torch.Tensor:
    """The int32 Mallat mosaic -> the component plane (int32 for 5/3,
    `dtype` after midpoint dequantization for 9/7)."""
    lossy, levels, qs = cfg.is_lossy, cfg.wavelet_levels, cfg.qs
    h, w = mallat.shape
    ll = None
    for level in range(levels - 1, -1, -1):
        hh_, wh_ = h >> (level + 1), w >> (level + 1)
        hl = mallat[:hh_, wh_:2 * wh_]
        lh = mallat[hh_:2 * hh_, :wh_]
        hh = mallat[hh_:2 * hh_, wh_:2 * wh_]
        if ll is None:
            ll = mallat[:hh_, :wh_]
            if lossy:
                ll = _dequantize(ll, level, 0, qs, dtype)
        if lossy:
            hl, lh, hh = (_dequantize(b, level, i, qs, dtype)
                          for i, b in ((1, hl), (2, lh), (3, hh)))
        lo = _inv(ll, hl, 1, lossy)
        hi = _inv(lh, hh, 1, lossy)
        ll = _inv(lo, hi, 0, lossy)
    return ll


def _offset(cfg: Config) -> int:
    return 0 if cfg.is_signed else 1 << (cfg.bit_depth - 1)


def prep(samples: list[torch.Tensor], cfg: Config, dtype) -> list:
    """Sample planes -> component planes: the DC shift, then the RCT of RGB
    (lossless); `dtype` for the 9/7 path."""
    shifted = [x.to(torch.int32) - _offset(cfg) for x in samples]
    if cfg.is_rgb:
        if cfg.is_lossy:
            raise NotImplementedError("the reference has no ICT")
        r, g, b = shifted
        return [(r + 2 * g + b) >> 2, b - g, r - g]
    return [shifted[0].to(dtype) if cfg.is_lossy else shifted[0]]


def finish(comps: list[torch.Tensor], cfg: Config,
           out_dtype: torch.dtype) -> list[torch.Tensor]:
    """Component planes -> samples: the inverse RCT, the DC shift, the
    rounding of 9/7 (half to even, after the shift, with the bias), and the
    clamp to the sample range."""
    off = _offset(cfg)
    lo, hi = ((-(1 << (cfg.bit_depth - 1)), (1 << (cfg.bit_depth - 1)) - 1)
              if cfg.is_signed else (0, (1 << cfg.bit_depth) - 1))
    if cfg.is_lossy:
        vals = torch.round(comps[0].float() + float(off) + ROUND_BIAS)
        return [torch.clamp(vals, lo, hi).to(out_dtype)]
    if cfg.is_rgb:
        y, u, v = comps
        g = y - ((u + v) >> 2)
        comps = [v + g, g, u + g]
    return [torch.clamp(c + off, lo, hi).to(out_dtype) for c in comps]


# --------------------------------------------------------------------------
# The packed codestream of one component
# --------------------------------------------------------------------------

def pack(streams: torch.Tensor, sizes: torch.Tensor,
         head: np.ndarray | None) -> np.ndarray:
    """(N, 4096) int32 streams and (N,) sizes -> the uint16 codestream."""
    n = streams.shape[0]
    col = torch.arange(streams.shape[1], device=streams.device)[None, :]
    keep = (col >= 1) & (col < sizes[:, None])
    payload = (streams[keep] & 0xFFFF).cpu().numpy().astype(np.uint16)
    pairs = torch.stack([streams[:, 0], sizes], 1).reshape(-1) & 0xFFFF
    filler = np.full(HEADER_SHORTS, 0xFFFF, dtype=np.uint16)
    return np.concatenate([filler if head is None else head,
                           pairs.cpu().numpy().astype(np.uint16), payload,
                           filler[:1]])


@dataclass
class Coded:
    """What the reference gives for one image."""

    codestreams: list[np.ndarray]       # one uint16 codestream a component
    decoded: list[np.ndarray]           # the decoded sample planes
    msb: list[np.ndarray]               # a block's MSB, -1 when empty
    nonzero: list[np.ndarray]           # a block's nonzero coefficients
    words: list[np.ndarray]             # a block's coded words (its size)


class ReferenceCodec:
    """The reference over a pool of images, in one batch a direction."""

    def __init__(self, cfg: Config, luts: list[np.ndarray], params: LUTParams,
                 device, control: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.control = control
        self.dtype = torch.bfloat16 if control else torch.float32
        self.luts = [torch.as_tensor(lut, device=self.device) for lut in luts]
        self.prec = params.mult_precision
        levels, subbands = block_bands(cfg)
        off = params.section_offsets(cfg.wavelet_levels)
        self.bases = [torch.as_tensor(
            off[name] + np.array([group_base(params, int(lv), int(sb), n)
                                  for lv, sb in zip(levels, subbands)]),
            device=self.device)
            for name, n in (("ref", params.ctx_refinement),
                            ("sig", params.ctx_significance),
                            ("sign", params.ctx_sign))]

    def _tables(self, n_images: int) -> bpc.Tables:
        """Every (image, component)'s blocks, component-minor; component c
        codes with LUT c (the last one repeats)."""
        nc, ncb = self.cfg.n_planes_in, self.cfg.n_blocks
        comp = torch.arange(n_images * nc, device=self.device) % nc
        table = torch.clamp(comp, max=len(self.luts) - 1).repeat_interleave(
            ncb)
        bases = [b.repeat(n_images * nc) for b in self.bases]
        return bpc.Tables(self.luts, table, *bases, self.prec)

    def transform(self, images: list[list[torch.Tensor]]) -> torch.Tensor:
        """Padded sample planes -> the quantized codeblocks of every image
        and component, (images * components * ncb, 64, 64) int32."""
        out = []
        for planes in images:
            for comp in prep(planes, self.cfg, self.dtype):
                mallat = dwt_forward(comp, self.cfg)
                if self.control and not self.cfg.is_lossy:
                    mallat = torch.sign(mallat) * (mallat.abs() & ~1)
                out.append(to_blocks(mallat))
        return torch.cat(out)

    def inverse(self, blocks: torch.Tensor, n_images: int,
                out_dtype) -> list[list[np.ndarray]]:
        ah, aw = self.cfg.padded
        nc, ncb = self.cfg.n_planes_in, self.cfg.n_blocks
        out = []
        for i in range(n_images):
            comps = [dwt_reverse(from_blocks(
                blocks[(i * nc + c) * ncb:(i * nc + c + 1) * ncb], ah, aw),
                self.cfg, self.dtype) for c in range(nc)]
            out.append([p[:self.cfg.height, :self.cfg.width].cpu().numpy()
                        for p in finish(comps, self.cfg, out_dtype)])
        return out

    def run(self, images: list[list[torch.Tensor]], out_dtype) -> list[Coded]:
        """Encode every image, pack its codestreams, decode them back."""
        n, nc, ncb = len(images), self.cfg.n_planes_in, self.cfg.n_blocks
        blocks = self.transform(images)
        tables = self._tables(n)
        streams, sizes = bpc.encode_blocks(blocks, tables)
        msb = bpc.block_msb(blocks).cpu().numpy()
        nonzero = (blocks != 0).reshape(blocks.shape[0], -1).sum(1).cpu()
        decoded = self.inverse(bpc.decode_blocks(streams, sizes, tables), n,
                               out_dtype)
        head = header(self.cfg)
        out = []
        for i in range(n):
            parts = [slice((i * nc + c) * ncb, (i * nc + c + 1) * ncb)
                     for c in range(nc)]
            out.append(Coded(
                codestreams=[pack(streams[s], sizes[s],
                                  head if c == 0 else None)
                             for c, s in enumerate(parts)],
                decoded=decoded[i],
                msb=[msb[s] for s in parts],
                nonzero=[nonzero[s].numpy() for s in parts],
                words=[sizes[s].cpu().numpy() for s in parts]))
        return out
