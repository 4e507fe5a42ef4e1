"""The transform layers X2 and X4 (`transform/dwt_cuda.py`) on the CPU: the
plain version the kernels are held to, against TPUCodec's device programs
(`_prep_*` + `_dwt_tile`, `_untile_idwt` + `_finish_*`, on JAX's CPU) and
the NumPy oracle; the wrapper's checks, entry points and bound; a model of
the first kernels' tiling with halos, and one each of X2's and X4's work split
(16-byte load windows, register strips, staged 16-byte stores), against
whole-plane lifting.

Tolerances: the integer paths (5/3, RCT) are exact against both. The 9/7
path is exact against the oracle; TPUCodec's XLA:CPU 9/7 drifts (ROADMAP
queue 3), so against it the gray quantized coefficients may differ by +-1
(in at most 1e-4 of the positions at 8 bits, as in
tests/test_torch_lossy.py; the drift grows with the coefficients, 7 of
8192 at 16 bits), and its decoded samples stay within 0.05 dB of the
port's (PSNR against the input).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picsong_tpu.engine.pipeline import TPUCodec
from picsong_tpu.reference import codec as ocodec
from picsong_tpu.reference import dwt as odwt
from picsong_tpu_torch import kernels
from picsong_tpu_torch.core import spec
from picsong_tpu_torch.core.header import CodecConfig
from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
from picsong_tpu_torch.transform import dwt, dwt_cuda
from test_torch_rgb_depth import _blas_contracts_ict
from torch_twins import J

PARAMS = LUTParams()
H, W = 64, 128


def _samples(rng, cfg, lead=()):
    """Samples of the configuration's type and range: a smooth field plus
    noise, (*lead, H, W) per component."""
    lo, hi = dwt_cuda.sample_range(cfg)
    y, x = np.mgrid[0:H, 0:W]
    span = hi - lo
    base = (lo + span / 2 + span / 3 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, span / 32, size=(*lead, H, W)))
    dtype = {torch.uint8: np.uint8, torch.int8: np.int8,
             torch.uint16: np.uint16, torch.int16: np.int16}[
        dwt_cuda.sample_dtype(cfg)]
    return [np.clip(base + 7 * c, lo, hi).astype(dtype)
            for c in range(3 if cfg.is_rgb else 1)]


def _cfg(rgb=False, lossy=False, qs=1.0, wl=3, depth=8, signed=False):
    return CodecConfig(width=W, height=H, wavelet_levels=wl, is_lossy=lossy,
                       qs=qs, is_rgb=rgb, components=3 if rgb else 1,
                       bit_depth=depth, bps=depth, is_signed=signed)


def _oracle_forward(planes, cfg):
    off = dwt_cuda.offset(cfg)
    shifted = [p.astype(np.int32) - off for p in planes]
    if cfg.is_rgb:
        comps = (ocodec.ict_forward(*(s.astype(np.float32) for s in shifted))
                 if cfg.is_lossy else ocodec.rct_forward(*shifted))
    else:
        comps = [shifted[0].astype(np.float32) if cfg.is_lossy
                 else shifted[0]]
    return [ocodec.plane_to_codeblocks(odwt.dwt_forward(
        c, cfg.wavelet_levels, cfg.is_lossy, cfg.qs).astype(np.int32))
        for c in comps]


def _oracle_reverse(blocks, cfg):
    """`reference/codec.py` decode_image's planes and finish, uncropped."""
    off = dwt_cuda.offset(cfg)
    mn, mx = dwt_cuda.sample_range(cfg)
    planes = [odwt.dwt_reverse(ocodec.codeblocks_to_plane(b, H, W),
                               cfg.wavelet_levels, cfg.is_lossy, cfg.qs)
              for b in blocks]
    if cfg.is_rgb:
        rgb = (ocodec.ict_inverse(*planes) if cfg.is_lossy
               else ocodec.rct_inverse(*(p.astype(np.int32) for p in planes)))
        return [np.clip(p.astype(np.int32) + off, mn, mx) for p in rgb]
    if cfg.is_lossy:
        return [np.clip(np.rint(planes[0] + np.float32(off)
                                + np.float32(0.01)), mn, mx)]
    return [np.clip(planes[0].astype(np.int32) + off, mn, mx)]


def _jax(planes, blocks, cfg):
    """TPUCodec's forward blocks and maximum of `planes`, and its decode of
    the port's `blocks`."""
    jc = TPUCodec(J(cfg), [neutral_lut(PARAMS, cfg.wavelet_levels, 2)],
                  J(PARAMS))
    arrays = [jnp.asarray(p) for p in planes]
    comps = (jc._prep_rgb(*arrays) if cfg.is_rgb
             else [jc._prep_gray(arrays[0])])
    tiled = [jc._dwt_tile(c) for c in comps]
    back = [jc._untile_idwt(jnp.asarray(b.numpy())) for b in blocks]
    out = jc._finish_rgb(*back) if cfg.is_rgb else [jc._finish_gray(back[0])]
    return ([np.asarray(b) for b, _ in tiled],
            max(int(m) for _, m in tiled), [np.asarray(o) for o in out])


def _psnr(a, b, peak):
    err = a.astype(np.float64) - b.astype(np.float64)
    return 10 * np.log10(peak ** 2 / max(float(np.mean(err * err)), 1e-12))


CASES = [
    # (rgb, lossy, qs, wl, depth, signed)
    *[(False, False, 1.0, wl, 8, False) for wl in (1, 2, 3, 4, 5)],
    (False, True, 1.0, 3, 8, False),
    (False, True, 0.5, 5, 8, False),
    (False, False, 1.0, 2, 12, False),
    (False, True, 1.0, 3, 16, False),
    (False, False, 1.0, 4, 8, True),
    (False, True, 0.5, 2, 16, True),
    (False, True, 1.0, 1, 12, True),
    (True, False, 1.0, 2, 8, False),
    (True, True, 1.0, 3, 8, False),
    (True, True, 0.5, 5, 8, False),
    (True, False, 1.0, 1, 16, False),
]


@pytest.mark.parametrize("rgb,lossy,qs,wl,depth,signed", CASES)
def test_layers_match_oracle_and_tpu_codec(rgb, lossy, qs, wl, depth,
                                           signed):
    cfg = _cfg(rgb, lossy, qs, wl, depth, signed)
    planes = _samples(np.random.default_rng(wl + depth + 10 * rgb), cfg)
    blocks, top = dwt_cuda.forward([torch.from_numpy(p) for p in planes],
                                   cfg)
    assert top.dtype == torch.int32 and top.dim() == 0
    assert int(top) == max(int(b.abs().max()) for b in blocks)
    back = dwt_cuda.reverse(blocks, cfg)
    assert all(b.dtype == dwt_cuda.sample_dtype(cfg) for b in back)
    oracle_ok = not (rgb and lossy) or _blas_contracts_ict()
    if oracle_ok:
        for got, want in zip(blocks, _oracle_forward(planes, cfg)):
            assert np.array_equal(got.numpy(), want)
        for got, want in zip(back, _oracle_reverse(
                [b.numpy() for b in blocks], cfg)):
            assert np.array_equal(got.numpy(), want)
    j_blocks, j_top, j_back = _jax(planes, blocks, cfg)
    if not lossy:
        assert int(top) == j_top
        for got, want in zip(blocks, j_blocks):
            assert np.array_equal(got.numpy(), want)
        for got, want, p in zip(back, j_back, planes):
            assert np.array_equal(got.numpy(), want)
            assert np.array_equal(got.numpy(), p)          # lossless
        return
    if not rgb:         # XLA:CPU's ICT is not the fused chain
        diff = np.abs(blocks[0].numpy().astype(np.int64) - j_blocks[0])
        assert diff.max() <= 1
        if depth == 8:
            assert np.count_nonzero(diff) <= 1e-4 * diff.size
    peak = float((1 << depth) - 1)
    for got, want, p in zip(back, j_back, planes):
        assert (_psnr(want, p, peak)
                >= _psnr(got.numpy(), p, peak) - 0.05)


@pytest.mark.parametrize("rgb,lossy,qs,wl", [(False, False, 1.0, 3),
                                             (True, True, 0.5, 2),
                                             (True, False, 1.0, 4)])
def test_batch_frames_equal_images(rgb, lossy, qs, wl):
    """A (B, H, W) or (B, 3, H, W) batch (its components strided views of
    one tensor) -> each frame's blocks and samples equal to the frame coded
    alone."""
    cfg = _cfg(rgb, lossy, qs, wl)
    planes = _samples(np.random.default_rng(3), cfg, lead=(3,))
    frames = torch.from_numpy(np.stack(planes, axis=1) if rgb else planes[0])
    samples = list(frames.unbind(1)) if rgb else [frames]
    if rgb:
        assert samples[0].stride(0) == 3 * H * W
    blocks, top = dwt_cuda.forward(samples, cfg)
    back = dwt_cuda.reverse(blocks, cfg)
    tops = []
    for f in range(3):
        one, t = dwt_cuda.forward([s[f] for s in samples], cfg)
        tops.append(int(t))
        for b, o in zip(blocks, one):
            assert torch.equal(b[f], o)
        for b, o in zip(back, dwt_cuda.reverse(one, cfg)):
            assert torch.equal(b[f], o)
    assert int(top) == max(tops)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    cfg = _cfg(wl=3)
    good = torch.zeros((H, W), dtype=torch.uint8)
    with pytest.raises(ValueError, match="device meta"):
        dwt_cuda.forward([good.to("meta")], cfg)
    with pytest.raises(ValueError, match="device meta"):
        dwt_cuda.reverse([torch.zeros((2, 64, 64), dtype=torch.int32,
                                      device="meta")], cfg)
    with pytest.raises(TypeError, match="uint8, int8, uint16 or int16"):
        dwt_cuda.forward([good.to(torch.int32)], cfg)
    with pytest.raises(TypeError, match="int32"):
        dwt_cuda.reverse([torch.zeros((2, 64, 64), dtype=torch.int64)], cfg)
    with pytest.raises(ValueError, match="shape"):
        dwt_cuda.forward([torch.zeros((H, 100), dtype=torch.uint8)], cfg)
    with pytest.raises(ValueError, match="shape"):
        dwt_cuda.forward([torch.zeros((2, 2, H, W), dtype=torch.uint8)], cfg)
    with pytest.raises(ValueError, match="multiples of 128"):
        dwt_cuda.forward([good], _cfg(wl=7))
    with pytest.raises(ValueError, match="contiguous"):
        dwt_cuda.forward([torch.zeros((W, H), dtype=torch.uint8).t()], cfg)
    with pytest.raises(ValueError, match="contiguous"):
        dwt_cuda.reverse([torch.zeros((2, 64, 64), dtype=torch.int32)
                          .transpose(1, 2)], cfg)
    with pytest.raises(ValueError, match="expected 3"):
        dwt_cuda.forward([good], _cfg(rgb=True))


@pytest.mark.parametrize("skip,size,strides,want", [
    (0, 1, (), True), (1, 1, (), False), (16, 1, (), True),
    (8, 2, (), True), (1, 2, (), False),
    (0, 1, ((64 + 16) * W,), True), (0, 1, ((64 + 8) * W + 8,), False),
    (0, 2, ((64 + 4) * W + 4,), False)])
def test_vector_loads_need_16_byte_bases_and_strides(skip, size, strides,
                                                     want):
    """X2 reads level 0 in 16-byte chunks only where every plane's first
    sample and its row and frame strides in bytes are multiples of 16."""
    dtype = {1: torch.uint8, 2: torch.int16}[size]
    frame = strides[0] if strides else H * W
    buf = torch.zeros(skip + 3 * frame, dtype=dtype)
    if strides:
        planes = buf[skip:].as_strided((3, H, W), (frame, W, 1))
    else:
        planes = buf[skip:skip + H * W].view(H, W)
    assert dwt_cuda.vector_loads([planes]) == want


@pytest.mark.parametrize("skips,want", [
    ((0,), True), ((1,), False), ((2,), False), ((4,), True),
    ((0, 4, 8), True), ((0, 4, 3), False)])
def test_vector_block_loads_need_16_byte_bases(skips, want):
    """X4 reads codeblocks in 16-byte chunks only where every component's
    first word falls on a multiple of 16 bytes: a contiguous view 1-3
    words into a buffer is read a word at a time."""
    n = 2 * 64 * 64
    views = []
    for skip in skips:
        buf = torch.zeros(n + 16, dtype=torch.int32)
        assert buf.data_ptr() % 16 == 0
        views.append(buf[skip:skip + n].view(2, 64, 64))
    assert all(v.is_contiguous() for v in views)
    assert dwt_cuda.vector_block_loads(views) == want


def test_entry_points_are_bound():
    """The C entry points of csrc/dwt_forward.cu and dwt_reverse.cu (and
    their shard modes') are declared for ctypes with as many arguments as
    the sources take."""
    for name in ("forward", "reverse", "forward_shard", "reverse_shard"):
        source = f"dwt_{name.split('_')[0]}.cu"
        with open(os.path.join(kernels.CSRC_DIR, source)) as f:
            src = f.read()
        m = re.search(r'extern "C" int picsong_dwt_' + name + r"\(([^)]*)\)",
                      src)
        assert m, name
        assert m.group(1).count(",") + 1 == len(
            kernels._SIGNATURES[f"picsong_dwt_{name}"])


def test_bound_counts_the_bytes():
    """The samples read once plus the int32 codeblocks written once, over
    3.35 TB/s (meta tensors: shapes only)."""
    gray = _cfg(wl=5)
    plane = [torch.empty((2048, 2048), dtype=torch.uint8, device="meta")]
    ms, by = dwt_cuda.bound_ms(plane, gray)
    assert by == "bytes" and ms == pytest.approx(2048 * 2048 * 5 / 3.35e9)
    assert ms == pytest.approx(0.00626, abs=1e-5)
    rgb = [torch.empty((2560, 2048), dtype=torch.uint8, device="meta")] * 3
    ms, by = dwt_cuda.bound_ms(rgb, _cfg(rgb=True, lossy=True, wl=5))
    assert by == "bytes" and ms == pytest.approx(3 * 2048 * 2560 * 5 / 3.35e9)
    assert ms == pytest.approx(0.0235, abs=1e-4)


# -- the kernels' division by a constant (csrc/dwt_common.cuh div_rn) --------

def _fma32(a, b, c):
    """fma(a, b, c) of float32 tensors rounded once to float32: the float64
    product is exact, the sum rounded to odd rounds once when cast."""
    return dwt_cuda._add_round_to_odd(a.double() * b.double(),
                                      c.double()).float()


def _div_rn(x, b):
    """div_rn(x, b, reciprocal(b)) on a float32 tensor x."""
    b = torch.tensor(b, dtype=torch.float32)
    y = torch.tensor(dwt_cuda.reciprocal(b.item()), dtype=torch.float32)
    q0 = x * y
    q1 = _fma32(_fma32(-q0, b, x), y, q0)
    q = _fma32(_fma32(-q1, b, x), y, q1)
    return torch.where(x == 0, x, q)


@pytest.mark.parametrize("name", ["I97_K1", "I97_K2"])
def test_div_rn_rounds_every_mantissa_by_k1_and_k2(name):
    """div_rn == x / b rounded once for every float32 mantissa in [1, 2),
    so for every normal x whose quotient and remainders stay normal
    (scaling x by 2^k scales each step exactly); a zero keeps its sign."""
    b = float(getattr(spec, name))
    bits = torch.arange(1 << 23, dtype=torch.int32) | 0x3F800000
    x = bits.view(torch.float32)
    for sx in (x, -x * 2.0 ** 37, x * 2.0 ** -41):
        assert torch.equal(_div_rn(sx, b), sx / b)
    zeros = torch.tensor([0.0, -0.0])
    got = _div_rn(zeros, b)
    assert torch.equal(torch.signbit(got), torch.signbit(zeros))


def test_div_rn_rounds_by_the_gains_and_qs():
    """The dequantization's divisors: every gain of spec.WAVELET_QSTEPS and
    qs in (0.5, 0.7, 1, 3), 2^18 random x each with exponents -40 .. 40."""
    rng = np.random.default_rng(7)
    divisors = sorted({float(g) for g in spec.WAVELET_QSTEPS.ravel()}
                      | {float(np.float32(q)) for q in (0.5, 0.7, 1.0, 3.0)})
    for b in divisors:
        x = torch.from_numpy((rng.uniform(-2, 2, 1 << 18)
                              * 2.0 ** rng.integers(-40, 41, 1 << 18))
                             .astype(np.float32))
        assert torch.equal(_div_rn(x, b), x / b), b


# -- a model of the first X2/X4 tiling (a 64x64 tile with its halo lifted a
# step at a time in shared memory), whose arithmetic the strips keep -------

def _step(t, vert, par, lines, g0, n, f):
    """csrc/dwt_common.cuh lift_step on a numpy tile: positions of parity
    `par` along the axis (rows if `vert`), on `lines` across it; the
    neighbour rule on the plane index g0 + position, clamped to the tile."""
    side = t.shape[0]
    pos = np.arange(par, side, 2)
    g = g0 + pos
    if par:
        a = pos - 1
        b = np.where((g + 1 < n) & (pos + 1 < side), pos + 1, pos - 1)
    else:
        b = pos + 1
        a = np.where((g > 0) & (pos > 0), pos - 1, pos + 1)

    def at(p):
        return np.ix_(p, lines) if vert else np.ix_(lines, p)
    t[at(pos)] = f(t[at(pos)], t[at(a)], t[at(b)])


def _f32(*c):
    return [np.float32(x) for x in c]


def _lift(t, vert, lines, g0, n, lossy, forward, scale_odd):
    """dwt_common.cuh lift_forward / lift_reverse."""
    al, be, ga, de, k1, k2 = _f32(spec.I97_ALPHA, spec.I97_BETA,
                                  spec.I97_GAMMA, spec.I97_DELTA, spec.I97_K1,
                                  spec.I97_K2)
    if not lossy:
        steps = ([(1, lambda x, a, b: x - ((a + b) >> 1)),
                  (0, lambda x, a, b: x + ((a + b + 2) >> 2))] if forward
                 else [(0, lambda x, a, b: x - ((a + b + 2) >> 2)),
                       (1, lambda x, a, b: x + ((a + b) >> 1))])
    elif forward:
        steps = [(1, lambda x, a, b: x + (a + b) * al),
                 (0, lambda x, a, b: x + (a + b) * be),
                 (1, lambda x, a, b: x + (a + b) * ga),
                 (0, lambda x, a, b: (x + (a + b) * de) * k2)]
        if scale_odd:
            steps.append((1, lambda x, a, b: x * k1))
    else:
        steps = ([(1, lambda x, a, b: x / k1)] if scale_odd else []) + [
            (0, lambda x, a, b: x / k2 - (a + b) * de),
            (1, lambda x, a, b: x - (a + b) * ga),
            (0, lambda x, a, b: x - (a + b) * be),
            (1, lambda x, a, b: x - (a + b) * al)]
    for par, f in steps:
        _step(t, vert, par, lines, g0, n, f)


def _tiles(h, w):
    return [(y0, x0) for y0 in range(0, h, dwt_cuda.TILE)
            for x0 in range(0, w, dwt_cuda.TILE)]


def _model_forward_level(plane, lossy):
    """One forward level on X4's tiling (a 64x64 tile with its halo lifted
    a step at a time) on a numpy plane -> (ll, hl, lh, hh), unquantized."""
    h, w = plane.shape
    tile, halo = dwt_cuda.TILE, dwt_cuda.HALO[lossy]
    side = tile + 2 * halo
    out = np.zeros_like(plane)
    for y0, x0 in _tiles(h, w):
        t = np.zeros((side, side), plane.dtype)
        gy, gx = np.arange(side) + y0 - halo, np.arange(side) + x0 - halo
        iy, ix = (gy >= 0) & (gy < h), (gx >= 0) & (gx < w)
        t[np.ix_(iy, ix)] = plane[np.ix_(gy[iy], gx[ix])]
        _lift(t, True, np.arange(side), y0 - halo, h, lossy, True, True)
        _lift(t, False, np.arange(halo, halo + tile), x0 - halo, w, lossy,
              True, False)
        ny, nx = min(tile, h - y0), min(tile, w - x0)
        out[y0:y0 + ny, x0:x0 + nx] = t[halo:halo + ny, halo:halo + nx]
    if lossy:
        out[:, 1::2] *= np.float32(spec.I97_K1)
    return out[0::2, 0::2], out[0::2, 1::2], out[1::2, 0::2], out[1::2, 1::2]


def _model_reverse_level(ll, hl, lh, hh, lossy):
    """One level of csrc/dwt_reverse.cu before its finish -> the plane."""
    h, w = 2 * ll.shape[0], 2 * ll.shape[1]
    tile, halo = dwt_cuda.TILE, dwt_cuda.HALO[lossy]
    side = tile + 2 * halo
    full = np.zeros((h, w), ll.dtype)
    full[0::2, 0::2], full[0::2, 1::2] = ll, hl
    full[1::2, 0::2], full[1::2, 1::2] = lh, hh
    if lossy:
        full[:, 1::2] /= np.float32(spec.I97_K1)
    out = np.zeros_like(full)
    for y0, x0 in _tiles(h, w):
        t = np.zeros((side, side), full.dtype)
        gy, gx = np.arange(side) + y0 - halo, np.arange(side) + x0 - halo
        iy, ix = (gy >= 0) & (gy < h), (gx >= 0) & (gx < w)
        t[np.ix_(iy, ix)] = full[np.ix_(gy[iy], gx[ix])]
        _lift(t, False, np.arange(side), x0 - halo, w, lossy, False, False)
        _lift(t, True, np.arange(halo, halo + tile), y0 - halo, h, lossy,
              False, True)
        ny, nx = min(tile, h - y0), min(tile, w - x0)
        out[y0:y0 + ny, x0:x0 + nx] = t[halo:halo + ny, halo:halo + nx]
    return out


@pytest.mark.parametrize("lossy", [False, True])
def test_tiling_model_equals_whole_plane_lifting(lossy):
    """Every level of a 192x320 plane (tiles straddling the plane's edge at
    96x160 and below, planes smaller than a tile from 48x80 on, down to
    6x10), both ways, equals the whole-plane lifting of transform/dwt.py."""
    rng = np.random.default_rng(int(lossy))
    if lossy:
        cur = (rng.normal(0, 60, (192, 320))
               * 2.0 ** rng.integers(-4, 5, (192, 320))).astype(np.float32)
    else:
        cur = rng.integers(-40000, 40000, (192, 320)).astype(np.int32)
    for level in range(5):
        want = dwt.lift_horizontal(*dwt.lift_vertical(
            torch.from_numpy(cur), lossy), lossy)
        got = _model_forward_level(cur, lossy)
        for g, w_ in zip(got, want):
            assert np.array_equal(g, w_.numpy()), f"forward level {level}"
        back = _model_reverse_level(*got, lossy)
        want_back = dwt.unlift_vertical(*dwt.unlift_horizontal(
            *(torch.from_numpy(np.ascontiguousarray(b)) for b in got),
            lossy), lossy)
        assert np.array_equal(back, want_back.numpy()), f"reverse level {level}"
        cur = np.ascontiguousarray(got[0])


# -- a model of X2's work split (csrc/dwt_forward.cu) ------------------------

def _x2_steps(lossy, scale_odd):
    """dwt_common.cuh lift_forward_regs: (parity, f) per step."""
    al, be, ga, de, k1, k2 = _f32(spec.I97_ALPHA, spec.I97_BETA,
                                  spec.I97_GAMMA, spec.I97_DELTA, spec.I97_K1,
                                  spec.I97_K2)
    if not lossy:
        return [(1, lambda x, a, b: x - ((a + b) >> 1)),
                (0, lambda x, a, b: x + ((a + b + 2) >> 2))]
    steps = [(1, lambda x, a, b: x + (a + b) * al),
             (0, lambda x, a, b: x + (a + b) * be),
             (1, lambda x, a, b: x + (a + b) * ga),
             (0, lambda x, a, b: (x + (a + b) * de) * k2)]
    if scale_odd:
        steps.append((1, lambda x, a, b: x * k1))
    return steps


def _lift_strips(v, g0, n, steps):
    """lift_regs on register strips v (..., N) through `steps`, the strip's
    first position at plane index g0 (...): the edge rule's selects only
    in strips with g0 <= 0 or g0 + N >= n (the kernel's kEdge variant),
    the others lifted without them, as the kernels do."""
    size = v.shape[-1]
    edge = (g0 <= 0) | (g0 + size >= n)
    lo, hi = -g0, n - 1 - g0
    for par, f in steps:
        for i in range(par, size, 2):
            a = v[..., i - 1 if i > 0 else i + 1]
            b = v[..., i + 1 if i + 1 < size else i - 1]
            if par:
                b = np.where(edge & (i >= hi), a, b)
            else:
                a = np.where(edge & (i <= lo), b, a)
            v[..., i] = f(v[..., i], a, b)
    return v


def _x2_load(plane, y0, x0, halo, kbytes, vec):
    """The tile arrays A (tiles_y, tiles_x, 72, 72) of one level: the
    chunks of 16 / kbytes values at the aligned columns x0 - lead + w * q,
    the groups of 4 inside A's columns (x0 - 4 ..) stored; a vector chunk
    is in the plane whole or not at all, a scalar one a value at a time.
    Every column of A is stored by exactly one group."""
    h, w = plane.shape
    pad, side = dwt_cuda.X2_PAD, dwt_cuda.TILE + 2 * dwt_cuda.X2_PAD
    width = dwt_cuda.VECTOR_BYTES // kbytes
    lead = max(width, pad)
    padded = np.zeros((h + 2 * side, w + 4 * side), plane.dtype)
    padded[side:side + h, 2 * side:2 * side + w] = plane
    rows = np.arange(pad - halo, pad + dwt_cuda.TILE + halo)
    gy = y0[:, None] - pad + rows[None, :]                    # (ty, rows)
    row_in = (gy >= 0) & (gy < h)
    tiles = np.zeros((len(y0), len(x0), side, side), plane.dtype)
    cover = np.zeros(side, int)
    for q in range((dwt_cuda.TILE + 2 * lead) // width):
        xs = x0 - lead + width * q                            # (tx,)
        if vec:
            assert np.all((xs + width <= w) | (xs >= w))      # whole chunks
        for m in range(width // 4):
            col = pad - lead + width * q + 4 * m
            if not 0 <= col < side:
                continue
            cover[col:col + 4] += 1
            gx = xs[:, None] + 4 * m + np.arange(4)[None, :]  # (tx, 4)
            vals = padded[(gy + side)[:, :, None, None],
                          (gx + 2 * side)[None, None, :, :]]
            col_in = (((xs >= 0) & (xs < w))[:, None] & np.ones(4, bool)
                      if vec else (gx >= 0) & (gx < w))
            keep = row_in[:, :, None, None] & col_in[None, None, :, :]
            tiles[:, :, rows[0]:rows[-1] + 1, col:col + 4] = np.where(
                keep, vals, 0).transpose(0, 2, 1, 3)
    assert np.all(cover == 1)
    return tiles


def _model_x2_level(plane, lossy, kbytes, vec):
    """One level of csrc/dwt_forward.cu on a numpy plane -> (ll, hl, lh,
    hh), unquantized (HL, HH times K1 as the store does), every band
    position written exactly once."""
    h, w = plane.shape
    tile, strip = dwt_cuda.TILE, dwt_cuda.STRIP
    pad, halo = dwt_cuda.X2_PAD, dwt_cuda.HALO[lossy]
    size = strip + 2 * halo
    y0 = np.arange(0, h, tile)
    x0 = np.arange(0, w, tile)
    a = _x2_load(plane, y0, x0, halo, kbytes, vec)
    # vertical: strip s of every column pad - halo + c, c < 64 + 2 halo
    cols = np.arange(pad - halo, pad + tile + halo)
    b = np.zeros((len(y0), len(x0), tile, a.shape[-1]), plane.dtype)
    for s_ in range(tile // strip):
        g0 = y0 + strip * s_ - halo
        live = g0 + halo < h
        first = pad - halo + strip * s_
        v = a[:, :, first:first + size][..., cols].transpose(0, 1, 3, 2)
        v = _lift_strips(v.copy(), g0[:, None, None], h,
                         _x2_steps(lossy, True))
        out = v[..., halo:halo + strip].transpose(0, 1, 3, 2)
        rows_b = b[:, :, strip * s_:strip * (s_ + 1)]       # a view
        rows_b[..., cols] = np.where(live[:, None, None, None], out,
                                     rows_b[..., cols])
    # horizontal: strip k of every tile row r; low and high coefficients
    bands = np.zeros((4, h // 2, w // 2), plane.dtype)
    count = np.zeros((4, h // 2, w // 2), int)
    k1 = np.float32(spec.I97_K1)
    for k in range(tile // strip):
        g0 = x0 + strip * k - halo
        first = pad - halo + strip * k
        v = _lift_strips(b[..., first:first + size].copy(),
                         g0[None, :, None], w, _x2_steps(lossy, False))
        lo_hi = (v[..., halo:halo + strip:2], v[..., halo + 1:halo + strip:2])
        for yl in range(tile // 2):
            for dy in (0, 1):
                r = 2 * yl + dy
                y = y0 // 2 + yl
                for dx in (0, 1):
                    vals = lo_hi[dx][:, :, r]                 # (ty, tx, 8)
                    if lossy and dx:
                        vals = vals * k1
                    for c4 in range(2):
                        x = x0 // 2 + strip // 2 * k + 4 * c4
                        vec_store = (w // 2) % 4 == 0
                        for e in range(4):
                            xe = x + e
                            ok = (y[:, None] < h // 2) & (xe[None, :] < w // 2)
                            if vec_store:      # int4 stores: all 4 or none
                                assert np.all(ok == ((y[:, None] < h // 2)
                                              & (x[None, :] < w // 2)))
                            yy, xx = np.nonzero(ok)
                            band = 2 * dy + dx
                            bands[band, y[yy], xe[xx]] = vals[yy, xx,
                                                              4 * c4 + e]
                            count[band, y[yy], xe[xx]] += 1
    assert np.all(count == 1)
    return tuple(bands)


@pytest.mark.parametrize("h,w,levels,kbytes,vec", [
    (2048, 2048, 5, 1, True),           # the main path
    (1088, 1920, 5, 2, True),           # the video frame, 16-bit loads
    (512, 512, 5, 1, False),            # an offset view: scalar loads
    (128, 192, 6, 1, True),             # a 6-wide LL (scalar), 2-wide bands
])
@pytest.mark.parametrize("lossy", [False, True])
def test_x2_model_equals_whole_plane_lifting(h, w, levels, kbytes, vec,
                                             lossy):
    """Every level of X2's work split (level 0 read in chunks of 16 /
    kbytes samples, vector or scalar; deeper levels' LL planes in chunks
    of 4 values, vector where the width is a multiple of 4) equals the
    whole-plane lifting of transform/dwt.py."""
    rng = np.random.default_rng(h + levels + int(lossy))
    if lossy:
        cur = (rng.normal(0, 60, (h, w))
               * 2.0 ** rng.integers(-4, 5, (h, w))).astype(np.float32)
    else:
        cur = rng.integers(-40000, 40000, (h, w)).astype(np.int32)
    for level in range(levels):
        lw = cur.shape[1]
        got = _model_x2_level(cur, lossy, kbytes if level == 0 else 4,
                              vec if level == 0 else lw % 4 == 0)
        want = dwt.lift_horizontal(*dwt.lift_vertical(
            torch.from_numpy(cur), lossy), lossy)
        for g, w_ in zip(got, want):
            assert np.array_equal(g, w_.numpy()), f"level {level}"
        cur = np.ascontiguousarray(got[0])


# -- a model of X4's work split (csrc/dwt_reverse.cu) ------------------------

def _x4_steps(lossy, scale_odd):
    """dwt_common.cuh lift_reverse_regs: (parity, f) per step."""
    al, be, ga, de, k1, k2 = _f32(spec.I97_ALPHA, spec.I97_BETA,
                                  spec.I97_GAMMA, spec.I97_DELTA, spec.I97_K1,
                                  spec.I97_K2)
    if not lossy:
        return [(0, lambda x, a, b: x - ((a + b + 2) >> 2)),
                (1, lambda x, a, b: x + ((a + b) >> 1))]
    return ([(1, lambda x, a, b: x / k1)] if scale_odd else []) + [
        (0, lambda x, a, b: x / k2 - (a + b) * de),
        (1, lambda x, a, b: x - (a + b) * ga),
        (0, lambda x, a, b: x - (a + b) * be),
        (1, lambda x, a, b: x - (a + b) * al)]


def _x4_stage(bands, y0, x0, halo, vec, lossy):
    """X4's load into S (tiles_y, tiles_x, rows, 2, X4_STAGE_COLS): row r
    of a tile with its halo (plane row y0 - halo + r) holds band (r & 1,
    dx)'s row y0 / 2 - halo / 2 + r // 2, its columns from x0 / 2 -
    X4_LEAD in chunks of 4 words, staged from 2 before the tile's band
    columns; a vector chunk is in the band whole or not at all, a scalar
    one a word at a time; 0 outside the band; 9/7's H band divided by K1.
    Every staged column is written exactly once."""
    h2, w2 = bands[0].shape
    rows = dwt_cuda.TILE + 2 * halo
    cols, lead = dwt_cuda.X4_STAGE_COLS, dwt_cuda.X4_LEAD
    pad = 2 * dwt_cuda.TILE
    k1 = np.float32(spec.I97_K1)
    stage = np.zeros((len(y0), len(x0), rows, 2, cols), bands[0].dtype)
    count = np.zeros(stage.shape[2:], int)
    r = np.arange(rows)
    y = y0[:, None] // 2 - halo // 2 + r[None, :] // 2          # (ty, rows)
    row_in = (y >= 0) & (y < h2)
    for dx in (0, 1):
        for dy in (0, 1):
            padded = np.zeros((h2 + 2 * pad, w2 + 2 * pad), bands[0].dtype)
            padded[pad:pad + h2, pad:pad + w2] = bands[2 * dy + dx]
            if lossy and dx:
                padded = padded / k1
            mine = (r % 2) == dy
            for q in range((dwt_cuda.TILE // 2 + 2 * lead) // 4):
                xs = x0 // 2 - lead + 4 * q                       # (tx,)
                if vec:
                    assert np.all((xs + 4 <= w2) | (xs >= w2))    # whole
                for e in range(4):
                    j = 4 * q + e - (lead - 2)
                    if not 0 <= j < cols:
                        continue
                    x = xs + e
                    col_in = ((xs >= 0) & (xs < w2)) if vec else \
                        ((x >= 0) & (x < w2))
                    vals = padded[(y + pad)[:, None, :],
                                  (x + pad)[None, :, None]]   # (ty, tx, rows)
                    keep = row_in[:, None, :] & col_in[None, :, None]
                    stage[:, :, mine, dx, j] = np.where(
                        keep, vals, 0)[:, :, mine]
                    count[mine, dx, j] += 1
    assert np.all(count == 1)
    return stage


def _model_x4_level(ll, hl, lh, hh, lossy, vec):
    """One level of csrc/dwt_reverse.cu before its finish on numpy bands
    -> the plane: the staged bands, the horizontal 16-column strips of
    every tile row with its halo (interleaved in plane order, lifted with
    the edge rule), the vertical 16-row strips of every tile column, the
    copy-out in chunks of 4 values (16-byte stores where the plane's width
    is a multiple of 4, else a value at a time), every position written
    exactly once. Rows the horizontal pass skips hold NaN (9/7) or a
    sentinel (5/3), so reading one would show."""
    h, w = 2 * ll.shape[0], 2 * ll.shape[1]
    tile, strip, halo = dwt_cuda.TILE, dwt_cuda.STRIP, dwt_cuda.HALO[lossy]
    size = strip + 2 * halo
    rows = tile + 2 * halo
    y0 = np.arange(0, h, tile)
    x0 = np.arange(0, w, tile)
    stage = _x4_stage((ll, hl, lh, hh), y0, x0, halo, vec, lossy)
    junk = np.nan if lossy else 0x3fff0000
    b = np.full((len(y0), len(x0), rows, tile), junk, ll.dtype)
    # horizontal: strip s of tile row r, plane columns g0 .. g0 + size
    gy = y0[:, None] - halo + np.arange(rows)[None, :]           # (ty, rows)
    i = np.arange(size)
    for s_ in range(tile // strip):
        g0 = x0 + strip * s_ - halo                              # (tx,)
        first = strip // 2 * s_ + 2 - halo // 2
        v = stage[:, :, :, i & 1, first + (i >> 1)]      # (ty, tx, rows, N)
        v = _lift_strips(v.copy(), g0[None, :, None], w,
                         _x4_steps(lossy, False))
        live = (((gy >= 0) & (gy < h))[:, None, :]
                & (g0 + halo < w)[None, :, None])
        b[..., strip * s_:strip * (s_ + 1)] = np.where(
            live[..., None], v[..., halo:halo + strip],
            b[..., strip * s_:strip * (s_ + 1)])
    # vertical: strip s of tile column c, plane rows g0 .. g0 + size
    t = np.zeros((len(y0), len(x0), tile, tile), ll.dtype)
    for s_ in range(tile // strip):
        g0 = y0 + strip * s_ - halo                              # (ty,)
        v = b[:, :, strip * s_:strip * s_ + size].transpose(0, 1, 3, 2)
        v = _lift_strips(v.copy(), g0[:, None, None], h,
                         _x4_steps(lossy, True))
        t[:, :, strip * s_:strip * (s_ + 1)] = v[..., halo:halo + strip] \
            .transpose(0, 1, 3, 2)
    # the copy-out
    out = np.zeros((h, w), ll.dtype)
    count = np.zeros((h, w), int)
    for ty, yy in enumerate(y0):
        for tx, xx in enumerate(x0):
            for r in range(min(tile, h - yy)):
                for x in range(xx, min(xx + tile, w), 4):
                    n = 4 if w % 4 == 0 else min(4, w - x)
                    if w % 4 == 0:                  # a whole 16-byte chunk
                        assert x + 4 <= w
                    out[yy + r, x:x + n] = t[ty, tx, r, x - xx:x - xx + n]
                    count[yy + r, x:x + n] += 1
    assert np.all(count == 1)
    return out


@pytest.mark.parametrize("h,w,levels,vec", [
    (2048, 2048, 5, True),              # the main path
    (1088, 1920, 5, True),              # the video frame
    (512, 512, 5, False),               # codeblocks off 16 bytes: words
    (128, 192, 6, True),                # 3- and 6-wide bands (words)
])
@pytest.mark.parametrize("lossy", [False, True])
def test_x4_model_equals_whole_plane_lifting(h, w, levels, vec, lossy):
    """Every level of X4's work split (band rows staged from chunks of 4
    words, vector where the codeblocks' base allows and the bands are a
    multiple of 4 wide, else a word at a time) equals the whole-plane
    inverse lifting of transform/dwt.py on the forward lifting's bands."""
    rng = np.random.default_rng(h + levels + int(lossy))
    if lossy:
        cur = (rng.normal(0, 60, (h, w))
               * 2.0 ** rng.integers(-4, 5, (h, w))).astype(np.float32)
    else:
        cur = rng.integers(-40000, 40000, (h, w)).astype(np.int32)
    bands = []
    for level in range(levels):
        got = dwt.lift_horizontal(*dwt.lift_vertical(
            torch.from_numpy(cur), lossy), lossy)
        bands.append([g.numpy() for g in got])
        cur = np.ascontiguousarray(bands[-1][0])
    ll = bands[-1][0]
    for level in range(levels - 1, -1, -1):
        _, hl, lh, hh = bands[level]
        w2 = ll.shape[1]
        got = _model_x4_level(ll, hl, lh, hh, lossy, vec and w2 % 4 == 0)
        want = dwt.unlift_vertical(*dwt.unlift_horizontal(
            *(torch.from_numpy(np.ascontiguousarray(b))
              for b in (ll, hl, lh, hh)), lossy), lossy).numpy()
        assert np.array_equal(got, want), f"level {level}"
        ll = got
